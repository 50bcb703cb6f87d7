// Eq.-8 masked stale-gradient aggregation, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/stale_aggregate.py::
// stale_aggregate_flat (Pallas body _agg_kernel):
//
//   out[n] = p[n] - (beta / max(sum_c mask[c], 1)) * sum_{c=0..C-1} mask[c] * buf[c, n]
//
// f32 in, f32 accumulation summed in c-order 0..C-1, f32 out.
//
// What bounds it: bytes.  Per element it reads C+1 floats and writes one and
// does 2*C flops: 0.5 flop/byte, two orders of magnitude under the H100's
// ridge.  The least time is (C+2)*N*4 bytes over 3.35 TB/s; for mnist_dnn
// (N = 79,510) that is 2.23 MB / 0.66 us at C = 5 and 41.3 MB / 12.3 us at
// C = 128.  At these sizes the launch itself (a few us) dominates.
//
// Design:
// * One thread per V consecutive elements (V = 4, 2 or 1: the widest that
//   divides N, so every row of buf stays aligned for V-wide loads and no
//   element is left for a tail; mnist_dnn's N = 79,510 takes V = 2).  Each
//   buffer row is read exactly once, coalesced, and the output written once.
//   No padding copy.
// * C is a runtime loop bound: the server closes rounds of any size and the
//   engine pads lane counts to powers of two up to 256, so nothing is
//   unrolled to a compile-time C.
// * No host sync: every warp reduces the [C] mask itself (lane-strided
//   partial sums, then a fixed xor-shuffle tree, so every warp gets the same
//   bits), so the wrapper never reads A back and the launch stays
//   asynchronous.  The mask is tiny and warp-uniform; it is served from L1.
// * The C entry point validates its arguments and returns cudaGetLastError()
//   so the Python wrapper can raise on a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <int V>
__device__ __forceinline__ void load_vec(const float* ptr, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(ptr));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(ptr));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(ptr);
  }
}

template <int V>
__device__ __forceinline__ void store_vec(float* ptr, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(ptr) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (V == 2) {
    *reinterpret_cast<float2*>(ptr) = make_float2(v[0], v[1]);
  } else {
    *ptr = v[0];
  }
}

// Sum of mask[0..C-1], identical in every lane of the calling warp.  All 32
// lanes must call it.
__device__ __forceinline__ float warp_mask_sum(const float* __restrict__ mask,
                                               int C) {
  const int lane = threadIdx.x & 31;
  float s = 0.0f;
  for (int c = lane; c < C; c += 32) s += __ldg(mask + c);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

template <int V>
__global__ void __launch_bounds__(kThreads)
stale_aggregate_kernel(const float* __restrict__ p,
                       const float* __restrict__ buf,
                       const float* __restrict__ mask,
                       float* __restrict__ out, int64_t n, int C, float beta) {
  const float scale = beta / fmaxf(warp_mask_sum(mask, C), 1.0f);
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * V;
  if (i >= n) return;

  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.0f;

  const float* row = buf + i;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const float m = __ldg(mask + c);
    float b[V];
    load_vec<V>(row + static_cast<int64_t>(c) * n, b);
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = fmaf(m, b[v], acc[v]);
  }

  float o[V];
  load_vec<V>(p + i, o);
#pragma unroll
  for (int v = 0; v < V; ++v) o[v] = o[v] - scale * acc[v];
  store_vec<V>(out + i, o);
}

}  // namespace

// p [n], buf [C, n], mask [C], out [n]: contiguous f32 on the current device.
// vec is 1, 2 or 4 and must divide n; every pointer must be 4*vec-byte
// aligned.  Launches on `stream` and returns cudaGetLastError().
extern "C" int stale_aggregate_f32(const float* p, const float* buf,
                                   const float* mask, float* out, int64_t n,
                                   int C, float beta, int vec, void* stream) {
  const uintptr_t align = static_cast<uintptr_t>(4 * vec);
  if (n <= 0 || C < 0 || (vec != 1 && vec != 2 && vec != 4) || n % vec != 0 ||
      (reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(buf) |
       reinterpret_cast<uintptr_t>(out)) % align != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t groups = n / vec;
  const unsigned blocks =
      static_cast<unsigned>((groups + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 4:
      stale_aggregate_kernel<4><<<blocks, kThreads, 0, s>>>(p, buf, mask, out,
                                                            n, C, beta);
      break;
    case 2:
      stale_aggregate_kernel<2><<<blocks, kThreads, 0, s>>>(p, buf, mask, out,
                                                            n, C, beta);
      break;
    default:
      stale_aggregate_kernel<1><<<blocks, kThreads, 0, s>>>(p, buf, mask, out,
                                                            n, C, beta);
  }
  return static_cast<int>(cudaGetLastError());
}
