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
// C = 128.  Up to C ~ 16 at that N the launch itself (~3 us) dominates.
//
// Design:
// * Columns in V-wide groups (V = 4, 2 or 1: the widest that divides N, so
//   every row of buf stays aligned for V-wide loads and no column is left
//   for a tail; mnist_dnn's N = 79,510 takes V = 2, because its odd rows
//   start on 8-byte boundaries only; an odd N takes V = 1).  Each buffer
//   row is read exactly once, coalesced, and the output written once.  No
//   padding copy.
// * Even waves.  The grid is sized from the card's SM count (queried once
//   per device and cached here): kCtasPerSm = 2 CTAs an SM, each of
//   `threads` threads, each thread `per` column groups, where `per` is the
//   least that keeps a CTA at <= 512 threads (256 at V = 2 and 4, whose
//   wider rows in flight need up to 128 registers) and `threads` the least
//   that then covers N (one warp at least).  Every CTA gets the same number
//   of groups, so every SM carries the same load, and the small cases cover
//   N in one pass: at N = 79,510, 264 CTAs of 151 threads, one group each
//   (the first design: 156 CTAs of 256 threads on 132 SMs, 24 SMs doing
//   twice the others' work); at N = 1,000,003, 264 CTAs of 474 threads, 8
//   groups each, two at a time.  A thread's groups are a grid's width
//   apart, so all CTAs sweep one window of columns together (DRAM page
//   locality: CTA-contiguous slices ran measurably slower at N = 1,000,003).
// * Bytes in flight.  A thread issues the loads of R rows (R = 16 at V = 1
//   and 2, 8 at V = 4; at V = 1 for two groups at once) before it adds
//   any, then adds them into its accumulators in c order, so the sum is
//   the same c-ordered FMA chain as the plain version's loop.  At V = 2
//   that is ~39 KB in flight an SM (the first design, 4 rows unrolled,
//   ~10 KB).  The last C % R rows go in batches of 8 (4 at V = 1): short
//   code, since C = 1 to 8 are launch-bound at ~3 us and a predicated
//   16-row batch made them measurably slower.  C is never split across
//   CTAs: that would change the summation order, and a second pass would
//   cost a launch.
// * No host sync: warp 0 of each CTA reduces the [C] mask (lane-strided
//   partial sums whose loads go out with the rows', then a fixed
//   xor-shuffle tree, so every CTA gets the same bits) into shared memory;
//   the CTA meets at one barrier after its first groups.
// * C is a runtime loop bound: the server closes rounds of any size and the
//   engine pads lane counts to powers of two up to 256.  C = 0 gives p.
// * What still bounds it: at C = 128 and N = 79,510 the 41 MB working set
//   fits in the 50 MB L2, so back to back it runs under the HBM bound;
//   with L2 flushed it is DRAM throughput (PERF.md has both).  At
//   mamba2-370m's N = 419,825,152, C = 4 it streams at ~3.05 TB/s on an
//   H100 at 700 W, ~3% under the first design: at V = 4 its 124 registers
//   leave 512 threads an SM, one group's rows in flight each.
// * In place (a donated step: out == p).  The instance above declares p
//   and out __restrict__, a promise that passing one pointer twice would
//   break (the compiler may then move p's loads past out's stores).  So
//   the C entry point launches a second instance when out == p, kInPlace,
//   whose p and out carry no __restrict__ and whose p is read by a plain
//   load rather than through the read-only (non-coherent) path.  Each
//   element is still read, then written, by one thread, in the same order,
//   so the two instances give the same bits; the out-of-place instance's
//   machine code is the one it was (its qualifiers come from Ptrs<false>).
// * The C entry point validates its arguments, launches on the caller's
//   stream, allocates nothing and returns cudaGetLastError() so the Python
//   wrapper can raise on a refused launch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCtasPerSm = 2;
constexpr int kMaxDevices = 64;

// Threads a CTA at most: 512 at V = 1 (64 registers a thread for two CTAs an
// SM), 256 at V = 2 and 4, whose wider rows in flight need more registers.
__host__ __device__ constexpr int max_threads(int V) {
  return V == 1 ? 512 : 256;
}

// V floats from ptr: through the read-only path, or (kCoherent: an array
// the kernel also writes) by a plain load
template <int V, bool kCoherent = false>
__device__ __forceinline__ void load_vec(const float* ptr, float (&v)[V]) {
  if constexpr (V == 4) {
    float4 t;
    if constexpr (kCoherent) t = *reinterpret_cast<const float4*>(ptr);
    else t = __ldg(reinterpret_cast<const float4*>(ptr));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (V == 2) {
    float2 t;
    if constexpr (kCoherent) t = *reinterpret_cast<const float2*>(ptr);
    else t = __ldg(reinterpret_cast<const float2*>(ptr));
    v[0] = t.x; v[1] = t.y;
  } else {
    if constexpr (kCoherent) v[0] = *ptr;
    else v[0] = __ldg(ptr);
  }
}

// p's and out's pointer types: __restrict__ out of place; plain in place,
// where they are one pointer
template <bool kInPlace> struct Ptrs {
  using In = const float* __restrict__;
  using Out = float* __restrict__;
};
template <> struct Ptrs<true> {
  using In = const float*;
  using Out = float*;
};

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

template <int V, int U, bool kInPlace>
__global__ void __launch_bounds__(max_threads(V), kCtasPerSm)
stale_aggregate_kernel(typename Ptrs<kInPlace>::In p,
                       const float* __restrict__ buf,
                       const float* __restrict__ mask,
                       typename Ptrs<kInPlace>::Out out, int64_t n, int C,
                       float beta, int64_t per) {
  constexpr int R = V == 4 ? 8 : 16;    // rows loaded before any FMA
  constexpr int kTail = V == 1 ? 4 : 8;  // rows a batch of the tail
  __shared__ float s_scale;
  const int tid = threadIdx.x;
  float msum = 0.0f;                    // warp 0: lane-strided mask sums,
  if (tid < 32)                         // loads issued with the rows'
    for (int c = tid; c < C; c += 32) msum += __ldg(mask + c);

  const int64_t groups = n / V;
  // group k of a thread: the grid sweeps one window of columns at a time
  // (all CTAs in step, for DRAM page locality), `per` windows in all
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + tid;
  const int64_t window = static_cast<int64_t>(blockDim.x) * gridDim.x;
  float scale = 0.0f;
  for (int64_t k = 0; k < per; k += U) {  // per is the same in every thread
    int64_t col[U];                     // U groups at once, a window apart
    bool live[U];
    float acc[U][V], o[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t g = first + (k + u) * window;
      live[u] = k + u < per && g < groups;
      col[u] = g * V;
#pragma unroll
      for (int v = 0; v < V; ++v) acc[u][v] = 0.0f;
      if (live[u]) load_vec<V, kInPlace>(p + col[u], o[u]);
    }
    int c0 = 0;
    for (; c0 + R <= C; c0 += R) {      // whole batches of R rows
      float b[R][U][V], m[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        m[r] = __ldg(mask + c0 + r);
        const float* row = buf + static_cast<int64_t>(c0 + r) * n;
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (live[u]) load_vec<V>(row + col[u], b[r][u]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[u][v] = fmaf(m[r], b[r][u][v], acc[u][v]);
    }
    for (; c0 < C; c0 += kTail) {       // the last C % R rows, kTail at
      float b[kTail][U][V], m[kTail];   // a time (short code for small C)
#pragma unroll
      for (int r = 0; r < kTail; ++r)
        if (c0 + r < C) {
          m[r] = __ldg(mask + c0 + r);
          const float* row = buf + static_cast<int64_t>(c0 + r) * n;
#pragma unroll
          for (int u = 0; u < U; ++u)
            if (live[u]) load_vec<V>(row + col[u], b[r][u]);
        }
#pragma unroll
      for (int r = 0; r < kTail; ++r)
        if (c0 + r < C) {
#pragma unroll
          for (int u = 0; u < U; ++u)
#pragma unroll
            for (int v = 0; v < V; ++v)
              acc[u][v] = fmaf(m[r], b[r][u][v], acc[u][v]);
        }
    }
    if (k == 0) {                       // the mask sum, once, after the
      if (tid < 32) {                   // first groups' loads
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          msum += __shfl_xor_sync(0xffffffffu, msum, off);
        if (tid == 0) s_scale = beta / fmaxf(msum, 1.0f);
      }
      __syncthreads();
      scale = s_scale;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (live[u]) {
#pragma unroll
        for (int v = 0; v < V; ++v) o[u][v] = o[u][v] - scale * acc[u][v];
        store_vec<V>(out + col[u], o[u]);
      }
  }
}

int sm_count(int* sms) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 0 && dev < kMaxDevices && cached[dev] > 0) {
    *sms = cached[dev];
    return 0;
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 0 && dev < kMaxDevices) cached[dev] = *sms;
  return 0;
}

struct Plan {
  int64_t ctas, threads, per;
};

// Equal slices of `groups` column groups over kCtasPerSm CTAs an SM; at
// least one whole warp a CTA (warp 0 sums the mask with full-warp shuffles)
Plan make_plan(int64_t groups, int vec, int sms) {
  const int64_t slots = static_cast<int64_t>(sms) * kCtasPerSm;
  const int64_t cap = max_threads(vec);
  Plan pl;
  pl.per = (groups + slots * cap - 1) / (slots * cap);
  pl.threads = (groups + slots * pl.per - 1) / (slots * pl.per);
  if (pl.threads < 32) pl.threads = 32;
  pl.ctas = (groups + pl.threads * pl.per - 1) / (pl.threads * pl.per);
  return pl;
}

}  // namespace

// The launch shape for N columns at vector width vec on the current device:
// out[0] CTAs, out[1] threads a CTA, out[2] column groups a thread.
// Returns 0 or a CUDA error code.
extern "C" int stale_aggregate_plan(int64_t n, int vec, int64_t* out) {
  if (n <= 0 || (vec != 1 && vec != 2 && vec != 4) || n % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  const Plan pl = make_plan(n / vec, vec, sms);
  out[0] = pl.ctas;
  out[1] = pl.threads;
  out[2] = pl.per;
  return 0;
}

namespace {

template <bool kInPlace>
void launch(const float* p, const float* buf, const float* mask, float* out,
            int64_t n, int C, float beta, int vec, const Plan& pl,
            cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>(pl.ctas));
  const dim3 block(static_cast<unsigned>(pl.threads));
  switch (vec) {
    case 4:
      stale_aggregate_kernel<4, 1, kInPlace><<<grid, block, 0, s>>>(
          p, buf, mask, out, n, C, beta, pl.per);
      break;
    case 2:
      stale_aggregate_kernel<2, 1, kInPlace><<<grid, block, 0, s>>>(
          p, buf, mask, out, n, C, beta, pl.per);
      break;
    default:
      stale_aggregate_kernel<1, 2, kInPlace><<<grid, block, 0, s>>>(
          p, buf, mask, out, n, C, beta, pl.per);
  }
}

}  // namespace

// p [n], buf [C, n], mask [C], out [n]: contiguous f32 on the current device.
// out is either p itself (in place: the kInPlace instance) or overlaps none
// of p, buf and mask.  vec is 1, 2 or 4 and must divide n; every pointer
// must be 4*vec-byte aligned.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int stale_aggregate_f32(const float* p, const float* buf,
                                   const float* mask, float* out, int64_t n,
                                   int C, float beta, int vec, void* stream) {
  const uintptr_t align = static_cast<uintptr_t>(4 * vec);
  if (n <= 0 || C < 0 || (vec != 1 && vec != 2 && vec != 4) || n % vec != 0 ||
      (reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(buf) |
       reinterpret_cast<uintptr_t>(out)) % align != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const int err = sm_count(&sms);
  if (err != 0) return err;
  const Plan pl = make_plan(n / vec, vec, sms);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out == p)
    launch<true>(p, buf, mask, out, n, C, beta, vec, pl, s);
  else
    launch<false>(p, buf, mask, out, n, C, beta, vec, pl, s);
  return static_cast<int>(cudaGetLastError());
}
