// Single-token decode attention, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention_bhsd (Pallas body _decode_kernel): one query token per
// (batch, query head) against a ring-buffer KV cache,
//
//   o[b, h, :] = sum_s softmax_s(valid(s) ? scale * q.k[b, h/group, s] : -1e30) v[b, h/group, s, :]
//
// valid(s) = pos[b, s] >= 0 && pos[b, s] <= q_pos[b]
//            && (!window || q_pos[b] - pos[b, s] < window),
// p = 0 where invalid, f32 statistics, o = acc / max(l, 1e-30) in q's dtype.
//
// What bounds it: bytes.  Every cache byte is used once per query head of
// its group for 2 flops: at yi-6b (group 8, bf16) 8 flop/byte, far under
// the H100's ridge.  The least time is the valid slots' k and v
// (2*B*Hkv*S_valid*D*size bytes) plus q, o and pos over 3.35 TB/s: 10.0 us
// for a full cache at B = 4, Hkv = 4, S = 4096, D = 128 in bf16.
//
// Design (simple first version):
// * One CTA per (kv head, batch) holding up to 8 query heads of that kv
//   head's group (yi-6b's whole group), so each cache byte is read from
//   device memory once, not once per query head.  A group above 8 takes
//   more CTAs along x.
// * S is split across the 8 warps in blocks of 32 keys.  For q.k a lane
//   owns one key and walks its row in 16-byte loads against q in shared
//   memory (broadcast reads), so no cross-lane reduction per key; each
//   warp keeps its own online softmax per head (xor-shuffle max and sum,
//   identical in every lane); for p.v a lane owns D/32 columns of the
//   accumulator and reads V rows coalesced, with p from shared memory.
// * The 8 warps' (m, l, acc) are combined through shared memory in warp
//   order 0..7, so the result does not depend on scheduling.
// * Only the slots the mask keeps are read from k and v (a half-full ring
//   costs half the bytes); pos is read whole.
// * k, v and pos are read through strides, so the model's cache layout
//   [B, S, Hkv, D] is read in place, without a transposed copy.
// * Known gap: at B = 4, Hkv = 4 the grid has 16 CTAs for 132 SMs.
//   Splitting S across CTAs (flash-decoding) is later work.
// * The C entry point checks its arguments and returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kHeads = 8;           // query heads per CTA
constexpr float kNegInf = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  const int* q_pos;
  void* o;
  int S, group;
  long long q_sb, q_sh;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long pos_sb, pos_ss;
  long long o_sb, o_sh;
  int window;
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_float(float& dst, float x) { dst = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16& dst, float x) {
  dst = __float2bfloat16_rn(x);
}

// N consecutive elements at ptr (aligned to N * sizeof(T) bytes) as floats.
template <typename T, int N>
__device__ __forceinline__ void load_floats(const T* ptr, float (&out)[N]) {
  constexpr int kBytes = N * static_cast<int>(sizeof(T));
  if constexpr (kBytes == 16 || kBytes == 8 || kBytes == 4) {
    using Raw = typename std::conditional<
        kBytes == 16, uint4,
        typename std::conditional<kBytes == 8, uint2, uint32_t>::type>::type;
    const Raw raw = *reinterpret_cast<const Raw*>(ptr);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_float(ptr[i]);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(Params p) {
  constexpr int kVec = 16 / sizeof(T);        // elements per 16-byte load
  constexpr int kCols = D >= 32 ? D / 32 : 1; // accumulator columns a lane owns
  __shared__ __align__(16) float qs[kHeads][D];
  __shared__ float ps[kWarps][kHeads][32];
  __shared__ float red_m[kWarps][kHeads];
  __shared__ float red_l[kWarps][kHeads];
  __shared__ float red_acc[kWarps][kHeads][D];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunks = (p.group + kHeads - 1) / kHeads;
  const int hk = blockIdx.x / chunks;
  const int h0 = hk * p.group + (blockIdx.x % chunks) * kHeads;
  const int nh = min(kHeads, hk * p.group + p.group - h0);
  const int b = blockIdx.y;
  const int qpos = p.q_pos[b];

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  const int* pos = p.pos + b * p.pos_sb;

  for (int i = threadIdx.x; i < kHeads * D; i += kThreads) {
    const int hh = i / D, d = i % D;
    qs[hh][d] = hh < nh ? to_float(q[(h0 + hh) * p.q_sh + d]) : 0.f;
  }
  __syncthreads();

  float m[kHeads], l[kHeads], acc[kHeads][kCols];
#pragma unroll
  for (int hh = 0; hh < kHeads; ++hh) {
    m[hh] = kNegInf;
    l[hh] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[hh][c] = 0.f;
  }
  const bool owns_cols = lane * kCols < D;

  for (int s0 = warp * 32; s0 < p.S; s0 += kWarps * 32) {
    // scores: lane owns key s0 + lane
    const int s = s0 + lane;
    float sc[kHeads];
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) sc[hh] = 0.f;
    bool ok = false;
    if (s < p.S) {
      const int kp = pos[s * p.pos_ss];
      ok = kp >= 0 && kp <= qpos && (p.window <= 0 || qpos - kp < p.window);
    }
    const unsigned valid = __ballot_sync(0xffffffffu, ok);
    if (ok) {                       // masked slots are never read
      const T* krow = k + s * p.k_ss;
#pragma unroll 4
      for (int d = 0; d < D; d += kVec) {
        float kv[kVec];
        load_floats<T, kVec>(krow + d, kv);
#pragma unroll
        for (int hh = 0; hh < kHeads; ++hh) {
#pragma unroll
          for (int e = 0; e < kVec; ++e)
            sc[hh] = fmaf(qs[hh][d + e], kv[e], sc[hh]);
        }
      }
    }
    float alpha[kHeads];
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      sc[hh] = ok ? sc[hh] * p.scale : kNegInf;
      const float m_new = fmaxf(m[hh], warp_max(sc[hh]));
      const float pk = ok ? expf(sc[hh] - m_new) : 0.f;
      alpha[hh] = expf(m[hh] - m_new);
      l[hh] = alpha[hh] * l[hh] + warp_sum(pk);
      m[hh] = m_new;
      ps[warp][hh][lane] = pk;
    }
    __syncwarp();

    // p.v: lane owns columns lane*kCols .. + kCols - 1
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[hh][c] *= alpha[hh];
    }
    const int nk = min(32, p.S - s0);
    if (owns_cols) {
      for (int j = 0; j < nk; ++j) {
        if (!((valid >> j) & 1u)) continue;   // p = 0 for every head
        float vv[kCols];
        load_floats<T, kCols>(v + (s0 + j) * p.v_ss + lane * kCols, vv);
#pragma unroll
        for (int hh = 0; hh < kHeads; ++hh) {
          const float pj = ps[warp][hh][j];
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            acc[hh][c] = fmaf(pj, vv[c], acc[hh][c]);
        }
      }
    }
    __syncwarp();                   // ps is rewritten by the next block
  }

  // combine the warps in a fixed order
  if (lane == 0) {
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
      red_m[warp][hh] = m[hh];
      red_l[warp][hh] = l[hh];
    }
  }
  if (owns_cols) {
#pragma unroll
    for (int hh = 0; hh < kHeads; ++hh) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) red_acc[warp][hh][lane * kCols + c] =
          acc[hh][c];
    }
  }
  __syncthreads();
  T* o = static_cast<T*>(p.o) + b * p.o_sb;
  for (int i = threadIdx.x; i < nh * D; i += kThreads) {
    const int hh = i / D, d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, red_m[w][hh]);
    float lsum = 0.f, out = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(red_m[w][hh] - mx);
      lsum += red_l[w][hh] * f;
      out += red_acc[w][hh][d] * f;
    }
    from_float(o[(h0 + hh) * p.o_sh + d], out / fmaxf(lsum, 1e-30f));
  }
}

template <int D>
cudaError_t dispatch(int is_bf16, dim3 grid, const Params& p,
                     cudaStream_t stream) {
  if (is_bf16)
    decode_kernel<__nv_bfloat16, D><<<grid, kThreads, 0, stream>>>(p);
  else
    decode_kernel<float, D><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q [B, Hq, D], k/v [B, Hkv, S, D] and o [B, Hq, D] through element
// strides (the head dim contiguous); pos [B, S] and q_pos [B] int32.
// dtype: 0 float32, 1 bfloat16 (q, k, v and o).  Returns a cudaError_t.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const int* pos,
    const int* q_pos, void* o, int is_bf16, int B, int Hq, int Hkv, int S,
    int D, long long q_sb, long long q_sh, long long k_sb, long long k_sh,
    long long k_ss, long long v_sb, long long v_sh, long long v_ss,
    long long pos_sb, long long pos_ss, long long o_sb, long long o_sh,
    int window, float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || S <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v; p.pos = pos; p.q_pos = q_pos; p.o = o;
  p.S = S;
  p.group = Hq / Hkv;
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.pos_sb = pos_sb; p.pos_ss = pos_ss;
  p.o_sb = o_sb; p.o_sh = o_sh;
  p.window = window;
  p.scale = scale;
  const int chunks = (p.group + kHeads - 1) / kHeads;
  const dim3 grid(Hkv * chunks, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (D) {
    case 16: err = dispatch<16>(is_bf16, grid, p, s); break;
    case 32: err = dispatch<32>(is_bf16, grid, p, s); break;
    case 64: err = dispatch<64>(is_bf16, grid, p, s); break;
    case 128: err = dispatch<128>(is_bf16, grid, p, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}
