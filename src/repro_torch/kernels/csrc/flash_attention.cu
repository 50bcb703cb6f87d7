// Flash attention forward, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention_bhld (Pallas body _flash_kernel):
//
//   o[b, h, q, :] = sum_k softmax_k(mask(q, k) ? scale * q.k : -1e30) v[b, h/group, k, :]
//
// with mask(q, k) = (k < L) && (!causal || k <= q) && (!window || q - k < window),
// p = 0 where the mask is false, f32 running max / sum / accumulator, and
// o = acc / max(l, 1e-30) written once in q's dtype.  GQA: query head h
// reads kv head h / group.
//
// What bounds it: operations.  At the scoring shape (B = 2, Hq = 32,
// Hkv = 4, L = 4096, D = 128, causal) it does 4*B*Hq*D*L(L+1)/2 = 2.75e11
// flops on 0.15 GB of q, k, v and o: ~1,800 flop/byte, above the H100's
// ridge (~295 flop/byte in bf16), so the least time is the flops over the
// 989 TFLOP/s bf16 tensor-core peak, 0.28 ms.
//
// Design (a simple, right first version; wgmma, TMA and warp
// specialisation are later work):
// * One CTA per (q tile of 64 rows, query head, batch).  A loop inside the
//   CTA walks the K/V tiles of 64 rows, staged through shared memory, in
//   place of the TPU grid's sequential k axis.  Tiles that the causal mask
//   or the window empties for every row of the q tile are skipped.
// * bf16: 4 warps, 16 q rows each.  Q's fragments stay in registers;
//   S = Q K^T and O += P V run on the tensor cores with mma.sync
//   m16n8k16 (bf16 in, f32 accumulate), V's fragments come through
//   ldmatrix.trans.  P is rounded to bf16 for the second product, as
//   flash attention does on GPUs; the softmax statistics stay in f32.
// * f32: 8 warps, 4 threads per q row, FMAs on the CUDA cores, so the f32
//   path matches a float32 reference to float32 rounding.
// * Inputs are read through (batch, head, row) strides with the head dim
//   contiguous, so the model's [B, L, H, D] layout needs no transposed
//   copy, and L is masked in the kernel (rows >= L are zero-filled in
//   shared memory, never stored), so no padding copy is made.
// * The C entry point checks its arguments and returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr float kNegInf = -1e30f;

struct Strides {
  long long b, h, l;   // in elements; the head dim is contiguous
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int L, group;
  Strides sq, sk, sv, so;
  int causal, window;
  float scale;
};

__device__ __forceinline__ bool allowed(const Params& p, int q, int k) {
  bool ok = k < p.L;
  if (p.causal) ok = ok && (k <= q);
  if (p.window > 0) ok = ok && (q - k < p.window);
  return ok;
}

// K tiles [begin, end) that hold a key some row of the q tile may see.
__device__ __forceinline__ void k_tiles(const Params& p, int q0, int& begin,
                                        int& end) {
  const int q_last = min(q0 + kBlockQ, p.L) - 1;
  const int k_hi = p.causal ? q_last : p.L - 1;
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  begin = k_lo / kBlockK;
  end = k_hi / kBlockK + 1;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 64 rows of D elements from global (row stride `stride`) into shared
// memory rows of `lds` elements, 16 bytes per thread and step; rows >= L
// are zero-filled.
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, int lds, const T* src,
                                          long long stride, int r0, int L) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < 64 * kPerRow; i += blockDim.x) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < L)
      val = *reinterpret_cast<const uint4*>(src + (r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * lds + c) = val;
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA-core FMAs
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;   // 4 threads per q row

template <int D>
constexpr int f32_smem_bytes() {
  return (3 * 64 * (D + 4) + 64 * (kBlockK + 4)) * 4;
}

template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_f32_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LDS = D + 4;          // padded rows: conflict-free float4
  constexpr int LDP = kBlockK + 4;
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* Ks = Qs + kBlockQ * LDS;
  float* Vs = Ks + kBlockK * LDS;
  float* Ps = Vs + kBlockK * LDS;

  const int tid = threadIdx.x;
  const int row = tid >> 2;           // q row of the tile
  const int sub = tid & 3;            // keys sub + 4j; columns sub*4 + 16i
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;
  const int qi = q0 + row;

  const float* q = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
  const float* k = static_cast<const float*>(p.k) + b * p.sk.b + hk * p.sk.h;
  const float* v = static_cast<const float*>(p.v) + b * p.sv.b + hk * p.sv.h;

  load_rows<float, D>(Qs, LDS, q, p.sq.l, q0, p.L);

  float4 acc[D / 16];
#pragma unroll
  for (int i = 0; i < D / 16; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = kNegInf, l = 0.f;

  int kt0, kt1;
  k_tiles(p, q0, kt0, kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();                  // the previous tile is consumed
    load_rows<float, D>(Ks, LDS, k, p.sk.l, k0, p.L);
    load_rows<float, D>(Vs, LDS, v, p.sv.l, k0, p.L);
    __syncthreads();

    float s[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(Qs + row * LDS + d);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float4 kv =
            *reinterpret_cast<const float4*>(Ks + (sub + 4 * j) * LDS + d);
        s[j] = fmaf(qv.x, kv.x, s[j]);
        s[j] = fmaf(qv.y, kv.y, s[j]);
        s[j] = fmaf(qv.z, kv.z, s[j]);
        s[j] = fmaf(qv.w, kv.w, s[j]);
      }
    }

    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s[j] = allowed(p, qi, k0 + sub + 4 * j) ? s[j] * p.scale : kNegInf;
      mx = fmaxf(mx, s[j]);
    }
    const float m_new = fmaxf(m, quad_max(mx));
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float pj =
          allowed(p, qi, k0 + sub + 4 * j) ? expf(s[j] - m_new) : 0.f;
      rs += pj;
      Ps[row * LDP + sub + 4 * j] = pj;
    }
    const float alpha = expf(m - m_new);
    l = alpha * l + quad_sum(rs);
    m = m_new;
    __syncwarp();                     // the row's quad sits in one warp

#pragma unroll
    for (int i = 0; i < D / 16; ++i) {
      acc[i].x *= alpha; acc[i].y *= alpha;
      acc[i].z *= alpha; acc[i].w *= alpha;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBlockK; ++kk) {
      const float pk = Ps[row * LDP + kk];
#pragma unroll
      for (int i = 0; i < D / 16; ++i) {
        const float4 vv =
            *reinterpret_cast<const float4*>(Vs + kk * LDS + sub * 4 + 16 * i);
        acc[i].x = fmaf(pk, vv.x, acc[i].x);
        acc[i].y = fmaf(pk, vv.y, acc[i].y);
        acc[i].z = fmaf(pk, vv.z, acc[i].z);
        acc[i].w = fmaf(pk, vv.w, acc[i].w);
      }
    }
  }

  if (qi < p.L) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    float* o = static_cast<float*>(p.o) + b * p.so.b + h * p.so.h +
               qi * p.so.l;
#pragma unroll
    for (int i = 0; i < D / 16; ++i) {
      const float4 r = make_float4(acc[i].x * inv, acc[i].y * inv,
                                   acc[i].z * inv, acc[i].w * inv);
      *reinterpret_cast<float4*>(o + sub * 4 + 16 * i) = r;
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores through mma.sync m16n8k16
// ---------------------------------------------------------------------------

constexpr int kBf16Threads = 128;  // 4 warps x 16 q rows

template <int D>
constexpr int bf16_smem_bytes() {
  return 3 * 64 * (D + 8) * 2;
}

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* ptr) {
  const uint32_t addr =
      static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

template <int D>
__global__ void __launch_bounds__(kBf16Threads)
flash_bf16_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LDS = D + 8;          // padded rows: conflict-free fragments
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBlockQ * LDS;
  __nv_bfloat16* Vs = Ks + kBlockK * LDS;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;            // fragment row (and B column)
  const int t = lane & 3;             // fragment column pair
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / p.group;
  const int qr[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  const __nv_bfloat16* q =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.sq.b + h * p.sq.h;
  const __nv_bfloat16* k =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.sk.b + hk * p.sk.h;
  const __nv_bfloat16* v =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.sv.b + hk * p.sv.h;

  load_rows<__nv_bfloat16, D>(Qs, LDS, q, p.sq.l, q0, p.L);
  __syncthreads();

  // this warp's 16 q rows as A fragments, one per 16 columns of D
  uint32_t qf[D / 16][4];
  const __nv_bfloat16* qw = Qs + warp * 16 * LDS;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    qf[kc][0] = ld_u32(qw + g * LDS + kc * 16 + t * 2);
    qf[kc][1] = ld_u32(qw + (g + 8) * LDS + kc * 16 + t * 2);
    qf[kc][2] = ld_u32(qw + g * LDS + kc * 16 + 8 + t * 2);
    qf[kc][3] = ld_u32(qw + (g + 8) * LDS + kc * 16 + 8 + t * 2);
  }

  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  int kt0, kt1;
  k_tiles(p, q0, kt0, kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();                  // the previous tile is consumed
    load_rows<__nv_bfloat16, D>(Ks, LDS, k, p.sk.l, k0, p.L);
    load_rows<__nv_bfloat16, D>(Vs, LDS, v, p.sv.l, k0, p.L);
    __syncthreads();

    // S = Q K^T: 8 tiles of 8 keys; element e of tile n is row
    // g + 8*(e/2), key k0 + 8n + 2t + e%2
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* kr = Ks + (n * 8 + g) * LDS + t * 2;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        mma_bf16(s[n], qf[kc], ld_u32(kr + kc * 16), ld_u32(kr + kc * 16 + 8));
    }

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = k0 + n * 8 + t * 2 + (e & 1);
        s[n][e] = allowed(p, qr[r], key) ? s[n][e] * p.scale : kNegInf;
        mx[r] = fmaxf(mx[r], s[n][e]);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f}, m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = expf(m[r] - m_new[r]);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int key = k0 + n * 8 + t * 2 + (e & 1);
        s[n][e] = allowed(p, qr[r], key) ? expf(s[n][e] - m_new[r]) : 0.f;
        rs[r] += s[n][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = alpha[r] * l[r] + quad_sum(rs[r]);
      m[r] = m_new[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
      o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
    }

    // O += P V, 16 keys at a time: P's accumulator layout is the A
    // fragment layout, V's B fragments come through ldmatrix.trans
    const int vrow = ((lane >> 3) & 1) * 8 + (lane & 7);
    const int vcol = (lane >> 4) * 8;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t a[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                             pack_bf16(s[2 * j][2], s[2 * j][3]),
                             pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                             pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, Vs + (16 * j + vrow) * LDS + dn * 16 + vcol);
        mma_bf16(o[2 * dn], a, vb[0], vb[1]);
        mma_bf16(o[2 * dn + 1], a, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qr[r] >= p.L) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(p.o) + b * p.so.b +
                          h * p.so.h + qr[r] * p.so.l;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + t * 2) =
          pack_bf16(o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    }
  }
}

template <typename Kernel>
cudaError_t launch(Kernel kernel, int smem, dim3 grid, int threads,
                   const Params& p, cudaStream_t stream) {
  // above 48 KB only after opting in; cheap, and per-device state
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t dispatch(int is_bf16, dim3 grid, const Params& p,
                     cudaStream_t stream) {
  if (is_bf16)
    return launch(flash_bf16_kernel<D>, bf16_smem_bytes<D>(), grid,
                  kBf16Threads, p, stream);
  return launch(flash_f32_kernel<D>, f32_smem_bytes<D>(), grid, kF32Threads,
                p, stream);
}

}  // namespace

// q, k, v, o: device pointers; element strides (batch, head, row) of each,
// the head dim D contiguous.  dtype: 0 float32, 1 bfloat16 (all four
// tensors).  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int is_bf16, int B,
    int Hq, int Hkv, int L, int D, long long q_sb, long long q_sh,
    long long q_sl, long long k_sb, long long k_sh, long long k_sl,
    long long v_sb, long long v_sh, long long v_sl, long long o_sb,
    long long o_sh, long long o_sl, int causal, int window, float scale,
    void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || L <= 0 || Hq % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.L = L;
  p.group = Hq / Hkv;
  p.sq = {q_sb, q_sh, q_sl};
  p.sk = {k_sb, k_sh, k_sl};
  p.sv = {v_sb, v_sh, v_sl};
  p.so = {o_sb, o_sh, o_sl};
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  const dim3 grid((L + kBlockQ - 1) / kBlockQ, Hq, B);
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
