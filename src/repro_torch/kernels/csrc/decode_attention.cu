// Single-token decode attention, hand-written for Hopper (sm_90a):
// flash-decoding, S split across CTAs.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention_bhsd (Pallas body _decode_kernel): one query token per
// (batch, query head) against a ring-buffer KV cache,
//
//   o[b, h, :] = sum_s softmax_s(valid(s) ? scale * q.k[b, h/group, s] : -1e30) v[b, h/group, s, :]
//
// valid(s) = pos[b, s] >= 0 && pos[b, s] <= q_pos[b]
//            && (!window || q_pos[b] - pos[b, s] < window),
// p = 0 where invalid, f32 statistics, o = acc / max(l, 1e-30) in q's dtype
// (0 for a row with no valid slot).
//
// What bounds it: bytes.  Every cache byte is used once per query head of
// its group for 2 flops: at yi-6b (group 8, bf16) 8 flop/byte, far under
// the H100's ridge.  The least time is the valid slots' k and v
// (2*B*Hkv*S_valid*D*size bytes) plus q, o and pos over 3.35 TB/s: 5.0 us
// for the half-full ring at B = 4, Hkv = 4, S = 4096, D = 128 in bf16.
//
// Design: fill the card with bytes in flight (flash-decoding).
// * A CTA takes one (kv head, chunk of <= 8 query heads of its group,
//   batch, S chunk).  The wrapper picks the chunk length
//   (decode_attention.py `plan`) so that B * Hkv * head chunks * S
//   chunks is about 4 x 132 CTAs, two busy CTAs an SM even when half the
//   ring is empty; where B * Hkv alone fills the card there is one chunk.
//   A CTA first reads its chunk's pos (one validity bit a slot, in shared
//   memory); a CTA whose chunk holds no valid slot writes m = -1e30, l = 0
//   and exits without reading k or v.
// * k and v rows reach shared memory through a cp.async ring: each 16-byte
//   copy takes a piece of a whole row, consecutive threads on consecutive
//   pieces of a row, so a warp reads contiguous rows; a slot the mask
//   drops is zero-filled (src-size 0), never read from device memory.
//   Every cache byte is read once per kv head, not once per query head.
// * bf16 (decode_mma_kernel): 4 warps walk the chunk in rounds of 128 keys
//   (a 2-stage ring when the chunk holds more than one round); warp w takes
//   block w of a round on the tensor cores, mma.sync m16n8k16 with the <= 8
//   heads padded to 16 rows: S = Q K^T (Q's fragments in registers, K's
//   from rows padded by 16 bytes), an online softmax in base 2 (scores
//   scaled by scale * log2(e), exp2f), O += P V (V's fragments through
//   ldmatrix.trans).  P is not rounded to bf16 for P V: it enters as
//   P_hi + P_lo, two bf16 operands and two products (about 16 bits of P),
//   so the only roundings are those of the inputs and of o, as in the f32
//   reference.  The 4 warps' (m, l, O) then combine in warp order.
// * f32 (decode_f32_kernel), on the CUDA cores so that f32 stays f32: 8
//   warps, one a head, every 32-key block through a 3-stage ring; for q.k a
//   lane owns a key (k rows padded, conflict-free), the online softmax runs
//   per warp, and for p.v a lane owns D/32 columns and reads v rows whole.
// * decode_combine_kernel: each chunk's (m, l, acc) go to f32 scratch the
//   wrapper allocates; a second small kernel combines them per (batch,
//   head) in chunk order, so the result does not depend on scheduling.  A
//   chunk with no valid slot adds nothing; a row with none gives 0.  With
//   one chunk the first kernel writes o itself and the second is not
//   launched.
// * k, v and pos are read through strides, so the model's cache layout
//   [B, S, Hkv, D] is read in place, without a transposed copy.
//
// What the first design lost (128 us at the shape above, against 21.5 us
// for F.scaled_dot_product_attention on an H100, PERF.md): one CTA per
// (kv head, batch) gave 16 CTAs for 132 SMs; a lane walked its own key row
// from device memory, so a warp's 16-byte loads landed on 32 rows; and
// p.v read one v row per dependent step, so few bytes were in flight.  The
// split alone left the bf16 path bound by instructions (8 warps doing the
// whole head chunk's q.k and p.v on the CUDA cores, about 25 us); the
// tensor cores took that away.
//
// The C entry point checks its arguments and returns cudaGetLastError().

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kHeads = 8;           // query heads a CTA
constexpr int kKeys = 32;           // keys a block
constexpr int kMaxChunk = 8192;     // slots a CTA takes, at most
constexpr int kMaxSplits = 6144;    // chunks the combine's shared memory holds
constexpr float kNegInf = -1e30f;

// f32: 8 warps, one a head; every block of 32 keys passes a 3-stage ring
constexpr int kF32Warps = 8;
constexpr int kF32Stages = 3;
// bf16: 4 warps, one a block of a 128-key round; rounds pass a 2-stage ring
constexpr int kMmaWarps = 4;
constexpr int kRound = kMmaWarps * kKeys;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  const int* q_pos;
  void* o;
  float* part_ml;     // [B, Hq, n_split, 2]: m, l of each chunk
  float* part_acc;    // [B, Hq, n_split, D]
  int S, Hq, group, chunk, n_split;
  long long q_sb, q_sh;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long pos_sb, pos_ss;
  long long o_sb, o_sh;
  int window;
  float scale_log2;   // scale * log2(e)
};

__device__ __forceinline__ void from_float(float& dst, float x) { dst = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16& dst, float x) {
  dst = __float2bfloat16_rn(x);
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 16 bytes global -> shared; src_bytes 0 fills zeros without a read
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// What a CTA of either kernel works on: (kv head, chunk of <= 8 query heads
// of its group) in x, batch in y, S chunk in z.
struct Work {
  int hk, h0, nh, b, split, s_begin, s_end, n_blocks, qpos;
  long long part0;    // (b, h0, split) in the chunk scratch

  __device__ Work(const Params& p) {
    const int chunks = (p.group + kHeads - 1) / kHeads;
    hk = blockIdx.x / chunks;
    h0 = hk * p.group + (blockIdx.x % chunks) * kHeads;
    nh = min(kHeads, hk * p.group + p.group - h0);
    b = blockIdx.y;
    split = blockIdx.z;
    s_begin = split * p.chunk;
    s_end = min(s_begin + p.chunk, p.S);
    n_blocks = (s_end - s_begin + kKeys - 1) / kKeys;
    qpos = p.q_pos[b];
    part0 = (static_cast<long long>(b) * p.Hq + h0) * p.n_split + split;
  }
};

// Bit r of keep[j] <- slot s_begin + 32 j + r is valid; returns whether any
// slot of the chunk is (a barrier for the whole CTA).
__device__ __forceinline__ bool scan_chunk(const Params& p, const Work& w,
                                           unsigned* keep) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int* pos = p.pos + w.b * p.pos_sb;
  bool any = false;
  for (int j0 = 0; j0 < w.n_blocks; j0 += warps) {
    const int s = w.s_begin + (j0 + warp) * kKeys + lane;
    bool ok = false;
    if (s < w.s_end) {
      const int kp = pos[s * p.pos_ss];
      ok = kp >= 0 && kp <= w.qpos && (p.window <= 0 || w.qpos - kp < p.window);
    }
    const unsigned bits = __ballot_sync(0xffffffffu, ok);
    if (j0 + warp < w.n_blocks && lane == 0) keep[j0 + warp] = bits;
    any = any || bits != 0u;
  }
  return __syncthreads_or(any);
}

// A chunk with no valid slot: m = -1e30, l = 0, acc = 0; with one chunk,
// the row has no valid slot at all and reads 0.
template <typename T, int D>
__device__ __forceinline__ void write_empty(const Params& p, const Work& w) {
  if (p.n_split > 1) {
    for (int i = threadIdx.x; i < w.nh * D; i += blockDim.x)
      p.part_acc[(w.part0 + (i / D) * p.n_split) * D + i % D] = 0.f;
    if (threadIdx.x < w.nh) {
      p.part_ml[2 * (w.part0 + threadIdx.x * p.n_split)] = kNegInf;
      p.part_ml[2 * (w.part0 + threadIdx.x * p.n_split) + 1] = 0.f;
    }
  } else {
    T* o = static_cast<T*>(p.o) + w.b * p.o_sb;
    for (int i = threadIdx.x; i < w.nh * D; i += blockDim.x)
      from_float(o[(w.h0 + i / D) * p.o_sh + i % D], 0.f);
  }
}

// The chunk's result for head h of the CTA, column d: the chunk's partial
// (m, l, unnormalised acc) with several chunks, else o = acc / max(l, 1e-30).
template <typename T, int D>
__device__ __forceinline__ void write_result(const Params& p, const Work& w,
                                             int h, int d, float m, float l,
                                             float acc, bool writes_ml) {
  if (p.n_split > 1) {
    const long long part = w.part0 + h * p.n_split;
    if (writes_ml) {
      p.part_ml[2 * part] = m;
      p.part_ml[2 * part + 1] = l;
    }
    p.part_acc[part * D + d] = acc;
  } else {
    T* o = static_cast<T*>(p.o) + w.b * p.o_sb;
    from_float(o[(w.h0 + h) * p.o_sh + d], acc / fmaxf(l, 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// float32: CUDA cores, so f32 stays f32
// ---------------------------------------------------------------------------

template <int D>
struct F32Smem {
  static constexpr int kLdk = D + 4;            // padded k row
  static constexpr int kKBytes = kF32Stages * kKeys * kLdk * 4;
  static constexpr int kVBytes = kF32Stages * kKeys * D * 4;
  static constexpr int kBytes = kKBytes + kVBytes +
                                (kHeads * D + kHeads * kKeys) * 4 +
                                kMaxChunk / kKeys * 4;
};

// A warp is a head.  Every 32-key block: for q.k a lane owns a key (k rows
// padded, so the lanes' row reads do not conflict); an online softmax per
// warp in base 2; for p.v a lane owns D/32 columns and reads v rows whole
// (a dropped slot is zeros with p = 0).
template <int D>
__global__ void __launch_bounds__(kF32Warps * 32)
decode_f32_kernel(Params p) {
  using L = F32Smem<D>;
  constexpr int kPieces = D / 4;               // 16-byte pieces a row
  constexpr int kCopies = 2 * kKeys * kPieces; // pieces of k and v a block
  constexpr int kThreads = kF32Warps * 32;
  constexpr int kCols = D >= 32 ? D / 32 : 1;  // accumulator columns a lane
  extern __shared__ __align__(16) unsigned char f32_smem[];
  float* ks = reinterpret_cast<float*>(f32_smem);            // [st][key][kLdk]
  float* vs = reinterpret_cast<float*>(f32_smem + L::kKBytes);  // [st][key][D]
  float* qs = reinterpret_cast<float*>(f32_smem + L::kKBytes + L::kVBytes);
  float* ps = qs + kHeads * D;                               // [head][key]
  unsigned* keep = reinterpret_cast<unsigned*>(ps + kHeads * kKeys);

  const Work w(p);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* q = static_cast<const float*>(p.q) + w.b * p.q_sb;
  const float* k = static_cast<const float*>(p.k) + w.b * p.k_sb +
                   w.hk * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + w.b * p.v_sb +
                   w.hk * p.v_sh;

  // q first, its latency hidden behind pos's
  constexpr int kQPer = (kHeads * D + kThreads - 1) / kThreads;
  float qv[kQPer];
#pragma unroll
  for (int e = 0; e < kQPer; ++e) {
    const int i = tid + e * kThreads, h = i / D;
    qv[e] = h < w.nh && i < kHeads * D ? q[(w.h0 + h) * p.q_sh + i % D] : 0.f;
  }
  if (!scan_chunk(p, w, keep)) {
    write_empty<float, D>(p, w);
    return;
  }
#pragma unroll
  for (int e = 0; e < kQPer; ++e)
    if (tid + e * kThreads < kHeads * D) qs[tid + e * kThreads] = qv[e];

  // block j into stage st; a slot the mask drops is zero-filled, not read
  auto issue = [&](int j, int st) {
    const int s0 = w.s_begin + j * kKeys;
    const unsigned bits = keep[j];
#pragma unroll
    for (int i0 = 0; i0 < kCopies; i0 += kThreads) {
      const int i = i0 + tid;
      if (kCopies % kThreads != 0 && i >= kCopies) break;
      const int r = (i % (kKeys * kPieces)) / kPieces;
      const int c = (i % kPieces) * 4;
      const bool ok = (bits >> r) & 1u;
      const int s = s0 + r;
      if (i >= kKeys * kPieces)
        cp_async16(vs + (st * kKeys + r) * D + c,
                   ok ? v + s * p.v_ss + c : v, ok ? 16 : 0);
      else
        cp_async16(ks + (st * kKeys + r) * L::kLdk + c,
                   ok ? k + s * p.k_ss + c : k, ok ? 16 : 0);
    }
  };
#pragma unroll
  for (int j = 0; j < kF32Stages - 1; ++j) {
    if (j < w.n_blocks) issue(j, j);
    cp_async_commit();
  }

  float m = kNegInf, l = 0.f, acc[kCols] = {};
  for (int j = 0; j < w.n_blocks; ++j) {
    if (j + kF32Stages - 1 < w.n_blocks)
      issue(j + kF32Stages - 1, (j + kF32Stages - 1) % kF32Stages);
    cp_async_commit();
    cp_async_wait<kF32Stages - 1>();
    __syncthreads();
    const int st = j % kF32Stages;
    const unsigned bits = keep[j];
    if (bits != 0u && warp < w.nh) {
      const bool ok = (bits >> lane) & 1u;
      const float* krow = ks + (st * kKeys + lane) * L::kLdk;
      const float* qh = qs + warp * D;
      float sc = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(krow + d);
        sc = fmaf(qh[d], kv.x, sc);
        sc = fmaf(qh[d + 1], kv.y, sc);
        sc = fmaf(qh[d + 2], kv.z, sc);
        sc = fmaf(qh[d + 3], kv.w, sc);
      }
      const float x = ok ? sc * p.scale_log2 : kNegInf;
      const float m_new = fmaxf(m, warp_max(x));
      const float pk = ok ? exp2f(x - m_new) : 0.f;
      const float alpha = exp2f(m - m_new);
      l = alpha * l + warp_sum(pk);
      m = m_new;
      float* ph = ps + warp * kKeys;
      ph[lane] = pk;
      __syncwarp();
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] *= alpha;
      if (lane * kCols < D) {
        const float* vb = vs + st * kKeys * D + lane * kCols;
#pragma unroll
        for (int r = 0; r < kKeys; r += 4) {
          const float4 pr = *reinterpret_cast<const float4*>(ph + r);
          const float pw[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int c = 0; c < kCols; ++c)
              acc[c] = fmaf(pw[u], vb[(r + u) * D + c], acc[c]);
          }
        }
      }
    }
    __syncthreads();              // the stage is rewritten next
  }
  if (warp < w.nh && lane * kCols < D) {
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      write_result<float, D>(p, w, warp, lane * kCols + c, m, l, acc[c],
                             lane == 0 && c == 0);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor cores through mma.sync m16n8k16
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&t);
}

// (x0, x1) as two bf16 pairs whose sum is (x0, x1) to about 16 bits:
// hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 back = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - back.x, x1 - back.y);
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate; rows 8..15
// of a (heads 8..15 of the 16-row tile) are zero
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a2, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* ptr) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// stages of the bf16 kernel's ring for chunks of `chunk` slots: two when
// a chunk holds more than one round of keys
inline int mma_stages(int chunk) {
  return (chunk + kRound - 1) / kRound > 1 ? 2 : 1;
}

template <int D>
struct MmaSmem {
  static constexpr int kLd = D + 8;             // padded rows, 16 bytes
  static constexpr int kRoundBytes = 2 * kRound * kLd * 2;   // k and v
  // a round of k and v per stage (the stages a launch uses); the warps'
  // (m, l, acc) reuse it at the end; the chunk's validity bits
  static constexpr int kKeepBytes = kMaxChunk / kKeys * 4;
  static int bytes(int stages) { return stages * kRoundBytes + kKeepBytes; }
  static_assert(kMmaWarps * kHeads * (D + 2) * 4 <= kRoundBytes,
                "the warps' partials fit in one stage");
};

// A CTA of 4 warps walks its chunk in rounds of 128 keys; warp w takes
// block w of each round: its scores S [16 heads (8 real), 32 keys] = Q K^T
// (Q's fragments in registers, K's from padded rows), an online softmax in
// base 2 (a thread holds head g = lane / 4), and O [16, D] += P V (V's
// fragments through ldmatrix.trans).  The warps' (m, l, O) then combine
// in warp order.
template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32)
decode_mma_kernel(Params p, int stages) {
  using L = MmaSmem<D>;
  constexpr int kLd = L::kLd;
  constexpr int kThreads = kMmaWarps * 32;
  constexpr int kPieces = D / 8;                  // 16-byte pieces a row
  constexpr int kCopies = 2 * kRound * kPieces;   // pieces of a round
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* kv = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  unsigned* keep =
      reinterpret_cast<unsigned*>(mma_smem + stages * L::kRoundBytes);

  const Work w(p);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k) +
                           w.b * p.k_sb + w.hk * p.k_sh;
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v) +
                           w.b * p.v_sb + w.hk * p.v_sh;

  // Q's A fragments (rows 0..7 = heads; columns 2t, 2t + 1 and 8 more),
  // loaded first, their latency hidden behind pos's
  uint32_t qf[D / 16][2];
  {
    // a row past the chunk's heads reads a head it has (and is zeroed)
    const __nv_bfloat16* qh = static_cast<const __nv_bfloat16*>(p.q) +
                              w.b * p.q_sb + (w.h0 + min(g, w.nh - 1)) * p.q_sh;
    auto pair = [&](int c) {          // elements c, c + 1 as one register
      return g < w.nh ? static_cast<uint32_t>(__bfloat16_as_ushort(qh[c])) |
                            (static_cast<uint32_t>(
                                 __bfloat16_as_ushort(qh[c + 1])) << 16)
                      : 0u;
    };
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      qf[kc][0] = pair(kc * 16 + t * 2);
      qf[kc][1] = pair(kc * 16 + t * 2 + 8);
    }
  }
  if (!scan_chunk(p, w, keep)) {
    write_empty<__nv_bfloat16, D>(p, w);
    return;
  }

  // round r (keys s_begin + 128 r ..) into stage st: k rows 0..127 then v
  // rows; a slot the mask drops is zero-filled, not read
  const int n_rounds = (w.n_blocks + kMmaWarps - 1) / kMmaWarps;
  auto issue = [&](int r, int st) {
    __nv_bfloat16* dst = kv + st * 2 * kRound * kLd;
    const int s0 = w.s_begin + r * kRound;
#pragma unroll 4
    for (int i0 = 0; i0 < kCopies; i0 += kThreads) {
      const int i = i0 + tid;
      if (kCopies % kThreads != 0 && i >= kCopies) break;
      const bool is_v = i >= kRound * kPieces;
      const int row = (i % (kRound * kPieces)) / kPieces;
      const int c = (i % kPieces) * 8;
      const int j = r * kMmaWarps + row / kKeys;
      const bool ok = j < w.n_blocks && ((keep[j] >> (row % kKeys)) & 1u);
      const int s = s0 + row;
      cp_async16(dst + (is_v ? kRound + row : row) * kLd + c,
                 ok ? (is_v ? v + s * p.v_ss : k + s * p.k_ss) + c : k,
                 ok ? 16 : 0);
    }
  };
  issue(0, 0);
  cp_async_commit();

  float m = kNegInf, l = 0.f;
  float o[D / 8][4] = {};
  for (int r = 0; r < n_rounds; ++r) {
    if (r + 1 < n_rounds) issue(r + 1, (r + 1) % stages);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int j = r * kMmaWarps + warp;
    const unsigned bits = j < w.n_blocks ? keep[j] : 0u;
    if (bits != 0u) {
      const __nv_bfloat16* kb =
          kv + (r % stages) * 2 * kRound * kLd + warp * kKeys * kLd;
      const __nv_bfloat16* vb = kb + kRound * kLd;
      float sacc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        sacc[n][0] = sacc[n][1] = sacc[n][2] = sacc[n][3] = 0.f;
        const __nv_bfloat16* kr = kb + (n * 8 + g) * kLd + t * 2;
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc)
          mma_bf16(sacc[n], qf[kc][0], qf[kc][1], ld_u32(kr + kc * 16),
                   ld_u32(kr + kc * 16 + 8));
      }
      // element e < 2 of tile n: head g, key 8n + 2t + e of the block
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = (bits >> (n * 8 + t * 2 + e)) & 1u;
          sacc[n][e] = ok ? sacc[n][e] * p.scale_log2 : kNegInf;
          mx = fmaxf(mx, sacc[n][e]);
        }
      }
      const float m_new = fmaxf(m, quad_max(mx));
      const float alpha = exp2f(m - m_new);
      float rs = 0.f;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = (bits >> (n * 8 + t * 2 + e)) & 1u;
          sacc[n][e] = ok ? exp2f(sacc[n][e] - m_new) : 0.f;
          rs += sacc[n][e];
        }
      }
      l = alpha * l + quad_sum(rs);
      m = m_new;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= alpha;
        o[n][1] *= alpha;
      }
      // O += P V, 16 keys at a time: P's accumulator layout is the A
      // fragment's; V's B fragments for 16 columns per ldmatrix.x4.trans.
      // P is not rounded to bf16: it goes in as P_hi + P_lo, two bf16
      // operands (P_lo = P - P_hi, so P keeps about 16 bits), as the f32
      // reference has it; the second product costs the tensor cores a
      // little time, and this kernel is bound by bytes.
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        uint32_t a0, a0_lo, a2, a2_lo;
        split_bf16(sacc[2 * jj][0], sacc[2 * jj][1], a0, a0_lo);
        split_bf16(sacc[2 * jj + 1][0], sacc[2 * jj + 1][1], a2, a2_lo);
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
          uint32_t vf[4];
          ldmatrix_x4_trans(
              vf, vb + (16 * jj + ((lane >> 3) & 1) * 8 + (lane & 7)) * kLd +
                      dn * 16 + (lane >> 4) * 8);
          mma_bf16(o[2 * dn], a0, a2, vf[0], vf[1]);
          mma_bf16(o[2 * dn + 1], a0, a2, vf[2], vf[3]);
          mma_bf16(o[2 * dn], a0_lo, a2_lo, vf[0], vf[1]);
          mma_bf16(o[2 * dn + 1], a0_lo, a2_lo, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();              // the stage is rewritten next
  }

  // the warps' (m, l, O) for heads 0..7 into shared memory, then combined
  // in warp order: M = max m_w, L = sum l_w 2^(m_w - M), acc likewise
  float* wm = reinterpret_cast<float*>(mma_smem);   // [warp][head]
  float* wl = wm + kMmaWarps * kHeads;
  float* wo = wl + kMmaWarps * kHeads;              // [warp][head][D]
  if (t == 0) {
    wm[warp * kHeads + g] = m;
    wl[warp * kHeads + g] = l;
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    wo[(warp * kHeads + g) * D + n * 8 + t * 2] = o[n][0];
    wo[(warp * kHeads + g) * D + n * 8 + t * 2 + 1] = o[n][1];
  }
  __syncthreads();
  for (int i = tid; i < w.nh * D; i += kThreads) {
    const int h = i / D, d = i % D;
    float mx = kNegInf;
#pragma unroll
    for (int x = 0; x < kMmaWarps; ++x) mx = fmaxf(mx, wm[x * kHeads + h]);
    float lsum = 0.f, acc = 0.f;
#pragma unroll
    for (int x = 0; x < kMmaWarps; ++x) {
      const float f = exp2f(wm[x * kHeads + h] - mx);
      lsum += wl[x * kHeads + h] * f;
      acc += wo[(x * kHeads + h) * D + d] * f;
    }
    write_result<__nv_bfloat16, D>(p, w, h, d, mx, lsum, acc, d == 0);
  }
}

// o[b, h] from the chunks' (m, l, acc), in chunk order; a chunk with l = 0
// (no valid slot, acc zero) adds nothing, and a row with none gives 0.
// The chunks' (m, l) are read once, in parallel, into shared memory.
template <typename T, int D>
__global__ void __launch_bounds__(128)
decode_combine_kernel(Params p) {
  extern __shared__ float comb[];   // m of each chunk, then l
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int n = p.n_split;
  const long long row = static_cast<long long>(b) * p.Hq + h;
  const float* ml = p.part_ml + 2 * row * n;
  const float* acc = p.part_acc + row * n * D;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float li = ml[2 * i + 1];
    comb[i] = li > 0.f ? ml[2 * i] : kNegInf;
    comb[n + i] = li;
  }
  __syncthreads();
  float mx = kNegInf;
  for (int i = 0; i < n; ++i) mx = fmaxf(mx, comb[i]);
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float lsum = 0.f, out = 0.f;
#pragma unroll 16
    for (int i = 0; i < n; ++i) {
      const float li = comb[n + i];
      const float f = li > 0.f ? exp2f(comb[i] - mx) : 0.f;
      lsum += li * f;
      out += acc[i * D + d] * f;
    }
    from_float(o[d], out / fmaxf(lsum, 1e-30f));
  }
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int D>
cudaError_t launch(int is_bf16, const Params& p, int Hkv, int B,
                   cudaStream_t stream) {
  const int chunks = (p.group + kHeads - 1) / kHeads;
  const dim3 grid(Hkv * chunks, B, p.n_split);
  cudaError_t err;
  if (is_bf16) {
    const int stages = mma_stages(p.chunk);
    const int smem = MmaSmem<D>::bytes(stages);
    err = opt_in(decode_mma_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    decode_mma_kernel<D><<<grid, kMmaWarps * 32, smem, stream>>>(p, stages);
  } else {
    const int smem = F32Smem<D>::kBytes;
    err = opt_in(decode_f32_kernel<D>, smem);
    if (err != cudaSuccess) return err;
    decode_f32_kernel<D><<<grid, kF32Warps * 32, smem, stream>>>(p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return err;
  const size_t comb = 2 * p.n_split * sizeof(float);
  if (is_bf16)
    decode_combine_kernel<__nv_bfloat16, D>
        <<<dim3(p.Hq, B), 128, comb, stream>>>(p);
  else
    decode_combine_kernel<float, D><<<dim3(p.Hq, B), 128, comb, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q [B, Hq, D], k/v [B, Hkv, S, D] and o [B, Hq, D] through element
// strides (the head dim contiguous); pos [B, S] and q_pos [B] int32.
// dtype: 0 float32, 1 bfloat16 (q, k, v and o).  S is cut into n_split
// chunks of `chunk` slots (n_split = ceil(S / chunk), chunk <= 8192); with
// n_split > 1, part is f32 scratch of B * Hq * n_split * (D + 2) floats.
// Returns a cudaError_t.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const int* pos,
    const int* q_pos, void* o, float* part, int is_bf16, int B, int Hq,
    int Hkv, int S, int D, int chunk, long long q_sb, long long q_sh,
    long long k_sb, long long k_sh, long long k_ss, long long v_sb,
    long long v_sh, long long v_ss, long long pos_sb, long long pos_ss,
    long long o_sb, long long o_sh, int window, float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || S <= 0 || Hq % Hkv != 0 ||
      chunk <= 0 || chunk > kMaxChunk)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = q; p.k = k; p.v = v; p.pos = pos; p.q_pos = q_pos; p.o = o;
  p.S = S;
  p.Hq = Hq;
  p.group = Hq / Hkv;
  p.chunk = chunk;
  p.n_split = (S + chunk - 1) / chunk;
  if ((p.n_split > 1 && part == nullptr) || p.n_split > kMaxSplits)
    return static_cast<int>(cudaErrorInvalidValue);
  p.part_ml = part;
  p.part_acc = part == nullptr ? nullptr : part + 2LL * B * Hq * p.n_split;
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_ss = k_ss;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_ss = v_ss;
  p.pos_sb = pos_sb; p.pos_ss = pos_ss;
  p.o_sb = o_sb; p.o_sh = o_sh;
  p.window = window;
  p.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return static_cast<int>(launch<16>(is_bf16, p, Hkv, B, s));
    case 32: return static_cast<int>(launch<32>(is_bf16, p, Hkv, B, s));
    case 64: return static_cast<int>(launch<64>(is_bf16, p, Hkv, B, s));
    case 128: return static_cast<int>(launch<128>(is_bf16, p, Hkv, B, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory a CTA of the route's split kernel takes at the
// given chunk length, in bytes (0 for a head dim the entry refuses).
extern "C" int decode_attention_smem_bytes(int is_bf16, int D, int chunk) {
  const int stages = mma_stages(chunk);
  switch (D) {
    case 16: return is_bf16 ? MmaSmem<16>::bytes(stages) : F32Smem<16>::kBytes;
    case 32: return is_bf16 ? MmaSmem<32>::bytes(stages) : F32Smem<32>::kBytes;
    case 64: return is_bf16 ? MmaSmem<64>::bytes(stages) : F32Smem<64>::kBytes;
    case 128:
      return is_bf16 ? MmaSmem<128>::bytes(stages) : F32Smem<128>::kBytes;
    default: return 0;
  }
}
