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
// At RecurrentGemma's local attention (B = 2, Hq = 10, Hkv = 1, L = 4096,
// D = 256, causal, window 2048) the mask keeps 125,849,600 (q, k) pairs:
// 1.289e11 flops on 92 MB, ~1,400 flop/byte, so it is bound by operations
// too (0.130 ms at the bf16 peak).  Each CTA of a batch reads the same K/V
// (MQA, 4 MB a batch), which stays in L2.
//
// Three routes, a fixed function of (dtype, D) that the caller names
// (flash_attention.py `route`) and this file checks:
//
// * bf16, D in {64, 128, 256}: flash_wgmma_kernel, built the Hopper way.
//   - A CTA owns 128 query rows of one (batch, head): two consumer
//     warpgroups of 64 rows each.  It walks the K/V tiles that some row of
//     its q tile can see; tiles every row masks are neither loaded nor
//     computed.  A tile is 128 keys at D = 64 and 64 keys at D = 128 and
//     256 (at D = 128, S 32, O 64 and P 16 registers a thread fit without
//     spilling; 128-key tiles spilled and made ptxas serialise the wgmmas).
//   - At D 64 and 128 a producer warpgroup, whose one thread issues every
//     copy, joins them (384 threads, one CTA an SM; setmaxnreg moves
//     registers from the producer to the consumers at run time).
//   - D = 256 is bound by registers: a consumer thread holds O for 64 rows
//     x 256 (128 f32 registers), S (32) and P (16) for a 64-key tile, 176
//     before addresses and row state.  ptxas allocates within the launch
//     bound whatever setmaxnreg does later, and a 384-thread CTA bounds it
//     at 168: there 32-key tiles (O 128 + S 16 + P 8) spilled 192 B and
//     64-key tiles 480 B, and both serialised the wgmmas.  So at D = 256
//     the CTA is the two consumer warpgroups alone (256 threads, up to 255
//     registers; 191 used, no spills), and thread 0 issues the copies
//     between its own tiles: each tile as soon as both warpgroups have
//     released its stage, waiting only for the tile its warpgroup needs
//     next.  Two stages of 64 keys: 64 KB of Q + 2 x 64 KB of K/V.
//   - K/V tiles arrive by TMA (cp.async.bulk.tensor) into a ring of stages
//     (2 at D = 256, 4 at D = 128: 32 KB of Q + 4 x 32 KB; 3 at D = 64),
//     with a full mbarrier per stage for K and one for V and an empty
//     mbarrier the 8 consumer warps release.  Q arrives by TMA once.  The
//     tensor maps are 4-D over (D, L, H, B) with the caller's strides, so
//     the model's [B, L, H, D] layout is read in place; SWIZZLE_128B, so a
//     row arrives as D / 64 boxes of 64 columns.  Rows past L arrive
//     zero-filled.  A map cannot step a stride of 0, so a broadcast
//     (expanded) dim of size > 1 is refused on this route.
//     The maps are encoded on the host each call with
//     cuTensorMapEncodeTiled, reached through
//     cudaGetDriverEntryPoint(ByVersion): no -lcuda.
//   - S = Q K^T is wgmma m64nBKk16 with Q and K both K-major in shared
//     memory; O += P V is wgmma m64nDk16 with P rounded to bf16 in
//     registers (the S accumulator's layout is the A fragment's) and V read
//     in its natural [key, d] layout as the MN-major (transposed) B operand:
//     no V transpose.  Accumulators, running max and sum are f32 registers.
//   - Softmax in base 2: the row maximum is taken on the raw scores, then
//     p = 2^(s * scale * log2(e) - max) is one FMA and one ex2.approx an
//     element, with the -1e30 and 1e-30 conventions unchanged; maxima and
//     sums run as four independent chains a row, and O's rescale is skipped
//     by a warp whose maxima all held.  The mask is evaluated only on tiles
//     that cross the diagonal, the window's edge or L; interior tiles skip
//     it.
//   - Per tile a warpgroup runs S, its softmax, then P V, each product
//     completing before its registers are touched again; the other
//     warpgroup's products run under this one's softmax.  (Passing the
//     tensor cores between the warpgroups with named barriers, and issuing
//     P V of one tile with S of the next, measured slower on an H100.)
//   - With a causal mask the q tiles launch heaviest first (grid z runs
//     over q tiles in reverse, heads and batch in x and y), so the tail is
//     short.
// * bf16, D in {16, 32}: flash_bf16_kernel, the first design (mma.sync
//   m16n8k16, 64-row tiles, synchronous loads), which the wgmma tiling does
//   not replace at these widths.  Q stays in shared memory, and each
//   16-column chunk's A fragment is read once per K tile and shared by the
//   tile's 8 key groups.
// * f32, D in {16, 32, 64, 128, 256}: flash_3xtf32_kernel, both products
//   on the tensor cores in 3xTF32, so that the route computes the float32
//   function to about float32 rounding.  Bound: each f32 product is three
//   TF32 products, so 3 x 4 x kept pairs x D over the 495 TFLOP/s of TF32
//   (1.666 ms at the scoring shape, 0.833 ms at MusicGen's D 64); bytes
//   are a tenth of that.  The first design (FMAs on the CUDA cores, 4
//   threads a q row, each K/V element read from shared memory once a row,
//   synchronous copies, one 118,784 B CTA an SM at D 128) took 23.4 ms at
//   the scoring shape, against 26.5 ms for SDPA in f32; this one takes
//   ~5.4 ms there and ~2.8 ms at MusicGen's D 64, where SDPA takes 4.26
//   (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//   - 3xTF32: every operand v is split in registers into hi (v with its
//     low 13 mantissa bits cleared: a mask, not cvt.rna) and lo = v - hi
//     (exact), and each product adds lo*hi + hi*lo + hi*hi, about 22 bits
//     an operand where one TF32 product keeps 11.  S keeps its cross terms
//     in a second accumulator, so the three products of a step do not wait
//     on each other.  The tensor cores' f32 sums drop the low bits of each
//     addition, biased toward 0: summed over a 4,096-key row on the tensor
//     cores, O drifted by 4.6e-5 of its size (H100, as above), so each K/V
//     tile's share of O is summed from 0 there and added to O in IEEE f32
//     (4.6e-6 at that shape).
//   - The instruction is mma.sync.m16n8k8 (tf32): its fragments are split
//     in registers, so no hi/lo copy sits in shared memory, and one kernel
//     serves every D.  wgmma takes TF32 operands K-major only (V would be
//     staged key-major) and reads B from shared memory, so both hi and lo
//     of K and V would sit there: twice the bytes of a K/V tile, 128 KB a
//     64-key stage at D 256.
//   - Reuse: each warp takes 16 q rows against the whole K/V tile, so each
//     K/V fragment read from shared memory feeds 16 rows.  Q and K are
//     read with 16-byte loads that feed two k-steps (columns 4t .. 4t + 3
//     of 16: the product's k order is free as long as Q and K agree), V
//     with loads that feed up to four n tiles (O's columns are permuted in
//     registers and put back when O is written).
//   - P stays in registers with no shuffle and no shared memory: P V's
//     k index is permuted so that step index t is key 2t and t + 4 is key
//     2t + 1, which makes S's accumulator layout the A fragment's; V's
//     fragments are read from key rows 2t and 2t + 1.
//   - CTAs: 4 warps (64 q rows) up to D 128, two CTAs an SM (96,256 B of
//     shared memory at D 64 with 64-key tiles, 107,520 B at D 128 with
//     32-key tiles); at D 256, where O alone takes 128 registers a thread,
//     8 warps (128 q rows) and 16-key tiles, one 207,360 B CTA an SM: with
//     4 warps an SM the tensor cores idled (3.9 ms at RecurrentGemma's
//     shape, against 2.8).
//   - K/V tiles come through a two-stage cp.async ring (16-byte copies
//     through any stride, a stride of 0 included; rows past L
//     zero-filled): tile i + 1 is copied while tile i is multiplied, one
//     barrier a tile.
//   - Softmax in base 2 (log2 e folded into the scale, ex2.approx); the
//     mask is evaluated once an element and only on a tile that L, the
//     diagonal or the window's edge cuts; a warp skips a tile that its
//     rows mask whole; each thread keeps its share of the row sums, added
//     across the quad once at the end; O's rescale is skipped where no
//     row's maximum moved.  With a causal mask the q tiles launch
//     heaviest first.
//
// What the first bf16 design lost (4.28 ms at the scoring shape, against
// 0.455 ms for F.scaled_dot_product_attention on an H100, PERF.md): every
// K/V tile was copied global -> shared by all threads between two
// __syncthreads, so the tensor cores idled through every load; 205
// registers a thread left two 128-thread CTAs an SM, too few warps to hide
// those loads; mma.sync has no path to wgmma's rate, and K's fragments
// came through 32-bit shared loads; the mask was evaluated twice on every
// element of every tile; expf where exp2f would do; and the causal grid
// launched the lightest q tiles first, so the heaviest made the tail.
//
// Every route reads q, k, v and o through (batch, head, row) strides with
// the head dim contiguous, so no transposed or padded copy is made.  The C
// entry point checks its arguments and returns a cudaError_t.

#include <cmath>
#include <cstdint>
#include <cuda.h>
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

// K tiles of BK keys [begin, end) that hold a key some row of the BQ-row q
// tile at q0 may see.
template <int BQ = kBlockQ, int BK = kBlockK>
__device__ __forceinline__ void k_tiles(const Params& p, int q0, int& begin,
                                        int& end) {
  const int q_last = min(q0 + BQ, p.L) - 1;
  const int k_hi = p.causal ? q_last : p.L - 1;
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  begin = k_lo / BK;
  end = k_hi / BK + 1;
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
// bfloat16, D in {16, 32}: tensor cores through mma.sync m16n8k16
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

// the A fragment (16 x 16, row) of rows [0, 16) and columns [16 kc,
// 16 kc + 16) of a row-major bf16 tile with row stride lds
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4],
                                            const __nv_bfloat16* tile,
                                            int lds, int kc, int g, int t) {
  a[0] = ld_u32(tile + g * lds + kc * 16 + t * 2);
  a[1] = ld_u32(tile + (g + 8) * lds + kc * 16 + t * 2);
  a[2] = ld_u32(tile + g * lds + kc * 16 + 8 + t * 2);
  a[3] = ld_u32(tile + (g + 8) * lds + kc * 16 + 8 + t * 2);
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

// two CTAs an SM (shared memory allows it at every D); the hint also keeps
// ptxas from spilling at D 16
template <int D>
__global__ void __launch_bounds__(kBf16Threads, 2)
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

  // this warp's 16 q rows: their A fragments are read from shared memory
  // (which keeps Q for the whole walk) once per K tile and 16-column chunk
  const __nv_bfloat16* qw = Qs + warp * 16 * LDS;

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
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll 4
    for (int kc = 0; kc < D / 16; ++kc) {
      uint32_t a[4];
      load_a_frag(a, qw, LDS, kc, g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* kr = Ks + (n * 8 + g) * LDS + kc * 16 + t * 2;
        mma_bf16(s[n], a, ld_u32(kr), ld_u32(kr + 8));
      }
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

// ---------------------------------------------------------------------------
// bfloat16, D in {64, 128, 256}: wgmma + TMA, two consumer warpgroups and,
// at D 64 and 128, a producer warpgroup
// ---------------------------------------------------------------------------

constexpr int kWgBlockQ = 128;       // q rows a CTA: two warpgroups of 64
constexpr int kQBoxBytes = kWgBlockQ * 128;  // a 64-column box of Q
constexpr int kWgConsumers = 256;    // two consumer warpgroups
// registers a thread after setmaxnreg: 2 x 128 x 232 + 128 x 40 <= 65,536
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kBoxCols = 64;         // SWIZZLE_128B: 128 bytes of bf16 a row
constexpr int kAtomBytes = 1024;     // 8 rows of 128 bytes: one swizzle atom

template <int D>
struct WgLayout {
  // keys a K/V tile: 128 at D = 64; 64 at D = 128, where S, O and P must
  // share the registers (S 32 + O 64 + P 16 a thread), and at D = 256
  // (S 32 + O 128 + P 16), which fits only without a producer warpgroup
  static constexpr int kBK = D == 64 ? 128 : 64;
  static constexpr int kStages = D == 256 ? 2 : D == 128 ? 4 : 3;
  // D = 256: no producer warpgroup, so that ptxas may give the consumers
  // 255 registers a thread instead of the 168 of a 384-thread CTA
  // (setmaxnreg moves registers at run time, but ptxas allocates within
  // the launch bound); a consumer thread issues the copies
  static constexpr bool kProducerWarpGroup = D != 256;
  static constexpr int kThreads = kWgConsumers + (kProducerWarpGroup ? 128 : 0);
  static constexpr int kBoxBytes = kBK * 128;     // a 64-column box of K/V
  static constexpr int kBoxes = D / kBoxCols;    // boxes a tile
  static constexpr int kQBytes = kWgBlockQ * D * 2;
  static constexpr int kTileBytes = kBK * D * 2;
  static constexpr int kBarOffset = kQBytes + 2 * kStages * kTileBytes;
  // full K, full V, empty per stage, and Q's barrier; 1 KB of slack to
  // align the base to a swizzle atom
  static constexpr int kSmemBytes =
      kAtomBytes + kBarOffset + 8 * (3 * kStages + 1);
};

struct WgParams {
  void* o;
  Strides so;
  int L, group, causal, window;
  float scale_log2;      // scale * log2(e)
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the phase of the given parity has completed; a pipeline that
// never completes it traps (a launch failure the caller sees) instead of
// hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done, tries = 0;
  do {
    if (++tries == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// whether the phase of the given parity has completed, without waiting
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// one box at (column, row, head, batch) into shared memory at dst
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// shared-memory matrix descriptor of a SWIZZLE_128B operand: start address,
// leading and stride byte offsets (in 16-byte units), layout type 1
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}


// keeps the compiler from moving accesses of registers that an in-flight
// wgmma reads or writes across its issue or its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
    asm volatile("" : "+r"(r[i][0]), "+r"(r[i][1]), "+r"(r[i][2]),
                 "+r"(r[i][3])::"memory");
}

// d (64 x 128, f32) {+}= A (64 x 16, smem, K-major) * B (16 x 128, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64, f32) {+}= A (64 x 16, smem, K-major) * B (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// the first step of S: d (64 x 128, f32) = A (64 x 16, smem, K-major) * B (16 x 128, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n128_zero(float (&d)[64], uint64_t desc_a,
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]),
        "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]),
        "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]),
        "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(0));
}

// the first step of S: d (64 x 64, f32) = A (64 x 16, smem, K-major) * B (16 x 64, smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64_zero(float (&d)[32], uint64_t desc_a,
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]),
        "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]),
        "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]),
        "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(0));
}

// d (64 x 128, f32) += A (64 x 16, bf16 registers) * B (16 x 128, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, bf16 registers) * B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 256, f32) += A (64 x 16, bf16 registers) * B (16 x 256, smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                            uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// O += P V for one 16-key slice, at the head dim's width
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_v) {
  if constexpr (D == 256)
    wgmma_rs_n256(o, a, desc_v);
  else if constexpr (D == 128)
    wgmma_rs_n128(o, a, desc_v);
  else
    wgmma_rs_n64(o, a, desc_v);
}

// O += P V for a whole tile: V [key, d] at v_st as the MN-major B operand;
// 16 keys are two swizzle atoms (2 KB), the 64-column boxes one box apart
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t v_st) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_pv<D>(o, pa[kk],
                sw128_desc(v_st + kk * 16 * 128, BK * 128, kAtomBytes));
}

// S = Q K^T for one tile: D/16 steps of 16 columns, 4 steps per 64-column
// box, 32 bytes apart inside the swizzle atom; Q and K both K-major
template <int D, int BK>
__device__ __forceinline__ void issue_s(float (&s)[BK / 2], uint32_t q_wg,
                                        uint32_t k_st) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t in_atom = (kk & 3) * 32;
    const uint64_t dq = sw128_desc(q_wg + (kk >> 2) * kQBoxBytes + in_atom,
                                   16, kAtomBytes);
    const uint64_t dk = sw128_desc(k_st + (kk >> 2) * BK * 128 + in_atom, 16,
                                   kAtomBytes);
    // the first step writes s without reading it, so the softmax's writes
    // to s do not count as inputs of this product
    if constexpr (BK == 128) {
      if (kk == 0)
        wgmma_ss_n128_zero(s, dq, dk);
      else
        wgmma_ss_n128(s, dq, dk, 1);
    } else {
      if (kk == 0)
        wgmma_ss_n64_zero(s, dq, dk);
      else
        wgmma_ss_n64(s, dq, dk, 1);
    }
  }
}

__device__ __forceinline__ bool wg_allowed(const WgParams& p, int q, int k) {
  bool ok = k < p.L;
  if (p.causal) ok = ok && (k <= q);
  if (p.window > 0) ok = ok && (q - k < p.window);
  return ok;
}

// 2^x on the SFU (ex2.approx, ~2 ulp; 2^-1e30 flushes to 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One tile's online softmax in base 2 for a thread's two rows qr[0..1]:
// element i of s is row qr[(i >> 1) & 1], key k0 + 8 (i >> 2) + cq + (i & 1).
// The mask is evaluated only where `edge` says the tile crosses it.  The
// row maximum is taken on the raw scores (the scale is positive), so each
// element costs one max, one FMA, one exp2 and one add; maxima and sums
// run as 4 independent chains a row.  P comes out in bf16 as the A operand
// of P V (keys 16kk .. 16kk + 15 are the accumulator's blocks 2kk and
// 2kk + 1); O is left to the caller to rescale by alpha.
template <int BK>
__device__ __forceinline__ void online_softmax(
    float (&s)[BK / 2], uint32_t (&pa)[BK / 16][4], float (&m)[2],
    float (&l)[2], float (&alpha)[2], const WgParams& p, bool edge, int k0,
    const int (&qr)[2], int cq) {
  // element i = 4j + 2r + e: chain (j & 1) * 2 + e of row r
  float mc[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) mc[r][c] = kNegInf;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1;
    if (edge && !wg_allowed(p, qr[r], k0 + (i >> 2) * 8 + cq + (i & 1)))
      s[i] = kNegInf;
    const int c = ((i >> 2) & 1) * 2 + (i & 1);
    mc[r][c] = fmaxf(mc[r][c], s[i]);
  }
  float neg_mx[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float raw = quad_max(fmaxf(fmaxf(mc[r][0], mc[r][1]),
                                     fmaxf(mc[r][2], mc[r][3])));
    const float mx =
        fmaxf(m[r], raw == kNegInf ? kNegInf : raw * p.scale_log2);
    alpha[r] = fast_exp2(m[r] - mx);
    m[r] = mx;
    neg_mx[r] = -mx;
  }
  float rc[2][4] = {};
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1;
    // a masked element is 0, also where the whole row is masked so far
    const float pi = (edge && s[i] == kNegInf)
                         ? 0.f
                         : fast_exp2(fmaf(s[i], p.scale_log2, neg_mx[r]));
    s[i] = pi;
    rc[r][((i >> 2) & 1) * 2 + (i & 1)] += pi;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = alpha[r] * l[r] +
           quad_sum((rc[r][0] + rc[r][1]) + (rc[r][2] + rc[r][3]));
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// O *= alpha a row; skipped by a warp whose rows' maxima all held (the
// common case once a row has seen its largest scores)
template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2],
                                        const float (&alpha)[2]) {
  if (!__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) return;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
}

template <int D>
__global__ void __launch_bounds__(WgLayout<D>::kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, WgParams p) {
  using Lay = WgLayout<D>;
  constexpr int kStages = Lay::kStages;
  constexpr int BK = Lay::kBK;
  extern __shared__ __align__(128) unsigned char wg_smem[];
  const uint32_t base = (smem_u32(wg_smem) + kAtomBytes - 1) &
                        ~static_cast<uint32_t>(kAtomBytes - 1);
  const uint32_t q_s = base;                       // [box][128 rows][64]
  const uint32_t k_s = base + Lay::kQBytes;        // stage st: + st * tile
  const uint32_t v_s = k_s + kStages * Lay::kTileBytes;
  const uint32_t bars = base + Lay::kBarOffset;
  const uint32_t bar_q = bars + 8 * 3 * kStages;
  // full K of stage st: bars + 8 st; full V: + 8 kStages; empty: + 16 kStages
  auto full_k = [&](int st) { return bars + 8 * st; };
  auto full_v = [&](int st) { return bars + 8 * (kStages + st); };
  auto empty = [&](int st) { return bars + 8 * (2 * kStages + st); };

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  // heaviest q tiles first under a causal mask
  const int qt = p.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * kWgBlockQ;
  const int hk = h / p.group;

  // K tiles [kt0, kt1) that hold a key some row of the q tile may see
  const int q_last = min(q0 + kWgBlockQ, p.L) - 1;
  const int k_hi = p.causal ? q_last : p.L - 1;
  const int k_lo = p.window > 0 ? max(0, q0 - p.window + 1) : 0;
  const int kt0 = k_lo / BK;
  const int kt1 = k_hi / BK + 1;

  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty(st), kWgConsumers / 32);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp_group = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (Lay::kProducerWarpGroup && warp_group == kWgConsumers / 128) {
    // producer warpgroup: gives its registers up; one thread issues every
    // copy, K/V kStages - 1 tiles ahead of the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kWgConsumers) {
      mbar_expect_tx(bar_q, Lay::kQBytes);
#pragma unroll
      for (int x = 0; x < Lay::kBoxes; ++x)
        tma_load_4d(q_s + x * kQBoxBytes, &tm_q, bar_q, x * kBoxCols, q0, h,
                    b);
      for (int kt = kt0, it = 0; kt < kt1; ++kt, ++it) {
        const int st = it % kStages;
        mbar_wait(empty(st), ((it / kStages) & 1) ^ 1);   // stage free
        mbar_expect_tx(full_k(st), Lay::kTileBytes);
#pragma unroll
        for (int x = 0; x < Lay::kBoxes; ++x)
          tma_load_4d(k_s + st * Lay::kTileBytes + x * Lay::kBoxBytes, &tm_k,
                      full_k(st), x * kBoxCols, kt * BK, hk, b);
        mbar_expect_tx(full_v(st), Lay::kTileBytes);
#pragma unroll
        for (int x = 0; x < Lay::kBoxes; ++x)
          tma_load_4d(v_s + st * Lay::kTileBytes + x * Lay::kBoxBytes, &tm_v,
                      full_v(st), x * kBoxCols, kt * BK, hk, b);
      }
    }
  } else {
    if constexpr (Lay::kProducerWarpGroup)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
          kConsumerRegs));
    // consumer warpgroup wg owns q rows qa .. qa + 63; a thread holds rows
    // qr[0] and qr[1] of the accumulators, columns 8n + cq + {0, 1}
    const WgParams prm = p;           // not the kernel parameter's address
    const int wg = warp_group;
    const int lane = tid & 31;
    const int qa = q0 + wg * 64;
    const int row = ((tid & 127) >> 5) * 16 + (lane >> 2);
    const int qr[2] = {qa + row, qa + row + 8};
    const int cq = (lane & 3) * 2;
    const uint32_t q_wg = q_s + wg * 64 * 128;
    const int n_tiles = kt1 - kt0;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};
    float s[BK / 2];
    float alpha[2];
    uint32_t pa[BK / 16][4];          // P, bf16
    // the mask cuts tile k0 for some row of this warpgroup: the diagonal,
    // the window's edge or L (every wgmma below runs unconditionally: a
    // wgmma on a divergent path is serialised)
    auto edge = [&](int k0) {
      return k0 + BK > prm.L || (prm.causal && k0 + BK - 1 > qa) ||
             (prm.window > 0 && qa + 63 - k0 >= prm.window);
    };
    // Without a producer warpgroup (D = 256), thread 0 issues every copy
    // between its own tiles: Q once, then tile i of the walk into stage
    // i % kStages once both warpgroups have released the stage's previous
    // tile, i - kStages (the empty phase of parity ((i / kStages) & 1) ^ 1;
    // a fresh barrier counts that phase as complete).  refill(need, upto)
    // issues the tiles before `need` at once, waiting for their stage, then
    // those before `upto` whose stage is already free; with this
    // warpgroup at tile it, tiles before it + kStages qualify.  So thread 0
    // waits for the other warpgroup only for the tile its own needs next.
    int issued = 0;
    auto refill = [&](int need, int upto) {
      for (; issued < n_tiles && issued < upto; ++issued) {
        const int st = issued % kStages;
        const uint32_t parity = ((issued / kStages) & 1) ^ 1;
        if (issued >= need) {
          if (!mbar_test(empty(st), parity)) break;
        } else {
          mbar_wait(empty(st), parity);
        }
        const int kt = kt0 + issued;
        mbar_expect_tx(full_k(st), Lay::kTileBytes);
#pragma unroll
        for (int x = 0; x < Lay::kBoxes; ++x)
          tma_load_4d(k_s + st * Lay::kTileBytes + x * Lay::kBoxBytes, &tm_k,
                      full_k(st), x * kBoxCols, kt * BK, hk, b);
        mbar_expect_tx(full_v(st), Lay::kTileBytes);
#pragma unroll
        for (int x = 0; x < Lay::kBoxes; ++x)
          tma_load_4d(v_s + st * Lay::kTileBytes + x * Lay::kBoxBytes, &tm_v,
                      full_v(st), x * kBoxCols, kt * BK, hk, b);
      }
    };
    if (!Lay::kProducerWarpGroup && tid == 0) {
      mbar_expect_tx(bar_q, Lay::kQBytes);
#pragma unroll
      for (int x = 0; x < Lay::kBoxes; ++x)
        tma_load_4d(q_s + x * kQBoxBytes, &tm_q, bar_q, x * kBoxCols, q0, h,
                    b);
    }

    // Per tile: S, the softmax, P V.  Each product completes before the
    // registers it uses are touched again (a register written while a wgmma
    // that reads it is in flight serialises the wgmmas); the other
    // warpgroup's products run under this one's softmax.  Thread 0's copies
    // (D = 256) go before each tile's S and again before its P V.
    mbar_wait(bar_q, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % kStages;
      const uint32_t parity = (it / kStages) & 1;
      const int k0 = (kt0 + it) * BK;
      if constexpr (!Lay::kProducerWarpGroup) {
        if (tid == 0) refill(it + 1, it + kStages);
        __syncwarp();
      }
      mbar_wait(full_k(st), parity);
      wgmma_fence();
      issue_s<D, BK>(s, q_wg, k_s + st * Lay::kTileBytes);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      online_softmax<BK>(s, pa, m, l, alpha, prm, edge(k0), k0, qr, cq);
      rescale<D>(o, alpha);
      if constexpr (!Lay::kProducerWarpGroup) {
        if (tid == 0) refill(0, it + kStages);
        __syncwarp();
      }
      mbar_wait(full_v(st), parity);
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
      issue_pv<D, BK>(o, pa, v_s + st * Lay::kTileBytes);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(pa);
      __syncwarp();                   // the stage is consumed
      if (lane == 0) mbar_arrive(empty(st));
    }

    __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + b * p.so.b +
                        h * p.so.h;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (qr[r] >= p.L) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow = ob + qr[r] * p.so.l;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<uint32_t*>(orow + n * 8 + cq) =
            pack_bf16(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 on the tensor cores through mma.sync m16n8k8
// ---------------------------------------------------------------------------

template <int D>
struct F32Layout {
  // warps a CTA, 16 q rows each: 4, two CTAs an SM up to D 128; 8 at
  // D 256, where Q's rows fill shared memory so that one CTA fits an SM
  // and its warps are the SM's only ones
  static constexpr int kWarps = D == 256 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kBQ = 16 * kWarps;
  // keys a K/V tile: 64 up to D 64; 32 at D 128, so that two CTAs fit an
  // SM; 16 at D 256, where O takes 128 registers a thread and Q 139 KB
  static constexpr int kBK = D <= 64 ? 64 : D == 256 ? 16 : 32;
  // row strides in floats: Q and K rows 16 mod 32, so that the 16-byte
  // fragment loads of a quarter warp (rows g, g + 1; columns 4t) hit 32
  // banks; V rows 4 mod 32, so that those of rows 2t and 2t + 1 do
  static constexpr int kLdQK = D % 32 == 16 ? D : D + 16;
  static constexpr int kLdV = D + 4;
  // n tiles of P V that one vector load of a V row feeds: a float4; a
  // float2 at D 16, which has two; one float at D 256, where the tile's
  // sums of more n tiles at once made the kernel spill
  static constexpr int kNV = D == 256 ? 1 : D >= 32 ? 4 : 2;
  static constexpr int kKFloats = kBK * kLdQK;
  static constexpr int kStageFloats = kKFloats + kBK * kLdV;
  // Q, then two stages of K and V
  static constexpr int kSmemBytes = 4 * (kBQ * kLdQK + 2 * kStageFloats);
  static constexpr int kMinBlocks = kSmemBytes <= 113 * 1024 ? 2 : 1;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// rows [r0, r0 + rows) of an [L, D] f32 matrix with row stride `stride`
// into shared rows of `ld` floats, 16 bytes a cp.async; rows >= L are
// zero-filled.  Every thread of the CTA calls it.
template <int D, int kThreads>
__device__ __forceinline__ void stage_f32(float* dst, int ld, const float* src,
                                          long long stride, int r0, int rows,
                                          int L) {
  constexpr int kPerRow = D / 4;
  for (int i = threadIdx.x; i < rows * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * 4;
    const bool ok = r0 + r < L;
    cp_async16(dst + r * ld + c, ok ? src + (r0 + r) * stride + c : src, ok);
  }
}

// hi = v with its low 13 mantissa bits cleared (a TF32 value), lo = v - hi
// (exact in f32): a mask and a subtraction, where cvt.rna.tf32.f32 runs on
// a slower pipe (as csrc/ssd_scan.cu splits its operands)
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d += a (16x8, row) * b (8x8, col), tf32 in, f32 accumulate; with g =
// lane / 4, t = lane % 4: a = (g, t), (g + 8, t), (g, t + 4), (g + 8,
// t + 4); b = (k t, n g), (k t + 4, n g); d = (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a's four values split into hi and lo fragments
__device__ __forceinline__ void split4(float a0, float a1, float a2, float a3,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(a0, hi[0], lo[0]);
  split(a1, hi[1], lo[1]);
  split(a2, hi[2], lo[2]);
  split(a3, hi[3], lo[3]);
}

template <int N>
__device__ __forceinline__ void ld_vec(float (&x)[N], const float* ptr) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(ptr);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(ptr);
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = *ptr;
  }
}

template <int N>
__device__ __forceinline__ void st_vec(float* ptr, const float (&x)[N]) {
  if constexpr (N == 4)
    *reinterpret_cast<float4*>(ptr) = make_float4(x[0], x[1], x[2], x[3]);
  else if constexpr (N == 2)
    *reinterpret_cast<float2*>(ptr) = make_float2(x[0], x[1]);
  else
    *ptr = x[0];
}

template <int D>
__global__ void __launch_bounds__(F32Layout<D>::kThreads,
                                  F32Layout<D>::kMinBlocks)
flash_3xtf32_kernel(Params p) {
  using Lay = F32Layout<D>;
  constexpr int BK = Lay::kBK, LDQ = Lay::kLdQK, LDV = Lay::kLdV;
  constexpr int NV = Lay::kNV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);
  float* ring = Qs + Lay::kBQ * LDQ;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  // with a causal mask the q tiles launch heaviest (last) first
  const int qt = p.causal ? gridDim.z - 1 - blockIdx.z : blockIdx.z;
  const int q0 = qt * Lay::kBQ;
  const int hk = h / p.group;
  const int qw = q0 + warp * 16;          // this warp's first row
  const int qr[2] = {qw + g, qw + g + 8};

  const float* q = static_cast<const float*>(p.q) + b * p.sq.b + h * p.sq.h;
  const float* k = static_cast<const float*>(p.k) + b * p.sk.b + hk * p.sk.h;
  const float* v = static_cast<const float*>(p.v) + b * p.sv.b + hk * p.sv.h;

  int kt0, kt1;
  k_tiles<Lay::kBQ, BK>(p, q0, kt0, kt1);
  auto stage_kv = [&](int kt, int slot) {
    float* ks = ring + slot * Lay::kStageFloats;
    stage_f32<D, Lay::kThreads>(ks, LDQ, k, p.sk.l, kt * BK, BK, p.L);
    stage_f32<D, Lay::kThreads>(ks + Lay::kKFloats, LDV, v, p.sv.l, kt * BK,
                                BK, p.L);
  };
  stage_f32<D, Lay::kThreads>(Qs, LDQ, q, p.sq.l, q0, Lay::kBQ, p.L);
  stage_kv(kt0, 0);
  cp_async_commit();

  // O's n tile NV c + i holds columns 8 NV c + NV n + i (n the tile's
  // column 2t or 2t + 1): a thread's V fragments for NV tiles are one
  // vector load, and its outputs 2 NV contiguous floats a row
  float o[D / 8][4] = {};
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};               // this thread's share of the sums
  const float scale_log2 = p.scale * 1.4426950408889634f;
  const float* qa = Qs + (warp * 16 + g) * LDQ + 4 * t;
  const float* qb = qa + 8 * LDQ;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int slot = (kt - kt0) & 1;
    cp_async_wait_all();
    __syncthreads();      // tile kt has landed; every warp is done with kt - 1
    if (kt + 1 < kt1) stage_kv(kt + 1, slot ^ 1);
    cp_async_commit();
    const int k0 = kt * BK;
    // a tile whose every key the mask drops for each of the warp's rows
    if (qw >= p.L || (p.causal && k0 > qw + 15) ||
        (p.window > 0 && qw - (k0 + BK - 1) >= p.window))
      continue;
    const float* ks = ring + slot * Lay::kStageFloats;
    const float* vs = ks + Lay::kKFloats;

    // S = Q K^T, 16 columns of D a step: a thread's 16-byte loads of Q
    // (rows g, g + 8) and K (key 8j + g) at columns 16kc + 4t feed two
    // k-steps, columns (4t, 4t + 1) as the fragments' (t, t + 4), then
    // (4t + 2, 4t + 3); the cross terms sum apart from hi * hi
    float s[BK / 8][4] = {}, sx[BK / 8][4] = {};
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      float x[4], y[4];
      ld_vec<4>(x, qa + 16 * kc);
      ld_vec<4>(y, qb + 16 * kc);
      uint32_t ah0[4], al0[4], ah1[4], al1[4];
      split4(x[0], y[0], x[1], y[1], ah0, al0);
      split4(x[2], y[2], x[3], y[3], ah1, al1);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        float kv[4];
        ld_vec<4>(kv, ks + (8 * j + g) * LDQ + 16 * kc + 4 * t);
        uint32_t bh[4], bl[4];
        split4(kv[0], kv[1], kv[2], kv[3], bh, bl);
        mma_tf32(sx[j], al0, bh[0], bh[1]);
        mma_tf32(sx[j], ah0, bl[0], bl[1]);
        mma_tf32(s[j], ah0, bh[0], bh[1]);
        mma_tf32(sx[j], al1, bh[2], bh[3]);
        mma_tf32(sx[j], ah1, bl[2], bl[3]);
        mma_tf32(s[j], ah1, bh[2], bh[3]);
      }
    }

    // online softmax in base 2: element e of tile j is row qr[e / 2], key
    // k0 + 8j + 2t + e % 2.  The mask is evaluated only on a tile that L,
    // the diagonal or the window's edge cuts; a masked score is -inf, so
    // its p is 0 also where the whole row is masked so far (m = -1e30).
    const bool edge = k0 + BK > p.L || (p.causal && k0 + BK - 1 > qw) ||
                      (p.window > 0 && qw + 15 - k0 >= p.window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = (s[j][e] + sx[j][e]) * scale_log2;
        if (edge && !allowed(p, qr[e >> 1], k0 + 8 * j + 2 * t + (e & 1)))
          x = -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = fast_exp2(m[r] - mn);
      m[r] = mn;
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = fast_exp2(s[j][e] - m[e >> 1]);
        rs[e >> 1] += s[j][e];
      }
    l[0] = alpha[0] * l[0] + rs[0];
    l[1] = alpha[1] * l[1] + rs[1];
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= alpha[0]; o[n][1] *= alpha[0];
        o[n][2] *= alpha[1]; o[n][3] *= alpha[1];
      }
    }

    // O += P V, 8 keys a step.  P stays in registers with no shuffle: the
    // step's k index t stands for key 8j + 2t and t + 4 for key 8j + 2t +
    // 1, so S's accumulator (g, 2t), (g, 2t + 1), (g + 8, ...) is already
    // the A fragment, and V's fragments are read from rows 2t and 2t + 1.
    // The tile's share is summed from 0 on the tensor cores, NV n tiles
    // at a time, and added to O in IEEE f32 (their sums drop low bits).
    uint32_t ph[BK / 8][4], pl[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      split4(s[j][0], s[j][2], s[j][1], s[j][3], ph[j], pl[j]);
    const float* v0 = vs + 2 * t * LDV + NV * g;
#pragma unroll
    for (int c = 0; c < D / (8 * NV); ++c) {
      float acc[NV][4] = {};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        float x0[NV], x1[NV];
        ld_vec<NV>(x0, v0 + 8 * j * LDV + 8 * NV * c);
        ld_vec<NV>(x1, v0 + (8 * j + 1) * LDV + 8 * NV * c);
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          uint32_t bh0, bl0, bh1, bl1;
          split(x0[i], bh0, bl0);
          split(x1[i], bh1, bl1);
          mma_tf32(acc[i], pl[j], bh0, bh1);
          mma_tf32(acc[i], ph[j], bl0, bl1);
          mma_tf32(acc[i], ph[j], bh0, bh1);
        }
      }
#pragma unroll
      for (int i = 0; i < NV; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[NV * c + i][e] += acc[i][e];
    }
  }

  float* ob = static_cast<float*>(p.o) + b * p.so.b + h * p.so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lr = quad_sum(l[r]);
    if (qr[r] >= p.L) continue;
    const float inv = 1.f / fmaxf(lr, 1e-30f);
    float* orow = ob + qr[r] * p.so.l;
#pragma unroll
    for (int c = 0; c < D / (8 * NV); ++c)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        float x[NV];
#pragma unroll
        for (int i = 0; i < NV; ++i) x[i] = o[NV * c + i][2 * r + half] * inv;
        st_vec<NV>(orow + 8 * NV * c + NV * (2 * t + half), x);
      }
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-D map over (D, L, H, B) of a bf16 [B, H, L, D] view with element
// strides s (head dim contiguous), boxes of 64 columns x box_rows rows.
cudaError_t encode_bhld(CUtensorMap* map, const void* ptr, int D, int L,
                        int H, int B, const Strides& s, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  // bytes.  A 0 stride is not encodable: on a size-1 dim (never stepped)
  // any stride does; a broadcast dim of size > 1 is refused, since the
  // map would step it
  cuuint64_t strides[3] = {static_cast<cuuint64_t>(s.l) * 2,
                           static_cast<cuuint64_t>(s.h) * 2,
                           static_cast<cuuint64_t>(s.b) * 2};
  for (int i = 0; i < 3; ++i) {
    if (strides[i] != 0) continue;
    if (dims[i + 1] != 1) return cudaErrorInvalidValue;
    strides[i] = 16;
  }
  const cuuint32_t box[4] = {kBoxCols, static_cast<cuuint32_t>(box_rows), 1,
                             1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const Params& p, int B, int Hq, int Hkv,
                         cudaStream_t stream) {
  constexpr int BK = WgLayout<D>::kBK;
  CUtensorMap tq, tk, tv;
  cudaError_t err = encode_bhld(&tq, q, D, p.L, Hq, B, p.sq, kWgBlockQ);
  if (err == cudaSuccess)
    err = encode_bhld(&tk, k, D, p.L, Hkv, B, p.sk, BK);
  if (err == cudaSuccess)
    err = encode_bhld(&tv, v, D, p.L, Hkv, B, p.sv, BK);
  if (err != cudaSuccess) return err;
  WgParams wp;
  wp.o = p.o;
  wp.so = p.so;
  wp.L = p.L;
  wp.group = p.group;
  wp.causal = p.causal;
  wp.window = p.window;
  wp.scale_log2 = p.scale * 1.4426950408889634f;
  const int smem = WgLayout<D>::kSmemBytes;
  err = cudaFuncSetAttribute(flash_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hq, B, (p.L + kWgBlockQ - 1) / kWgBlockQ);
  flash_wgmma_kernel<D><<<grid, WgLayout<D>::kThreads, smem, stream>>>(
      tq, tk, tv, wp);
  return cudaGetLastError();
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
cudaError_t dispatch_f32(const Params& p, int B, int Hq,
                         cudaStream_t stream) {
  using Lay = F32Layout<D>;
  const dim3 grid(Hq, B, (p.L + Lay::kBQ - 1) / Lay::kBQ);
  return launch(flash_3xtf32_kernel<D>, Lay::kSmemBytes, grid, Lay::kThreads,
                p, stream);
}

template <int D>
cudaError_t dispatch_mma(dim3 grid, const Params& p, cudaStream_t stream) {
  return launch(flash_bf16_kernel<D>, bf16_smem_bytes<D>(), grid,
                kBf16Threads, p, stream);
}

}  // namespace

// q, k, v, o: device pointers; element strides (batch, head, row) of each,
// the head dim D contiguous.  route: 0 float32 in 3xTF32 on the tensor
// cores (D 16, 32, 64, 128 or 256), 1 bfloat16 through mma.sync (D 16 or
// 32), 2 bfloat16 through wgmma and TMA (D 64, 128 or 256); any other
// pairing is refused, and so is a stride of 0 on a dim of size > 1 on
// route 2.  Returns a cudaError_t (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int route, int B,
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
  cudaError_t err = cudaErrorInvalidValue;
  if (route == 0) {
    switch (D) {
      case 16: err = dispatch_f32<16>(p, B, Hq, s); break;
      case 32: err = dispatch_f32<32>(p, B, Hq, s); break;
      case 64: err = dispatch_f32<64>(p, B, Hq, s); break;
      case 128: err = dispatch_f32<128>(p, B, Hq, s); break;
      case 256: err = dispatch_f32<256>(p, B, Hq, s); break;
      default: break;
    }
  } else if (route == 1) {
    switch (D) {
      case 16: err = dispatch_mma<16>(grid, p, s); break;
      case 32: err = dispatch_mma<32>(grid, p, s); break;
      default: break;
    }
  } else if (route == 2) {
    switch (D) {
      case 64: err = launch_wgmma<64>(q, k, v, p, B, Hq, Hkv, s); break;
      case 128: err = launch_wgmma<128>(q, k, v, p, B, Hq, Hkv, s); break;
      case 256: err = launch_wgmma<256>(q, k, v, p, B, Hq, Hkv, s); break;
      default: break;
    }
  }
  return static_cast<int>(err);
}

// Dynamic shared memory a CTA of the route's kernel takes at head dim D, in
// bytes (0 for a pairing the entry point refuses).
extern "C" int flash_attention_smem_bytes(int route, int D) {
  switch (route * 1000 + D) {
    case 16: return F32Layout<16>::kSmemBytes;
    case 32: return F32Layout<32>::kSmemBytes;
    case 64: return F32Layout<64>::kSmemBytes;
    case 128: return F32Layout<128>::kSmemBytes;
    case 256: return F32Layout<256>::kSmemBytes;
    case 1016: return bf16_smem_bytes<16>();
    case 1032: return bf16_smem_bytes<32>();
    case 2064: return WgLayout<64>::kSmemBytes;
    case 2128: return WgLayout<128>::kSmemBytes;
    case 2256: return WgLayout<256>::kSmemBytes;
    default: return 0;
  }
}
