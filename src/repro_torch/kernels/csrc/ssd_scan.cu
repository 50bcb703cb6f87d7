// Mamba-2 SSD chunk-local terms, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::ssd_chunk_pallas
// (Pallas body _ssd_kernel).  Per (batch, chunk), with da = dt * a and
// cum = cumsum(da) over the chunk's Q positions, for every head h:
//
//   y_intra[i, h, :] = sum_{j <= i} (c_i . b_j) * exp(cum_i - cum_j) * dt_j * x_j[h, :]
//   state[h, p, n]   = sum_j b_j[n] * exp(cum_end - cum_j) * dt_j * x_j[h, p]
//   chunk_decay[h]   = exp(cum_end)
//   in_decay[h, i]   = exp(cum_i)
//
// f32 in and out.  The three products run on the tensor cores in 3xTF32:
// each operand v is split into hi (v with its low 13 mantissa bits cleared,
// a TF32 value) and lo = v - hi (exact), and mma.sync m16n8k8 (tf32 in,
// f32 accumulate) adds lo*hi + hi*lo + hi*hi into three separate f32 sums,
// which keeps about 21 bits of each operand.  A single TF32 pass (10 bits)
// is not enough: mamba2 at random init is chaotic, and its scoring checks
// hold f32 logits to 2e-2.  The split is a mask and a subtraction, not
// cvt.rna.tf32.f32, which runs on a slower pipe and, two a fragment value,
// was the largest single cost of the first 3xTF32 version.
//
// What bounds it: operations, just.  At mamba2-370m's scoring shape (B 2,
// 16 chunks of Q 256, H 32, P 64, N 128) it moves ~178 MB (53 us at 3.35
// TB/s) and does ~9 GFLOP over the (i, j <= i) pairs it needs (the TPU
// kernel computes all (i, j) pairs, 13.6 GFLOP), 8.9 of them in the three
// products.  3xTF32 issues three TF32 products for each f32 one (~14 M
// mma.sync at this shape): 26.6 TFLOP of TF32, 54 us at the 495 TFLOP/s
// of the tensor cores.  Around them the CUDA cores build the decay weights
// (one ex2 an (i, j <= i, h)) and split every fragment.
// What holds it at ~6x the bound: the loops are bound by latency and
// instruction issue around mma.sync (16 warps an SM, ~50-100 instructions
// a k-step for 12 products; with the products taken out the kernel ran
// barely faster), and the y CTAs re-read x once per query tile.  wgmma
// (TF32 takes K-major operands only, so x and the state's operands would
// be transposed in shared memory) is the next step.
//
// Design:
// * The TPU kernel keeps the whole [H, Q, Q] decay matrix in VMEM: 8.4 MB a
//   chunk at these sizes, far over the 227 KB of shared memory.  Here it is
//   never materialised: each weight W[i, j] = S[i, j] * exp(cum_i - cum_j) *
//   dt_j is made in registers, straight into the A fragment of the
//   tensor-core product, only for j <= i (the mask comes before the
//   exponent, so exp is never taken of a positive difference), with
//   ex2.approx of (cum_i - cum_j) * log2(e) (the difference first: at
//   |cum| ~ 3,300 a pre-scaled cum would round the exponent by 2.4e-4).
// * Two kinds of CTA in one launch, 512 threads (16 warps) each, one CTA an
//   SM; blockIdx picks the role, heaviest first: the y CTAs of the upper
//   half of the query tiles, then the state CTAs, then the other y CTAs.
//   - y CTAs, one per (chunk, 64 query rows, group of 16 heads).  The
//     scores c_i . b_j are the same for every head (G = 1), so the CTA
//     computes its [64, <= Q] score rows once (3xTF32, K = N; a warp a
//     16 x 16 block, blocks right of the diagonal skipped; b tiles through
//     a 2-stage cp.async ring), keeps them in shared memory and reuses
//     them for its 16 heads.  Then two heads at a time, over the key tiles
//     of 64 up to the diagonal: a warp takes 16 rows of one head and 32 of
//     its P columns, builds its W fragments and adds W . x (K = keys; the
//     diagonal tile stops at the warp's last row).  x tiles come through a
//     3-stage cp.async ring, so the next two (head pair, key tile) items
//     load while this one multiplies.  16 heads and not 8: the score rows
//     are made twice a query tile instead of four times; not 32: 64 y
//     CTAs of 1 to 4 units of work would not fill 132 SMs.
//   - state CTAs, one per (chunk, group of 4 heads): the chunk's whole b
//     [Q, N] is loaded into shared memory once for the 4 heads, and x
//     streams through a 2-stage ring of 128 positions, (head, stage)
//     items one after another; st[p, n] = sum_j u[j, p] b[j, n] with
//     u = x * dt * exp(cum_end - cum) applied as the A fragments are built
//     (3xTF32, K = positions; a warp a 16 x 32 block); plus in_decay and
//     chunk_decay (expf).  The first design, a CTA a head, read b 32 times
//     a chunk.
//   Every ring waits, meets at one barrier, then refills the stage the
//   previous item used: one barrier an item.
// * cum: dt for the CTA's heads is read into shared memory with coalesced
//   loads (the first operand tiles are already in flight); then one warp a
//   head scans it: each lane sums its run of ceil(Q/32) positions in
//   order, the lanes' totals go through a fixed shuffle scan, and each lane
//   adds its run onto the total of the lanes before it.  da is rounded
//   before it is added, as jnp.cumsum(dt * a).  The same code in both kinds
//   of CTA, so y and state CTAs of one chunk see the same cum bits.
// * Operands reach shared memory by cp.async (16-byte copies where P and N
//   are multiples of 4 and the pointers 16-byte aligned, as at every model
//   shape; 4-byte copies otherwise, in a second instance of the kernel),
//   zero-filled past Q, P and N up to the MMA's multiples (whole 32-column
//   blocks for the products' n side, so that no n-block needs a branch),
//   so ragged Q, P, N and H need no other path.  Row strides are padded
//   (4 or 8 floats mod 32) so that every fragment read hits 32 banks.
// * Shared memory a CTA (dynamic, the larger of the two roles): at Q 256,
//   P 64, N 128, 221,184 B (the state CTA: b 139,264 B, the x ring
//   73,728 B); a y CTA takes 209,920 B (cum and dt 32,768 B, scores
//   66,560 B, then the score operands or the x ring 110,592 B).  128
//   registers a thread (the cap of a 512-thread CTA), no spills
//   (chip_smoke.py prints ptxas's report).
// * The C entry point validates its arguments and returns
//   cudaGetLastError(); it launches on the caller's stream and allocates
//   nothing.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;   // 16 warps
constexpr int kQT = 64;    // query rows of a y CTA
constexpr int kJT = 64;    // keys a tile of a y CTA
constexpr int kHG = 16;    // heads a y CTA
constexpr int kYRing = 3;  // stages of the y CTA's x ring
constexpr int kSH = 4;     // heads a state CTA
constexpr int kSJ = 128;   // positions a stage of a state CTA
constexpr int kSRing = 2;  // stages of the state CTA's x ring
constexpr int kMaxQ = 256;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

struct Args {
  const float* x;     // [BNC, Q, H, P]
  const float* dt;    // [BNC, Q, H]
  const float* a;     // [H]
  const float* b;     // [BNC, Q, N]
  const float* c;     // [BNC, Q, N]
  float* y;           // [BNC, Q, H, P]
  float* st;          // [BNC, H, P, N]
  float* dec;         // [BNC, H]
  float* indec;       // [BNC, H, Q]
  int64_t bnc;
  int Q, H, P, N;
  int n_qt, n_hg;     // query tiles, head groups of the y CTAs
  int n_sg;           // head groups of the state CTAs
};

// Shared-memory geometry, in floats
struct Layout {
  int Qp;    // cum / dt rows
  int ldS;   // score rows: 4 mod 32
  int ldK;   // score operands c, b [row][n]: 4 mod 32
  int ldX;   // x [key][p]: 8 mod 32
  int ldB;   // state's b [position][n]: 8 mod 32
  __host__ __device__ Layout(int Q, int P, int N)
      : Qp(round_up(Q, 32)), ldS(round_up(Q, 64) + 4),
        ldK(round_up(N, 32) + 4), ldX(round_up(P, 32) + 8),
        ldB(round_up(N, 32) + 8) {}
  __host__ __device__ int y_floats() const {
    const int ops = 3 * kQT * ldK, ring = kYRing * 2 * kJT * ldX;
    return 2 * kHG * Qp + kQT * ldS + (ops > ring ? ops : ring);
  }
  __host__ __device__ int state_floats() const {
    return 2 * kSH * Qp + Qp * ldB + kSRing * kSJ * ldX;
  }
};

// ---------------------------------------------------------------- copies --

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
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

// dst[r][0..fill) = src[r * stride + 0..len) for r < rows_valid, zeros past
// len and for rows_valid <= r < nrows, in 16-byte copies (V16) or 4-byte
// ones.  Every thread of the CTA calls it.  V16 is a template parameter so
// that a kernel carries one copy path: the other one's code alone cost 5%
// at the scoring shape (instruction cache).
template <bool V16>
__device__ void stage(float* dst, int ld, const float* src, int64_t stride,
                      int nrows, int rows_valid, int len, int fill) {
  if constexpr (V16) {
    const int cpr = fill / 4;
    for (int e = threadIdx.x; e < nrows * cpr; e += kThreads) {
      const int r = e / cpr, q = (e % cpr) * 4;
      const bool ok = r < rows_valid && q < len;
      cp_async16(dst + r * ld + q, ok ? src + r * stride + q : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < nrows * fill; e += kThreads) {
      const int r = e / fill, q = e % fill;
      const bool ok = r < rows_valid && q < len;
      cp_async4(dst + r * ld + q, ok ? src + r * stride + q : src,
                ok ? 4 : 0);
    }
  }
}

// ------------------------------------------------------------ 3xTF32 MMA --

// hi = v with its low 13 mantissa bits cleared (a TF32 value), lo = v - hi
// (exact in f32); the tensor core reads lo's top 10 mantissa bits.  Two
// full-rate ALU operations, where cvt.rna.tf32.f32 runs on a slower pipe.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d += a (16x8, row) * b (8x8, col); fragments as CUTLASS's
// SM80_16x8x8_F32TF32TF32F32_TN: with g = lane / 4, t = lane % 4,
// a = (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4); b = (k t, n g),
// (k t + 4, n g); d = (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A 3xTF32 accumulator: hi * hi and the two cross terms in three separate
// f32 sums, so the three products of a step do not wait on each other
struct Acc3 {
  float hh[4], lh[4], hl[4];
  __device__ void zero() {
#pragma unroll
    for (int e = 0; e < 4; ++e) hh[e] = lh[e] = hl[e] = 0.0f;
  }
  __device__ float get(int e) const { return hh[e] + (lh[e] + hl[e]); }
};

__device__ __forceinline__ void mma3(Acc3& d, const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b0, bh0, bl0);
  split(b1, bh1, bl1);
  mma_tf32(d.lh, al, bh0, bh1);
  mma_tf32(d.hl, ah, bl0, bl1);
  mma_tf32(d.hh, ah, bh0, bh1);
}

__device__ __forceinline__ float ex2(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(r) : "f"(v));
  return r;
}

// ------------------------------------------------------------------- cum --

// cum[j] = sum_{m <= j} dt[m] * a for j < Q (dt, cum in shared memory), by
// one whole warp: lane l sums its run of L = ceil(Q / 32) positions in
// order, the lanes' totals go through a fixed shuffle scan, and each lane
// adds its run, in order, onto the total of the lanes before it.
__device__ void warp_cumsum(const float* dt, float a, int Q, float* cum) {
  const int lane = threadIdx.x & 31;
  const int L = (Q + 31) >> 5, j0 = lane * L;
  float tot = 0.0f;
  for (int m = 0; m < L; ++m)
    if (j0 + m < Q) tot = __fadd_rn(tot, __fmul_rn(dt[j0 + m], a));
  float inc = tot;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc = __fadd_rn(o, inc);
  }
  float acc = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) acc = 0.0f;
  for (int m = 0; m < L; ++m)
    if (j0 + m < Q) {
      acc = __fadd_rn(acc, __fmul_rn(dt[j0 + m], a));
      cum[j0 + m] = acc;
    }
}

// ------------------------------------------------------------- y CTAs --

template <bool V16>
__device__ void y_tile(const Args& g, int64_t bz, int qt, int grp,
                       float* smem) {
  const int Q = g.Q, H = g.H, P = g.P, N = g.N;
  const Layout lay(Q, P, N);
  const int i0 = qt * kQT;
  const int nkt = (min(Q, i0 + kQT) + kJT - 1) / kJT;   // key tiles: qt + 1
  const int h0 = grp * kHG;
  const int nh = min(kHG, H - h0);
  float* s_cum = smem;                          // [kHG][Qp]
  float* s_dt = s_cum + kHG * lay.Qp;           // [kHG][Qp]
  float* s_S = s_dt + kHG * lay.Qp;             // [kQT][ldS] scores
  float* s_c = s_S + kQT * lay.ldS;             // [kQT][ldK]     phase 1
  float* s_b = s_c + kQT * lay.ldK;             // [2][kJT][ldK]  phase 1
  float* s_x = s_c;                    // [kYRing][2][kJT][ldX]   phase 2
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int r0 = (warp & 3) * 16;               // the warp's rows in the tile
  const int N8 = round_up(N, 8);

  const float* c_bz = g.c + bz * Q * N;
  const float* b_bz = g.b + bz * Q * N;
  stage<V16>(s_c, lay.ldK, c_bz + static_cast<int64_t>(i0) * N, N, kQT,
             Q - i0, N, N8);
  stage<V16>(s_b, lay.ldK, b_bz, N, kJT, Q, N, N8);
  cp_async_commit();

  // dt of the group's heads (coalesced), then one warp a head scans cum
  const float* dt_bz = g.dt + bz * Q * H;
  for (int e = tid; e < Q * nh; e += kThreads) {
    const int j = e / nh, hh = e % nh;
    s_dt[hh * lay.Qp + j] = dt_bz[static_cast<int64_t>(j) * H + h0 + hh];
  }
  __syncthreads();
  if (warp < nh)
    warp_cumsum(s_dt + warp * lay.Qp, g.a[h0 + warp], Q,
                s_cum + warp * lay.Qp);

  // phase 1: S[i][j] = c_i . b_j for the tile's rows and keys up to the
  // diagonal; a warp takes rows r0 .. r0 + 15, keys c0 .. c0 + 15 of a tile
  // b tiles through a 2-stage ring
  const int c0 = (warp >> 2) * 16;
  const int nks_n = N8 / 8;
  for (int kt = 0; kt < nkt; ++kt) {
    const int j0 = kt * kJT;
    cp_async_wait<0>();                         // b tile kt has landed
    __syncthreads();
    if (kt + 1 < nkt)
      stage<V16>(s_b + ((kt + 1) & 1) * kJT * lay.ldK, lay.ldK,
                 b_bz + static_cast<int64_t>(j0 + kJT) * N, N, kJT,
                 Q - j0 - kJT, N, N8);
    cp_async_commit();
    const float* sbt = s_b + (kt & 1) * kJT * lay.ldK;
    if (j0 + c0 <= i0 + r0 + 15) {              // not wholly right of j = i
      Acc3 acc[2];
      acc[0].zero();
      acc[1].zero();
      for (int ks = 0; ks < nks_n; ++ks) {
        const float* ca = s_c + (r0 + gq) * lay.ldK + ks * 8 + tq;
        uint32_t ah[4], al[4];
        split(ca[0], ah[0], al[0]);
        split(ca[8 * lay.ldK], ah[1], al[1]);
        split(ca[4], ah[2], al[2]);
        split(ca[8 * lay.ldK + 4], ah[3], al[3]);
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          const float* bb = sbt + (c0 + nb * 8 + gq) * lay.ldK + ks * 8 + tq;
          mma3(acc[nb], ah, al, bb[0], bb[4]);
        }
      }
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        float* srow = s_S + (r0 + gq) * lay.ldS + j0 + c0 + nb * 8 + 2 * tq;
        srow[0] = acc[nb].get(0);
        srow[1] = acc[nb].get(1);
        srow[8 * lay.ldS] = acc[nb].get(2);
        srow[8 * lay.ldS + 1] = acc[nb].get(3);
      }
    }
  }
  __syncthreads();            // s_S and cum complete, the region free

  // phase 2: two heads at a time, y[i, :] = sum_{j <= i} W[i, j] x_j; a
  // warp takes rows r0 .. r0 + 15 of head hs of the pair, columns
  // pc .. pc + 31
  const float* x_bz = g.x + bz * Q * H * P;
  float* y_bz = g.y + bz * Q * H * P;
  const int n_pairs = (nh + 1) / 2, items = n_pairs * nkt;
  const int hs = (warp >> 2) & 1, pc = (warp >> 3) * 32;
  const int P32 = round_up(P, 32);              // x tiles zero-filled to it
  auto issue = [&](int t) {
    if (t < items) {
      const int hp = t / nkt, j0 = (t % nkt) * kJT, st = t % kYRing;
      for (int s = 0; s < 2; ++s) {
        const int hh = 2 * hp + s;
        stage<V16>(s_x + (st * 2 + s) * kJT * lay.ldX, lay.ldX,
                   x_bz + (static_cast<int64_t>(j0) * H + h0 +
                           min(hh, nh - 1)) * P,
                   static_cast<int64_t>(H) * P, kJT, hh < nh ? Q - j0 : 0, P,
                   P32);
      }
    }
    cp_async_commit();
  };
  for (int t = 0; t < kYRing - 1; ++t) issue(t);
  const int ia = i0 + r0 + gq, ib = ia + 8;     // the lane's two rows
  Acc3 acc[4];
  for (int t = 0; t < items; ++t) {
    const int hh = 2 * (t / nkt) + hs, kt = t % nkt, j0 = kt * kJT;
    cp_async_wait<kYRing - 2>();    // item t has landed
    __syncthreads();                // ... for every thread, and every warp
    issue(t + kYRing - 1);          // is done with the stage this refills
    if (kt == 0) {
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) acc[nb].zero();
    }
    if (hh < nh && pc < P) {
      const float* cum = s_cum + hh * lay.Qp;
      const float* dtv = s_dt + hh * lay.Qp;
      const float ca = cum[min(ia, Q - 1)], cb = cum[min(ib, Q - 1)];
      const float* sa = s_S + (ia - i0) * lay.ldS;
      const float* sb = sa + 8 * lay.ldS;
      // keys this warp needs here: j <= its last row, j < Q
      const int jlim = min(min(Q, i0 + r0 + 16), j0 + kJT);
      const int nks = (jlim - j0 + 7) / 8;
      const float* xs = s_x + ((t % kYRing) * 2 + hs) * kJT * lay.ldX + pc;
      for (int ks = 0; ks < nks; ++ks) {
        const int ja = j0 + ks * 8 + tq, jb = ja + 4;
        const float cja = cum[ja], cjb = cum[jb];
        const float dja = dtv[ja], djb = dtv[jb];
        float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (ja <= ia && ia < Q) w[0] = sa[ja] * ex2((ca - cja) * kLog2e) * dja;
        if (ja <= ib && ib < Q) w[1] = sb[ja] * ex2((cb - cja) * kLog2e) * dja;
        if (jb <= ia && ia < Q) w[2] = sa[jb] * ex2((ca - cjb) * kLog2e) * djb;
        if (jb <= ib && ib < Q) w[3] = sb[jb] * ex2((cb - cjb) * kLog2e) * djb;
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split(w[e], ah[e], al[e]);
        const float* xr = xs + (ks * 8 + tq) * lay.ldX + gq;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
          mma3(acc[nb], ah, al, xr[nb * 8], xr[4 * lay.ldX + nb * 8]);
      }
      if (kt == nkt - 1) {
        const int h = h0 + hh;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const int p = pc + nb * 8 + 2 * tq;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = half ? ib : ia;
            if (i >= Q) continue;
            float* yr = y_bz + (static_cast<int64_t>(i) * H + h) * P;
            if (p < P) yr[p] = acc[nb].get(2 * half);
            if (p + 1 < P) yr[p + 1] = acc[nb].get(2 * half + 1);
          }
        }
      }
    }
  }
}

// --------------------------------------------------------- state CTAs --

template <bool V16>
__device__ void state_tile(const Args& g, int64_t bz, int grp, float* smem) {
  const int Q = g.Q, H = g.H, P = g.P, N = g.N;
  const Layout lay(Q, P, N);
  const int h0 = grp * kSH;
  const int nh = min(kSH, H - h0);
  float* s_cum = smem;                          // [kSH][Qp]
  float* s_w = s_cum + kSH * lay.Qp;            // [kSH][Qp]: dt, then weight
  float* s_b = s_w + kSH * lay.Qp;              // [Qp][ldB]: the chunk's b
  float* s_x = s_b + lay.Qp * lay.ldB;          // [kSRing][kSJ][ldX]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  // operand tiles zero-filled to whole 32-column blocks, so that every
  // warp's n-blocks run without a branch
  const int N32 = round_up(N, 32), P32 = round_up(P, 32);
  const int n_st = (Q + kSJ - 1) / kSJ, items = nh * n_st;
  const float* x_bz = g.x + bz * Q * H * P;

  // the whole chunk's b, once for the group's heads; then x (head, stage)
  // items through the ring
  stage<V16>(s_b, lay.ldB, g.b + bz * Q * N, N, lay.Qp, Q, N, N32);
  cp_async_commit();
  auto issue = [&](int t) {
    if (t < items) {
      const int hh = t / n_st, j0 = (t % n_st) * kSJ;
      stage<V16>(s_x + (t % kSRing) * kSJ * lay.ldX, lay.ldX,
                 x_bz + (static_cast<int64_t>(j0) * H + h0 + hh) * P,
                 static_cast<int64_t>(H) * P, kSJ, Q - j0, P, P32);
    }
    cp_async_commit();
  };
  for (int t = 0; t < kSRing - 1; ++t) issue(t);

  // dt (coalesced), cum (a warp a head), then the weights
  const float* dt_bz = g.dt + bz * Q * H;
  for (int e = tid; e < lay.Qp * nh; e += kThreads) {
    const int j = e / nh, hh = e % nh;
    s_w[hh * lay.Qp + j] =
        j < Q ? dt_bz[static_cast<int64_t>(j) * H + h0 + hh] : 0.0f;
  }
  __syncthreads();
  if (warp < nh)
    warp_cumsum(s_w + warp * lay.Qp, g.a[h0 + warp], Q,
                s_cum + warp * lay.Qp);
  __syncthreads();
  for (int e = tid; e < Q * nh; e += kThreads) {
    const int hh = e / Q, j = e % Q;
    const float* cum = s_cum + hh * lay.Qp;
    g.indec[(bz * H + h0 + hh) * Q + j] = expf(cum[j]);
    s_w[hh * lay.Qp + j] *= expf(cum[Q - 1] - cum[j]);
  }
  if (tid < nh) g.dec[bz * H + h0 + tid] = expf(s_cum[tid * lay.Qp + Q - 1]);
  // (the first barrier of the loop publishes s_w)

  // st[p, n]: a warp takes p rows p0 .. p0 + 15, n columns n0 .. n0 + 31
  const int p0 = (warp & 3) * 16, n0 = (warp >> 2) * 32;
  const bool active = p0 < P && n0 < N;
  Acc3 acc[4];
  for (int t = 0; t < items; ++t) {
    const int hh = t / n_st, si = t % n_st, j0 = si * kSJ;
    cp_async_wait<kSRing - 2>();    // b and item t have landed
    __syncthreads();
    issue(t + kSRing - 1);          // refills the stage of item t - 1
    if (si == 0) {
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) acc[nb].zero();
    }
    if (active) {
      const float* xs = s_x + (t % kSRing) * kSJ * lay.ldX + p0 + gq;
      const float* bs = s_b + j0 * lay.ldB + n0 + gq;
      const float* wv = s_w + hh * lay.Qp + j0;
      const int nks = (min(kSJ, Q - j0) + 7) / 8;
      for (int ks = 0; ks < nks; ++ks) {
        const int j = ks * 8 + tq;
        const float w0 = wv[j], w1 = wv[j + 4];
        const float* xa = xs + j * lay.ldX;
        uint32_t ah[4], al[4];
        split(xa[0] * w0, ah[0], al[0]);
        split(xa[8] * w0, ah[1], al[1]);
        split(xa[4 * lay.ldX] * w1, ah[2], al[2]);
        split(xa[4 * lay.ldX + 8] * w1, ah[3], al[3]);
        const float* br = bs + j * lay.ldB;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
          mma3(acc[nb], ah, al, br[nb * 8], br[4 * lay.ldB + nb * 8]);
      }
      if (si == n_st - 1) {
        float* st = g.st + (bz * H + h0 + hh) * static_cast<int64_t>(P) * N;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const int n = n0 + nb * 8 + 2 * tq;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int p = p0 + gq + 8 * half;
            if (p >= P) continue;
            float* sr = st + static_cast<int64_t>(p) * N;
            if (n < N) sr[n] = acc[nb].get(2 * half);
            if (n + 1 < N) sr[n + 1] = acc[nb].get(2 * half + 1);
          }
        }
      }
    }
  }
}

template <bool V16>
__global__ void __launch_bounds__(kThreads, 1) ssd_chunk_kernel(Args g) {
  extern __shared__ __align__(16) float smem[];
  // role-major order, heaviest first: the y tiles of the upper half of the
  // chunk (most key tiles), then the state groups, then the other y tiles
  const int role = static_cast<int>(blockIdx.x / g.bnc);
  const int64_t bz = blockIdx.x % g.bnc;
  const int n_hi = (g.n_qt - g.n_qt / 2) * g.n_hg;
  if (role >= n_hi && role < n_hi + g.n_sg) {
    state_tile<V16>(g, bz, role - n_hi, smem);
    return;
  }
  const int r = role < n_hi ? role : role - g.n_sg;
  y_tile<V16>(g, bz, g.n_qt - 1 - r / g.n_hg, r % g.n_hg, smem);
}

size_t smem_bytes(int Q, int P, int N) {
  const Layout lay(Q, P, N);
  const int y = lay.y_floats(), s = lay.state_floats();
  return 4 * static_cast<size_t>(y > s ? y : s);
}

bool valid_shape(int Q, int P, int N) {
  return Q > 0 && Q <= kMaxQ && P > 0 && P <= kMaxP && N > 0 && N <= kMaxN;
}

}  // namespace

// Dynamic shared memory a CTA takes at (Q, P, N); 0 for a shape the kernel
// does not take.
extern "C" int64_t ssd_chunk_smem_bytes(int Q, int P, int N) {
  return valid_shape(Q, P, N) ? static_cast<int64_t>(smem_bytes(Q, P, N)) : 0;
}

// x [BNC, Q, H, P], dt [BNC, Q, H], a [H], b/c [BNC, Q, N] in; y [BNC, Q, H,
// P], st [BNC, H, P, N], dec [BNC, H], indec [BNC, H, Q] out; all
// contiguous f32 on the current device (BNC = batch * chunks).  Takes
// Q <= 256, P <= 64, N <= 128.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int ssd_chunk_f32(const float* x, const float* dt, const float* a,
                             const float* b, const float* c, float* y,
                             float* st, float* dec, float* indec, int64_t bnc,
                             int Q, int H, int P, int N, void* stream) {
  if (bnc <= 0 || H <= 0 || !valid_shape(Q, P, N))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(b) |
        reinterpret_cast<uintptr_t>(c)) & 15) == 0;
  Args g{x, dt, a, b, c, y, st, dec, indec, bnc, Q, H, P, N,
         (Q + kQT - 1) / kQT, (H + kHG - 1) / kHG, (H + kSH - 1) / kSH};
  const bool v16 = aligned && P % 4 == 0 && N % 4 == 0;
  const int64_t blocks =
      static_cast<int64_t>(g.n_qt * g.n_hg + g.n_sg) * bnc;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(Q, P, N);
  void (*kernel)(Args) =
      v16 ? ssd_chunk_kernel<true> : ssd_chunk_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, bytes,
           static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}
