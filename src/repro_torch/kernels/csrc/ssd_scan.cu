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
// All f32, on the CUDA cores: TF32 would change the numbers the model's
// tests hold.
//
// What bounds it: operations.  At mamba2-370m's scoring shape (B 2, 16
// chunks of Q 256, H 32, P 64, N 128) it moves ~178 MB (53 us at 3.35 TB/s)
// but does ~9 GFLOP over the (i, j <= i) pairs it needs (0.13 ms at
// 67 TFLOP/s f32); the TPU kernel computes all (i, j) pairs, 13.4 GFLOP.
//
// Design:
// * The TPU kernel keeps the whole [H, Q, Q] decay matrix in VMEM: 8.4 MB a
//   chunk at these sizes, far over the 227 KB of shared memory.  Here it is
//   never materialised: a CTA makes one [64, 64] tile of it for one head at
//   a time, in shared memory, and only for j <= i (entries above the
//   diagonal are written as 0 without computing exp of a positive
//   difference; key tiles right of the query tile are skipped).
// * Two kinds of CTA in one launch, chosen by blockIdx:
//   - y CTAs, one per (chunk, 64 query rows, group of 8 heads).  The scores
//     c_i . b_j are the same for every head (b and c are shared, G = 1), so
//     a CTA computes its [64, <= Q] score rows once, keeps them in shared
//     memory (64 KB at Q 256) and reuses them for its 8 heads; per head and
//     key tile it builds W[i, j] = S[i, j] * exp(cum_i - cum_j) * dt_j and
//     accumulates y += W . x on 4 x 4 register tiles.  Heaviest query tiles
//     (the most key tiles) are launched first.
//   - state CTAs, one per (chunk, head): the [P, N] product over the Q
//     positions of (x * dt * exp(cum_end - cum)) and b, staged 32 positions
//     at a time, plus in_decay and chunk_decay.
// * cum is a serial f32 sum in position order, done by one thread per head
//   in every CTA that needs it (the same code, so y and state CTAs see the
//   same bits); da is rounded before it is added, as jnp.cumsum(dt * a).
// * ~113 KB of dynamic shared memory at Q 256, so two CTAs fit on an SM.
// * The C entry point validates its arguments and returns
//   cudaGetLastError(); it launches on the caller's stream and allocates
//   nothing.

#include <cstdint>
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQT = 64;    // query rows of a y CTA
constexpr int kJT = 64;    // key positions per step of a y CTA
constexpr int kNK = 32;    // state-dim slice per step of the score product
constexpr int kHG = 8;     // heads per y CTA
constexpr int kSJ = 32;    // positions per step of a state CTA
constexpr int kMaxQ = 256;
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;

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
  int n_qt, n_hg;     // query tiles, head groups
};

// cum[j] = sum_{m <= j} dt_m * a_h in position order (each product rounded
// before it is added); sdt[j] = dt_j.  One thread.
__device__ void prefix_sum(const float* __restrict__ dt_bz, float a_h, int H,
                           int h, int len, float* cum, float* sdt) {
  float acc = 0.0f;
  for (int j = 0; j < len; ++j) {
    const float d = dt_bz[static_cast<int64_t>(j) * H + h];
    acc = __fadd_rn(acc, __fmul_rn(d, a_h));
    cum[j] = acc;
    sdt[j] = d;
  }
}

__device__ void y_tile(const Args& g, int64_t bz, int tile, int grp,
                       float* smem) {
  const int Q = g.Q, H = g.H, P = g.P, N = g.N;
  const int i0 = tile * kQT;
  const int jend = min(Q, i0 + kQT);            // keys [0, jend) are needed
  const int h0 = grp * kHG;
  const int nh = min(kHG, H - h0);
  float* s_cum = smem;                          // [kHG][Q]
  float* s_dt = s_cum + kHG * Q;                // [kHG][Q]
  float* s_S = s_dt + kHG * Q;                  // [kQT][Q] scores
  float* s_c = s_S + kQT * Q;                   // [kQT][kNK + 1]  phase 1
  float* s_b = s_c + kQT * (kNK + 1);           // [kJT][kNK + 1]  phase 1
  float* s_W = s_c;                             // [kQT][kJT + 1]  phase 2
  float* s_x = s_W + kQT * (kJT + 1);           // [kJT][kMaxP]    phase 2
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const float* dt_bz = g.dt + bz * Q * H;
  if (tid < nh)
    prefix_sum(dt_bz, g.a[h0 + tid], H, h0 + tid, jend, s_cum + tid * Q,
               s_dt + tid * Q);

  // phase 1: S[i][j] = c_i . b_j for the tile's rows and every j < jend
  const float* c_bz = g.c + bz * Q * N;
  const float* b_bz = g.b + bz * Q * N;
  for (int j0 = 0; j0 < jend; j0 += kJT) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < N; k0 += kNK) {
      for (int e = tid; e < kQT * kNK; e += kThreads) {
        const int r = e / kNK, k = e % kNK, gk = k0 + k;
        const int gi = i0 + r, gj = j0 + r;
        s_c[r * (kNK + 1) + k] =
            (gi < Q && gk < N) ? c_bz[static_cast<int64_t>(gi) * N + gk] : 0.0f;
        s_b[r * (kNK + 1) + k] =
            (gj < Q && gk < N) ? b_bz[static_cast<int64_t>(gj) * N + gk] : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < kNK; ++k) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = s_c[(ty + 16 * r) * (kNK + 1) + k];
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[q] = s_b[(tx + 16 * q) * (kNK + 1) + k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(cv[r], bv[q], acc[r][q]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + tx + 16 * q;
        if (j < jend) s_S[(ty + 16 * r) * Q + j] = acc[r][q];
      }
  }
  __syncthreads();

  // phase 2: per head, y[i, :] = sum_{j <= i} W[i, j] * x_j
  const float* x_bz = g.x + bz * Q * H * P;
  float* y_bz = g.y + bz * Q * H * P;
  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    const float* cum = s_cum + hh * Q;
    const float* sdt = s_dt + hh * Q;
    float acc[4][4] = {};
    for (int j0 = 0; j0 < jend; j0 += kJT) {
      for (int e = tid; e < kQT * kJT; e += kThreads) {
        const int r = e / kJT, jj = e % kJT;
        const int gi = i0 + r, gj = j0 + jj;
        float w = 0.0f;
        if (gj <= gi && gi < Q)       // j <= i only: cum_i - cum_j <= 0
          w = s_S[r * Q + gj] * expf(cum[gi] - cum[gj]) * sdt[gj];
        s_W[r * (kJT + 1) + jj] = w;
      }
      for (int e = tid; e < kJT * P; e += kThreads) {
        const int jj = e / P, p = e % P, gj = j0 + jj;
        s_x[jj * kMaxP + p] =
            gj < Q ? x_bz[(static_cast<int64_t>(gj) * H + h) * P + p] : 0.0f;
      }
      __syncthreads();
      const int jn = min(kJT, jend - j0);
#pragma unroll 4
      for (int jj = 0; jj < jn; ++jj) {
        float wv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) wv[r] = s_W[(ty + 16 * r) * (kJT + 1) + jj];
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = s_x[jj * kMaxP + tx + 16 * q];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(wv[r], xv[q], acc[r][q]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int i = i0 + ty + 16 * r, p = tx + 16 * q;
        if (i < Q && p < P)
          y_bz[(static_cast<int64_t>(i) * H + h) * P + p] = acc[r][q];
      }
  }
}

__device__ void state_tile(const Args& g, int64_t bz, int h, float* smem) {
  const int Q = g.Q, H = g.H, P = g.P, N = g.N;
  float* s_cum = smem;                 // [Q]
  float* s_w = s_cum + Q;              // [Q]: dt, then dt * exp(cum_end - cum)
  float* s_u = s_w + Q;                // [kSJ][kMaxP]
  float* s_b = s_u + kSJ * kMaxP;      // [kSJ][kMaxN]
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;

  if (tid == 0)
    prefix_sum(g.dt + bz * Q * H, g.a[h], H, h, Q, s_cum, s_w);
  __syncthreads();
  const float cend = s_cum[Q - 1];
  float* indec = g.indec + (bz * H + h) * Q;
  for (int j = tid; j < Q; j += kThreads) {
    indec[j] = expf(s_cum[j]);
    s_w[j] = s_w[j] * expf(cend - s_cum[j]);
  }
  if (tid == 0) g.dec[bz * H + h] = expf(cend);
  __syncthreads();

  const float* x_bz = g.x + bz * Q * H * P;
  const float* b_bz = g.b + bz * Q * N;
  float acc[8][4] = {};                // p = ty + 8 r, n = tx + 32 q
  for (int j0 = 0; j0 < Q; j0 += kSJ) {
    for (int e = tid; e < kSJ * P; e += kThreads) {
      const int jj = e / P, p = e % P, gj = j0 + jj;
      s_u[jj * kMaxP + p] =
          gj < Q ? x_bz[(static_cast<int64_t>(gj) * H + h) * P + p] * s_w[gj]
                 : 0.0f;
    }
    for (int e = tid; e < kSJ * N; e += kThreads) {
      const int jj = e / N, n = e % N, gj = j0 + jj;
      s_b[jj * kMaxN + n] =
          gj < Q ? b_bz[static_cast<int64_t>(gj) * N + n] : 0.0f;
    }
    __syncthreads();
    const int jn = min(kSJ, Q - j0);
#pragma unroll 4
    for (int jj = 0; jj < jn; ++jj) {
      float uv[8], bv[4];
#pragma unroll
      for (int r = 0; r < 8; ++r) uv[r] = s_u[jj * kMaxP + ty + 8 * r];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = s_b[jj * kMaxN + tx + 32 * q];
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(uv[r], bv[q], acc[r][q]);
    }
    __syncthreads();
  }
  float* st = g.st + (bz * H + h) * static_cast<int64_t>(P) * N;
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int p = ty + 8 * r, n = tx + 32 * q;
      if (p < P && n < N) st[static_cast<int64_t>(p) * N + n] = acc[r][q];
    }
}

__global__ void __launch_bounds__(kThreads, 2) ssd_chunk_kernel(Args g) {
  extern __shared__ float smem[];
  // role-major order: every chunk's heaviest y tiles go out first
  const int role = static_cast<int>(blockIdx.x / g.bnc);
  const int64_t bz = blockIdx.x % g.bnc;
  const int n_y = g.n_qt * g.n_hg;
  if (role < n_y)
    y_tile(g, bz, g.n_qt - 1 - role / g.n_hg, role % g.n_hg, smem);
  else
    state_tile(g, bz, role - n_y, smem);
}

size_t smem_bytes(int Q) {
  const size_t y = 2 * kHG * Q + kQT * Q +
                   (kQT * (kJT + 1) + kJT * kMaxP > 2 * kQT * (kNK + 1)
                        ? kQT * (kJT + 1) + kJT * kMaxP
                        : 2 * kQT * (kNK + 1));
  const size_t s = 2 * Q + kSJ * kMaxP + kSJ * kMaxN;
  return 4 * (y > s ? y : s);
}

}  // namespace

// x [BNC, Q, H, P], dt [BNC, Q, H], a [H], b/c [BNC, Q, N] in; y [BNC, Q, H,
// P], st [BNC, H, P, N], dec [BNC, H], indec [BNC, H, Q] out; all
// contiguous f32 on the current device (BNC = batch * chunks).  Takes
// Q <= 256, P <= 64, N <= 128.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int ssd_chunk_f32(const float* x, const float* dt, const float* a,
                             const float* b, const float* c, float* y,
                             float* st, float* dec, float* indec, int64_t bnc,
                             int Q, int H, int P, int N, void* stream) {
  if (bnc <= 0 || Q <= 0 || Q > kMaxQ || H <= 0 || P <= 0 || P > kMaxP ||
      N <= 0 || N > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  Args g{x, dt, a, b, c, y, st, dec, indec, bnc, Q, H, P, N,
         (Q + kQT - 1) / kQT, (H + kHG - 1) / kHG};
  const int64_t blocks = static_cast<int64_t>(g.n_qt * g.n_hg + H) * bnc;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_chunk_kernel<<<static_cast<unsigned>(blocks), kThreads, bytes,
                     static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}
