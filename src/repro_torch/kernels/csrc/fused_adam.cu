// Fused Adam update, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/fused_adam.py::fused_adam_flat
// (Pallas body _adam_kernel).  One pass over a flat leaf:
//
//   m' = b1 * m + (1 - b1) * g
//   v' = b2 * v + (1 - b2) * g * g
//   p' = p - lr * (m' / bc1) / (sqrt(v' / bc2) + eps)
//
// with lr, bc1 = 1 - b1^t and bc2 = 1 - b2^t read from a 3-float device
// array (computed on the card, so no step syncs with the host).  p is f32
// or bf16 and is updated in f32, then rounded once (to nearest even); g is
// f32 or bf16 (a bf16 g widens exactly, as the reference's f32 cast of g);
// m and v are f32.  Each product and sum is rounded as the reference
// rounds it (no fused multiply-add contraction), and the division and
// square root are IEEE-correct.
//
// What bounds it: bytes.  About 14 flops an element against 22 to 28
// bytes (read p, m, v, g; write p, m, v): the least time is the bytes over
// 3.35 TB/s, e.g. mamba2-370m's in_proj (215,482,368 elements, bf16 p, f32
// g) 5.17 GB in 1.54 ms.
//
// Design: a grid-stride elementwise pass, 4 consecutive elements a thread
// per step with 16-byte (f32) or 8-byte (bf16) loads when every pointer is
// aligned for them, else one element a thread.  The ragged tail (n not a
// multiple of 4) is masked inside the kernel: no padding copy.
//
// In place (a donated step: po == p, mo == m, vo == v).  The out-of-place
// instance declares p, m and v __restrict__, a promise that passing each
// pointer twice would break.  So the C entry point launches a second
// instance when the outputs are the inputs, kInPlace, whose p, m and v
// carry no __restrict__ (g and the scalars keep theirs: the kernel never
// writes them).  Each element is still read, then written, by one thread,
// in the same order, so the two instances give the same bits; the
// out-of-place instance's qualifiers come from Ptrs<false>, as before.
// Outputs that alias inputs in any other way are refused.  The C entry
// point validates its arguments and returns cudaGetLastError(); it
// launches on the caller's stream and allocates nothing.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void load4(const float* p, float (&o)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  o[0] = t.x; o[1] = t.y; o[2] = t.z; o[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&t.y));
  o[0] = lo.x; o[1] = lo.y; o[2] = hi.x; o[3] = hi.y;
}
__device__ __forceinline__ void store4(float* p, const float (&o)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&o)[4]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(o[2], o[3]);
  uint2 t;
  t.x = *reinterpret_cast<const unsigned*>(&lo);
  t.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = t;
}

struct Hyper {
  float b1, omb1, b2, omb2, eps;   // omb = 1 - b, rounded from double
};

// one element: p, m, v, g in f32 → p', m', v' (p' in f32, rounded later)
__device__ __forceinline__ void adam1(float& p, float& m, float& v, float g,
                                     float lr, float bc1, float bc2,
                                     const Hyper& h) {
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float mh = __fdiv_rn(m, bc1);
  const float vh = __fdiv_rn(v, bc2);
  const float den = __fadd_rn(__fsqrt_rn(vh), h.eps);
  p = __fsub_rn(p, __fdiv_rn(__fmul_rn(lr, mh), den));
}

// the read pointers of p, m and v: __restrict__ out of place; plain in
// place, where each is also the pointer written
template <typename T, bool kInPlace> struct In {
  using type = const T* __restrict__;
};
template <typename T> struct In<T, true> {
  using type = const T*;
};

template <typename TP, typename TG, int V, bool kInPlace>
__global__ void __launch_bounds__(kThreads)
fused_adam_kernel(typename In<TP, kInPlace>::type p,
                  typename In<float, kInPlace>::type m,
                  typename In<float, kInPlace>::type v,
                  const TG* __restrict__ g, TP* po, float* mo, float* vo,
                  int64_t n, const float* __restrict__ scal, Hyper h) {
  const float lr = scal[0], bc1 = scal[1], bc2 = scal[2];
  const int64_t groups = n / V;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       k < groups; k += stride) {
    const int64_t i = k * V;
    float pv[V], mv[V], vv[V], gv[V];
    if constexpr (V == 4) {
      load4(p + i, pv); load4(m + i, mv); load4(v + i, vv); load4(g + i, gv);
    } else {
      pv[0] = to_f32(p[i]); mv[0] = m[i]; vv[0] = v[i]; gv[0] = to_f32(g[i]);
    }
#pragma unroll
    for (int e = 0; e < V; ++e) adam1(pv[e], mv[e], vv[e], gv[e], lr, bc1, bc2, h);
    if constexpr (V == 4) {
      store4(po + i, pv); store4(mo + i, mv); store4(vo + i, vv);
    } else {
      po[i] = from_f32<TP>(pv[0]); mo[i] = mv[0]; vo[i] = vv[0];
    }
  }
  // ragged tail: the last n % V elements, one thread each
  if (V > 1 && blockIdx.x == 0 && threadIdx.x < n - groups * V) {
    const int64_t i = groups * V + threadIdx.x;
    float pe = to_f32(p[i]), me = m[i], ve = v[i];
    adam1(pe, me, ve, to_f32(g[i]), lr, bc1, bc2, h);
    po[i] = from_f32<TP>(pe); mo[i] = me; vo[i] = ve;
  }
}

template <typename TP, typename TG, bool kInPlace>
void launch_as(const void* p, const float* m, const float* v, const void* g,
               void* po, float* mo, float* vo, int64_t n, const float* scal,
               Hyper h, int vec, cudaStream_t s) {
  const int64_t groups = n / vec;
  int64_t blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;     // grid-stride beyond this
  if (blocks < 1) blocks = 1;
  const TP* pp = static_cast<const TP*>(p);
  const TG* gg = static_cast<const TG*>(g);
  TP* pop = static_cast<TP*>(po);
  if (vec == 4)
    fused_adam_kernel<TP, TG, 4, kInPlace>
        <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
            pp, m, v, gg, pop, mo, vo, n, scal, h);
  else
    fused_adam_kernel<TP, TG, 1, kInPlace>
        <<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
            pp, m, v, gg, pop, mo, vo, n, scal, h);
}

template <typename TP, typename TG>
void launch(const void* p, const float* m, const float* v, const void* g,
            void* po, float* mo, float* vo, int64_t n, const float* scal,
            Hyper h, int vec, bool in_place, cudaStream_t s) {
  if (in_place)
    launch_as<TP, TG, true>(p, m, v, g, po, mo, vo, n, scal, h, vec, s);
  else
    launch_as<TP, TG, false>(p, m, v, g, po, mo, vo, n, scal, h, vec, s);
}

}  // namespace

// p [n] (f32, or bf16 when p_bf16), m/v [n] f32, g [n] (f32, or bf16 when
// g_bf16), outputs po/mo/vo of the same types; scal = {lr, bc1, bc2} f32 on
// the device; omb1 = 1 - b1 and omb2 = 1 - b2 as the caller rounds them.
// The outputs are either the inputs themselves (po == p, mo == m, vo == v:
// in place) or overlap no input.  vec is 4 (every pointer aligned for
// 4-element loads) or 1.  Launches on `stream` and returns
// cudaGetLastError().
extern "C" int fused_adam(const void* p, const float* m, const float* v,
                          const void* g, void* po, float* mo, float* vo,
                          int64_t n, const float* scal, float b1, float omb1,
                          float b2, float omb2, float eps, int p_bf16,
                          int g_bf16, int vec, void* stream) {
  const bool in_place = po == p && mo == m && vo == v;
  if (n <= 0 || (vec != 1 && vec != 4) ||
      (!in_place && (po == p || mo == m || vo == v)))
    return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h{b1, omb1, b2, omb2, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p_bf16 && g_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(p, m, v, g, po, mo, vo, n, scal, h,
                                         vec, in_place, s);
  else if (p_bf16)
    launch<__nv_bfloat16, float>(p, m, v, g, po, mo, vo, n, scal, h, vec,
                                 in_place, s);
  else if (g_bf16)
    launch<float, __nv_bfloat16>(p, m, v, g, po, mo, vo, n, scal, h, vec,
                                 in_place, s);
  else
    launch<float, float>(p, m, v, g, po, mo, vo, n, scal, h, vec, in_place,
                         s);
  return static_cast<int>(cudaGetLastError());
}
