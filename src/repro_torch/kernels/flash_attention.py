"""Blockwise flash attention (forward) behind one API.

``flash_attention_bhld`` is the port of the TPU kernel
``src/repro/kernels/flash_attention.py::flash_attention_bhld``: CUDA C++
kernels for Hopper (``csrc/flash_attention.cu``), built at first use by
``kernels/_build.py`` and bound through ``ctypes``.  It is bound by
operations; the source's header note gives the design.  ``route`` names
the kernel a CUDA tensor launches, a fixed function of (dtype, D):

* bf16, D 64, 128 or 256 — ``wgmma`` on both products, K/V tiles through
  a TMA ring with mbarriers, two consumer warpgroups and, at D 64 and 128,
  a producer warpgroup; at D 256 (RecurrentGemma's local attention) a
  consumer thread issues the copies, so that the CTA's 256 threads may
  hold O's 128 registers beside a 64-key tile's S and P;
* bf16, D 16 or 32 — ``mma.sync`` m16n8k16, synchronous tile loads, Q's
  fragments read from shared memory once per K tile;
* float32, any of ``HEAD_DIMS`` — both products on the tensor cores in
  3xTF32 (``mma.sync`` m16n8k8; each operand split in registers into a
  TF32 hi and its remainder, three TF32 products for each f32 one, so the
  result keeps float32 accuracy), P kept in registers, K/V tiles through
  a two-stage ``cp.async`` ring that reads any stride, 0 included.

* ``attention_plain``     — the plain torch version, the counterpart of
  the reference's ``kernels/ref.py::attention_ref``: materialised scores,
  ``-1e30`` masking, softmax, in float32, output in q's dtype.
* ``flash_attention_bhld`` — q ``[B, Hq, L, D]``, k/v ``[B, Hkv, L, D]``.
* ``flash_attention``      — the model-layout wrapper (the counterpart of
  the reference's ``kernels/ops.py::flash_attention``): q ``[B, L, Hq, D]``,
  k/v ``[B, L, Hkv, D]``, read through strides with no transposed copy.

For tensors on the CPU both entries run the plain version; for CUDA
tensors they launch the kernel or raise.  ``LAUNCHES`` counts kernel
launches.  The reference kernel has no VJP, so neither has this one: a
backward raises ``NotImplementedError``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels._build import CSRC, build_library

SOURCE = CSRC / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128, 256)
ROUTES = {"f32-3xtf32": 0, "mma-sync": 1, "wgmma-tma": 2}   # the C entry's codes
NO_BACKWARD = ("flash attention has no backward pass (neither has the "
               "reference kernel); it comes with the transformer's training "
               "slice, ROADMAP queue 2, item 3")

LAUNCHES = 0          # kernel launches (not plain-version calls)
_FN = None            # the loaded C entry point
_LIB = None


def build() -> str:
    """Compile the kernel (if this source has not been built yet) and load
    it.  Returns the compiler's log, empty when it was built before."""
    global _FN, _LIB
    lib, log = build_library(SOURCE)
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    _LIB = lib
    fn = lib.flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _FN = fn
    return log


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA tensor of this dtype and head dim launches."""
    if dtype == torch.float32:
        return "f32-3xtf32"
    return "wgmma-tma" if d in (64, 128, 256) else "mma-sync"


def smem_bytes(dtype: torch.dtype, d: int) -> int:
    """Dynamic shared memory a CTA of the route's kernel takes (builds the
    kernels if they are not loaded yet)."""
    if _LIB is None:
        build()
    return _LIB.flash_attention_smem_bytes(ROUTES[route(dtype, d)], d)


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Materialised attention. q [B,Hq,L,D], k/v [B,Hkv,L,D] → [B,Hq,L,D]."""
    b, hq, sl, d = q.shape
    group = hq // k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    q_pos = torch.arange(sl, device=q.device)[:, None]
    k_pos = torch.arange(sl, device=q.device)[None, :]
    mask = torch.ones((sl, sl), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= (q_pos - k_pos) < window
    s = s.masked_fill(~mask, -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """q [B,Hq,L,D], k/v [B,Hkv,L,D] (possibly strided views)."""
    if q.ndim != 4 or k.shape != v.shape or k.ndim != 4:
        raise ValueError(f"flash_attention: want q [B,Hq,L,D], k/v "
                         f"[B,Hkv,L,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, sl, d = q.shape
    if (k.shape[0] != b or k.shape[2] != sl or k.shape[3] != d
            or hq % k.shape[1]):
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")


def _launch(q, k, v, out, *, causal, window, scale) -> None:
    """All four tensors as [B, H, L, D] views with the head dim contiguous."""
    global LAUNCHES
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: the kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    b, hq, sl, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name}'s head dim must be "
                             f"contiguous")
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"flash_attention: {name} is not aligned for "
                             f"16-byte loads")
        if route(q.dtype, d) == "wgmma-tma" and any(
                s == 0 and n > 1 for s, n in zip(t.stride()[:3], t.shape)):
            raise ValueError(f"flash_attention: {name} is broadcast (stride "
                             f"0 on a dim of size > 1), which a TMA tensor "
                             f"map cannot step; pass k/v with Hkv heads "
                             f"or a contiguous copy")
    if _FN is None:
        build()
    with torch.cuda.device(q.device):
        err = _FN(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  ROUTES[route(q.dtype, d)], b, hq, k.shape[1], sl, d,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  *out.stride()[:3], int(causal), int(window), float(scale),
                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with CUDA "
                           f"error {err} (q {tuple(q.shape)}, {q.dtype})")
    LAUNCHES += 1


def _forward(q, k, v, causal, window, scale, model_layout):
    """q/k/v in the caller's layout → output in the same layout."""
    to_bhld = (lambda t: t.transpose(1, 2)) if model_layout else (lambda t: t)
    qb, kb, vb = to_bhld(q), to_bhld(k), to_bhld(v)
    _check(qb, kb, vb)
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        out = attention_plain(qb, kb, vb, causal=causal, window=window,
                              scale=scale)
        return to_bhld(out)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    _launch(qb, kb, vb, to_bhld(out), causal=causal, window=window,
            scale=scale)
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(q, k, v, causal, window, scale, model_layout):
        return _forward(q, k, v, causal, window, scale, model_layout)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(NO_BACKWARD)


def flash_attention_bhld(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Hq, L, D], k/v [B, Hkv, L, D] → [B, Hq, L, D] in q's dtype."""
    return _FlashAttention.apply(q, k, v, causal, window, scale, False)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Model-layout wrapper: q [B,L,H,D], k/v [B,L,Hkv,D] → [B,L,H,D]."""
    return _FlashAttention.apply(q, k, v, causal, window, None, True)
