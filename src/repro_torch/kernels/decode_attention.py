"""Single-token decode attention against a ring-buffer KV cache.

``decode_attention_bhsd`` is the port of the TPU kernel
``src/repro/kernels/decode_attention.py::decode_attention_bhsd``: a CUDA
C++ kernel for Hopper (``csrc/decode_attention.cu``), built at first use by
``kernels/_build.py`` and bound through ``ctypes``.  It is bound by bytes
(the cache is read once per step); the source's header note gives the
design.  ``decode_attention_plain`` is the plain torch version, the
counterpart of the reference's ``kernels/ref.py::decode_attention_ref``.

For tensors on the CPU the wrapper runs the plain version; for CUDA
tensors it launches the kernel or raises.  k and v may be strided views,
so the model's cache ``cache["k"][layer]`` (``[B, S, Hkv, D]``) is taken as
``.transpose(1, 2)`` without a copy.  As in the JAX package, no model calls
it: ``TransformerLM.decode_step`` attends through ``layers.sdpa``.
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels._build import CSRC, build_library

SOURCE = CSRC / "decode_attention.cu"
HEAD_DIMS = (16, 32, 64, 128)

LAUNCHES = 0          # kernel launches (not plain-version calls)
_FN = None            # the loaded C entry point


def build() -> str:
    """Compile the kernel (if this source has not been built yet) and load
    it.  Returns the compiler's log, empty when it was built before."""
    global _FN
    lib, log = build_library(SOURCE)
    fn = lib.decode_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _FN = fn
    return log


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, pos: torch.Tensor,
                           q_pos: torch.Tensor, *, window: int = 0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """One-token decode attention against a (ring) cache.

    q [B,Hq,D]; k/v [B,Hkv,S,D]; pos [B,S] (−1 = empty); q_pos [B]."""
    b, hq, d = q.shape
    group = hq // k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhd,bhsd->bhs", q.float(), k.float()) * scale
    mask = (pos >= 0) & (pos <= q_pos[:, None])
    if window > 0:
        mask &= (q_pos[:, None] - pos) < window
    s = s.masked_fill(~mask[:, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhs,bhsd->bhd", p, v.float())
    return out.to(q.dtype)


def _check(q, k, v, pos, q_pos) -> None:
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: want q [B,Hq,D], k/v "
                         f"[B,Hkv,S,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, d = q.shape
    _, hkv, s, dk = k.shape
    if k.shape[0] != b or dk != d or hq % hkv:
        raise ValueError(f"decode_attention: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if tuple(pos.shape) != (b, s) or tuple(q_pos.shape) != (b,):
        raise ValueError(f"decode_attention: want pos [B, S] = {(b, s)} "
                         f"and q_pos [B]; got {tuple(pos.shape)}, "
                         f"{tuple(q_pos.shape)}")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"decode_attention: {name} is {t.dtype}, q is "
                            f"{q.dtype}")
    for name, t in (("k", k), ("v", v), ("pos", pos), ("q_pos", q_pos)):
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, q "
                             f"on {q.device}")


def decode_attention_bhsd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          pos: torch.Tensor, q_pos: torch.Tensor, *,
                          window: int = 0, scale: Optional[float] = None
                          ) -> torch.Tensor:
    """q [B, Hq, D]; k/v [B, Hkv, S, D]; pos [B, S]; q_pos [B] → [B, Hq, D]."""
    global LAUNCHES
    _check(q, k, v, pos, q_pos)
    b, hq, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, pos, q_pos, window=window,
                                      scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"decode_attention: the kernel takes float32 or "
                        f"bfloat16, got {q.dtype}")
    if d not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {d} not in "
                         f"{HEAD_DIMS}")
    vec = 16 // q.element_size()
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"decode_attention: {name}'s head dim must be "
                             f"contiguous")
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError(f"decode_attention: {name} is not aligned for "
                             f"16-byte loads")
    pos = pos.to(torch.int32)
    q_pos = q_pos.to(torch.int32).contiguous()
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    if _FN is None:
        build()
    with torch.cuda.device(q.device):
        err = _FN(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                  q_pos.data_ptr(), out.data_ptr(),
                  int(q.dtype == torch.bfloat16), b, hq, k.shape[1],
                  k.shape[2], d, *q.stride()[:2], *k.stride()[:3],
                  *v.stride()[:3], *pos.stride(), *out.stride()[:2],
                  int(window), float(scale),
                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed with "
                           f"CUDA error {err} (q {tuple(q.shape)}, "
                           f"k {tuple(k.shape)}, {q.dtype})")
    LAUNCHES += 1
    return out
