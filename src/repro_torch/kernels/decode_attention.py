"""Single-token decode attention against a ring-buffer KV cache.

``decode_attention_bhsd`` is the port of the TPU kernel
``src/repro/kernels/decode_attention.py::decode_attention_bhsd``: a CUDA
C++ kernel for Hopper (``csrc/decode_attention.cu``), built at first use by
``kernels/_build.py`` and bound through ``ctypes``.  It is bound by bytes
(the cache is read once per step); the source's header note gives the
design: flash-decoding, S split into chunks of ``plan``'s length across
CTAs (bf16 on the tensor cores, float32 on the CUDA cores), each chunk's
(m, l, acc) combined in chunk order by a second small kernel (one call,
one ``LAUNCHES``, whatever the kernels inside).  ``decode_attention_plain``
is the plain torch version, the counterpart of the reference's
``kernels/ref.py::decode_attention_ref``.

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
HEADS_PER_CTA = 8        # query heads of one kv head's group a CTA takes
KEY_BLOCK = 32           # keys a pipeline stage; chunks are multiples of it
MAX_CHUNK = 8192         # slots a CTA takes, at most (its validity bits)
H100_SMS = 132

LAUNCHES = 0          # kernel launches (not plain-version calls)
_FN = None            # the loaded C entry point
_LIB = None


def build() -> str:
    """Compile the kernel (if this source has not been built yet) and load
    it.  Returns the compiler's log, empty when it was built before."""
    global _FN, _LIB
    lib, log = build_library(SOURCE)
    lib.decode_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
    _LIB = lib
    fn = lib.decode_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 12
                   + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _FN = fn
    return log


def plan(b: int, hkv: int, group: int, s: int,
         sms: int = H100_SMS) -> tuple[int, int]:
    """(slots a CTA takes along S, S chunks) of a call on a card with
    ``sms`` SMs.  Where B·Hkv·(head chunks) CTAs fill the card, one chunk
    of all S slots (up to ``MAX_CHUNK``); else chunks of a multiple of
    ``KEY_BLOCK`` slots, enough of them for about 4 CTAs an SM, so a ring
    whose mask keeps half the chunks still leaves two busy CTAs an SM."""
    base = b * hkv * -(-group // HEADS_PER_CTA)
    if base >= sms:
        chunk = min(s, MAX_CHUNK)
    else:
        per_chunk = -(-s // -(-4 * sms // base))
        chunk = min(MAX_CHUNK, max(KEY_BLOCK, -(-per_chunk // KEY_BLOCK)
                                   * KEY_BLOCK))
    return chunk, -(-s // chunk)


def smem_bytes(dtype: torch.dtype, d: int, chunk: int) -> int:
    """Dynamic shared memory a CTA of the split kernel takes for chunks of
    ``chunk`` slots (builds the kernel if it is not loaded yet)."""
    if _LIB is None:
        build()
    return _LIB.decode_attention_smem_bytes(int(dtype == torch.bfloat16), d,
                                            chunk)


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
    hkv, s = k.shape[1], k.shape[2]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    chunk, n_split = plan(b, hkv, hq // hkv, s, sms)
    # each chunk's (m, l) and acc in f32, all written by the split kernel
    # (an empty chunk: m = -1e30, l = 0, acc = 0)
    part = (torch.empty(b * hq * n_split * (d + 2), dtype=torch.float32,
                        device=q.device) if n_split > 1 else None)
    if _FN is None:
        build()
    with torch.cuda.device(q.device):
        err = _FN(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                  q_pos.data_ptr(), out.data_ptr(),
                  None if part is None else part.data_ptr(),
                  int(q.dtype == torch.bfloat16), b, hq, hkv, s, d, chunk,
                  *q.stride()[:2], *k.stride()[:3],
                  *v.stride()[:3], *pos.stride(), *out.stride()[:2],
                  int(window), float(scale),
                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed with "
                           f"CUDA error {err} (q {tuple(q.shape)}, "
                           f"k {tuple(k.shape)}, {q.dtype})")
    LAUNCHES += 1
    return out
