"""Mamba-2 SSD chunk-local terms behind one API.

``ssd_chunk`` is the port of the TPU kernel
``src/repro/kernels/ssd_scan.py::ssd_chunk_pallas``: a CUDA C++ kernel for
Hopper (``csrc/ssd_scan.cu``; f32 in and out, its three products on the
tensor cores in 3xTF32: each operand split into TF32 hi + lo, three
``mma.sync`` products, about f32 accuracy), built at first use by
``kernels/_build.py`` and bound through ``ctypes``.  It is bound by
operations; the source's header note gives the design.

* ``ssd_chunk_plain`` — the plain torch version of ``_ssd_kernel``, batched
  over (batch, chunk): the decay matrix materialised, masked to ``j <= i``.
* ``ssd_chunk``       — the wrapper: a CPU tensor takes the plain version, a
  CUDA tensor launches the kernel or raises.  ``LAUNCHES`` counts launches.
* ``ssd_chunked``     — the counterpart of the reference's
  ``kernels/ops.py::ssd_chunked``: ``models/ssm.ssd_chunked`` with its
  chunk-local terms taken from ``ssd_chunk``.  The inter-chunk recurrence,
  the ``y_inter`` product and the padding of a ragged L (dt = 0 on the
  pads, so they cannot touch the state) are that function's own; the
  reference's ``ops.ssd_chunked`` only asserts on a ragged L.

The reference kernel has no VJP, so neither has this one: a backward
raises ``NotImplementedError``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import CSRC, build_library

SOURCE = CSRC / "ssd_scan.cu"
MAX_Q, MAX_P, MAX_N = 256, 64, 128
NO_BACKWARD = ("the SSD chunk kernel has no backward pass (neither has the "
               "reference kernel); train with attn_impl='xla'")

LAUNCHES = 0          # kernel launches (not plain-version calls)
_FN = None            # the loaded C entry point
_LIB = None


def build() -> str:
    """Compile the kernel (if this source has not been built yet) and load
    it.  Returns the compiler's log, empty when it was built before."""
    global _FN, _LIB
    lib, log = build_library(SOURCE)
    lib.ssd_chunk_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.ssd_chunk_smem_bytes.restype = ctypes.c_int64
    _LIB = lib
    fn = lib.ssd_chunk_f32
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int64]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _FN = fn
    return log


def smem_bytes(q: int, p: int, n: int) -> int:
    """Dynamic shared memory a CTA of the kernel takes at (Q, P, N) (builds
    the kernel first)."""
    if _LIB is None:
        build()
    return _LIB.ssd_chunk_smem_bytes(q, p, n)


def ssd_chunk_plain(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor
                    ) -> Tuple[torch.Tensor, ...]:
    """x [B,NC,Q,H,P], dt [B,NC,Q,H], a [H], b/c [B,NC,Q,N] (f32) →
    (y_intra [B,NC,Q,H,P], states [B,NC,H,P,N], chunk_decay [B,NC,H],
    in_decay [B,NC,H,Q])."""
    q = x.shape[2]
    da = (dt * a).movedim(-1, -2)                               # [B,NC,H,Q]
    cum = torch.cumsum(da, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]                # [B,NC,H,Q,Q]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    lmat = torch.where(tri, torch.exp(diff), 0.0)
    scores = torch.einsum("bzin,bzjn->bzij", c, b)              # [B,NC,Q,Q]
    xdt = x * dt[..., None]                                     # [B,NC,Q,H,P]
    y = torch.einsum("bzhij,bzjhp->bzihp", scores[:, :, None] * lmat, xdt)
    decay_end = torch.exp(cum[..., -1:] - cum)                  # [B,NC,H,Q]
    st = torch.einsum("bzjn,bzjhp->bzhpn", b,
                      xdt * decay_end.movedim(-1, -2)[..., None])
    return y, st, torch.exp(cum[..., -1]), torch.exp(cum)


def _check(x, dt, a, b, c) -> None:
    if x.ndim != 5 or dt.ndim != 4 or a.ndim != 1 or b.ndim != 4 \
            or c.shape != b.shape:
        raise ValueError(f"ssd_chunk: want x [B,NC,Q,H,P], dt [B,NC,Q,H], "
                         f"a [H], b/c [B,NC,Q,N]; got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(a.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}")
    bs, nc, q, h, _ = x.shape
    if dt.shape != (bs, nc, q, h) or a.shape[0] != h \
            or b.shape[:3] != (bs, nc, q):
        raise ValueError(f"ssd_chunk: shapes do not fit x {tuple(x.shape)}: "
                         f"dt {tuple(dt.shape)}, a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}")
    for name, t in (("x", x), ("dt", dt), ("a", a), ("b", b), ("c", c)):
        if t.dtype != torch.float32:
            raise TypeError(f"ssd_chunk: {name} must be float32, got "
                            f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"ssd_chunk: {name} on {t.device}, x on "
                             f"{x.device}")


def _launch(x, dt, a, b, c):
    global LAUNCHES
    bs, nc, q, h, p = x.shape
    n = b.shape[-1]
    if q > MAX_Q or p > MAX_P or n > MAX_N:
        raise ValueError(f"ssd_chunk: the kernel takes Q <= {MAX_Q}, "
                         f"P <= {MAX_P}, N <= {MAX_N}; got Q={q}, P={p}, "
                         f"N={n}")
    for name, t in (("x", x), ("dt", dt), ("a", a), ("b", b), ("c", c)):
        if not t.is_contiguous():
            raise ValueError(f"ssd_chunk: {name} must be contiguous")
    if x.numel() == 0 or b.numel() == 0:
        raise ValueError(f"ssd_chunk: empty input {tuple(x.shape)}, "
                         f"{tuple(b.shape)}")
    y = torch.empty_like(x)
    st = torch.empty((bs, nc, h, p, n), dtype=x.dtype, device=x.device)
    dec = torch.empty((bs, nc, h), dtype=x.dtype, device=x.device)
    indec = torch.empty((bs, nc, h, q), dtype=x.dtype, device=x.device)
    if _FN is None:
        build()
    with torch.cuda.device(x.device):
        err = _FN(x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
                  c.data_ptr(), y.data_ptr(), st.data_ptr(), dec.data_ptr(),
                  indec.data_ptr(), bs * nc, q, h, p, n,
                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd_chunk kernel launch failed with CUDA error "
                           f"{err} (x {tuple(x.shape)}, N={n})")
    LAUNCHES += 1
    return y, st, dec, indec


class _SSDChunk(torch.autograd.Function):
    @staticmethod
    def forward(x, dt, a, b, c):
        return _launch(x, dt, a, b, c)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(NO_BACKWARD)


def ssd_chunk(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Chunk-local SSD terms; shapes as ``ssd_chunk_plain``.  All f32 on one
    device; CUDA inputs must be contiguous."""
    _check(x, dt, a, b, c)
    if x.device.type == "cpu":
        return ssd_chunk_plain(x, dt, a, b, c)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_chunk: unsupported device {x.device}")
    return _SSDChunk.apply(x, dt, a, b, c)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel-backed drop-in for ``models.ssm.ssd_chunked``: that scan with
    its chunk-local terms from ``ssd_chunk``.

    x [B,L,H,P], dt [B,L,H], a [H], b/c [B,L,N] → (y [B,L,H,P],
    final_state [B,H,P,N]), both in x's dtype.
    """
    from repro_torch.models.ssm import ssd_chunked as scan
    return scan(x, dt, a, b, c, chunk, initial_state, chunk_fn=ssd_chunk)
