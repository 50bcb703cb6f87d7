"""Masked stale-gradient aggregation — Eq. (8) — behind ONE API.

    w ← w − (β/A) Σ_c π_c · buf_c,   A = max(Σ_c π_c, 1)

``stale_aggregate_flat`` is the port of the TPU kernel
``src/repro/kernels/stale_aggregate.py::stale_aggregate_flat``: a CUDA C++
kernel for Hopper (``csrc/stale_aggregate.cu``), built with ``nvcc`` for
``sm_90a`` at first use into ``build/`` at the repository root (keyed by a
hash of the source, by ``kernels/_build.py``) and bound through
``ctypes``.  It is bound by bytes:
``(C+2)·N·4`` over the card's 3.35 TB/s.  Its grid is sized from the
card's SM count into equal slices (``launch_shape``), and each thread keeps
the loads of 8–16 buffer rows in flight before it adds them in c order;
the source's header note gives the design.  For a tensor on the CPU the
wrapper runs ``stale_aggregate_plain``, the same c-ordered f32 loop in
plain torch; for a CUDA tensor it launches the kernel or raises.  ``LAUNCHES`` counts kernel launches.

On top sit the tree entry points the protocol code shares:

* ``stale_aggregate_tree``  — fused Eq. (8) update of a params tree from C
  payload trees (list or stacked) and a weight mask, through one flat
  ``[C, N]`` buffer in the JAX flattener's leaf order.
* ``masked_aggregate_tree`` — the masked *mean* alone (plain torch).
* ``stale_aggregate_update`` — Eq. (8) on flat buffers.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import CSRC, build_library
from repro_torch.utils.tree import TreeFlattener, tree_map, tree_stack

SOURCE = CSRC / "stale_aggregate.cu"

LAUNCHES = 0          # kernel launches (not plain-version calls)
_FN = None            # the loaded C entry point
_LIB = None


def build() -> str:
    """Compile the kernel (if this source has not been built yet) and load
    it.  Returns the compiler's log (``-Xptxas -v``: registers, spills),
    empty when the library was already built."""
    global _FN, _LIB
    lib, log = build_library(SOURCE)
    lib.stale_aggregate_plan.argtypes = [ctypes.c_int64, ctypes.c_int,
                                         ctypes.c_void_p]
    lib.stale_aggregate_plan.restype = ctypes.c_int
    _LIB = lib
    fn = lib.stale_aggregate_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _FN = fn
    return log


def launch_shape(n: int, vec: int) -> tuple:
    """(CTAs, threads a CTA, column groups a thread) of the kernel's grid for
    N columns at vector width ``vec`` on the current card (builds the kernel
    first)."""
    if _LIB is None:
        build()
    out = (ctypes.c_int64 * 3)()
    err = _LIB.stale_aggregate_plan(n, vec, ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"stale_aggregate_plan failed with CUDA error "
                           f"{err} (N={n}, vec={vec})")
    return tuple(out)


def _check(params: torch.Tensor, buffers: torch.Tensor,
           mask: torch.Tensor) -> None:
    for name, t in (("params", params), ("buffers", buffers),
                    ("mask", mask)):
        if t.dtype != torch.float32:
            raise TypeError(f"stale_aggregate: {name} must be float32, "
                            f"got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"stale_aggregate: {name} must be contiguous")
        if t.device != params.device:
            raise ValueError(f"stale_aggregate: {name} on {t.device}, "
                             f"params on {params.device}")
    if (params.ndim != 1 or buffers.ndim != 2 or mask.ndim != 1
            or buffers.shape[1] != params.shape[0]
            or mask.shape[0] != buffers.shape[0]):
        raise ValueError(
            f"stale_aggregate: want params [N], buffers [C, N], mask [C]; "
            f"got {tuple(params.shape)}, {tuple(buffers.shape)}, "
            f"{tuple(mask.shape)}")


def stale_aggregate_plain(params: torch.Tensor, buffers: torch.Tensor,
                          mask: torch.Tensor, *, beta) -> torch.Tensor:
    """The kernel's plain torch version: the same c-ordered f32 sum."""
    a = torch.clamp(mask.sum(), min=1.0)
    acc = torch.zeros_like(params, dtype=torch.float32)
    for c in range(buffers.shape[0]):
        acc = acc + mask[c] * buffers[c].to(torch.float32)
    scale = torch.tensor(beta, dtype=torch.float32, device=params.device) / a
    return (params.to(torch.float32) - scale * acc).to(params.dtype)


def vector_width(n: int, *tensors: torch.Tensor) -> int:
    """Widest of 4, 2, 1 floats that divides N (so each [C, N] row stays
    aligned) and that every base pointer is aligned to."""
    for v in (4, 2):
        if n % v == 0 and all(t.data_ptr() % (4 * v) == 0 for t in tensors):
            return v
    return 1


def stale_aggregate_flat(params: torch.Tensor, buffers: torch.Tensor,
                         mask: torch.Tensor, *, beta) -> torch.Tensor:
    """params [N], buffers [C, N], mask [C] (all f32, contiguous, on one
    device) → updated params [N].  CPU tensors take the plain version; CUDA
    tensors launch the Hopper kernel on the current stream (no host sync)."""
    global LAUNCHES
    _check(params, buffers, mask)
    if params.device.type == "cpu":
        return stale_aggregate_plain(params, buffers, mask, beta=beta)
    if params.device.type != "cuda":
        raise ValueError(f"stale_aggregate: unsupported device "
                         f"{params.device}")
    out = torch.empty_like(params)
    n, c = params.shape[0], buffers.shape[0]
    if n == 0:
        return out
    if _FN is None:
        build()
    with torch.cuda.device(params.device):
        err = _FN(params.data_ptr(), buffers.data_ptr(), mask.data_ptr(),
                  out.data_ptr(), n, c, float(beta),
                  vector_width(n, params, buffers, out),
                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"stale_aggregate kernel launch failed with CUDA "
                           f"error {err} (N={n}, C={c})")
    LAUNCHES += 1
    return out


# ---------------------------------------------------------------------------
# Tree-level unified API
# ---------------------------------------------------------------------------

def _check_backend(backend: str) -> None:
    # kept for the JAX package's signatures: the route follows the
    # tensors' device (kernel on CUDA, plain version on the CPU)
    if backend != "auto":
        raise ValueError(f"unknown aggregation backend {backend!r}; the "
                         f"port picks the route from the tensors' device")


def stale_aggregate_update(p_flat: torch.Tensor, buf: torch.Tensor,
                           mask: torch.Tensor, *, beta,
                           backend: str = "auto") -> torch.Tensor:
    """Flat-buffer Eq. (8):  p − (β/A) Σ_c mask_c·buf_c,  A = max(Σ mask, 1)."""
    _check_backend(backend)
    return stale_aggregate_flat(p_flat, buf, mask.to(torch.float32),
                                beta=beta)


def _stack_leafwise(payloads):
    """List of payload trees → one tree with a leading cohort axis."""
    if isinstance(payloads, (list, tuple)):
        return tree_stack(list(payloads))
    return payloads


AGG_CHUNK = 1 << 26     # a leaf's elements a masked-mean step reads


def _masked_mean(mask: torch.Tensor, bl: torch.Tensor, a: torch.Tensor):
    """One leaf's masked mean, ``AGG_CHUNK`` elements at a time: an f32
    copy of all C rows of a large bf16 leaf (a 655M-row embedding at C 4
    is 10.5 GB) is not made at once.  Each element's sum over c is the
    same ``tensordot`` whatever the chunk."""
    n = bl[0].numel() if bl.shape[0] else 0
    if n <= AGG_CHUNK:
        return torch.tensordot(mask, bl.to(torch.float32), dims=1) / a
    rows = bl.reshape(bl.shape[0], n)
    out = torch.empty(n, dtype=torch.float32, device=bl.device)
    for i in range(0, n, AGG_CHUNK):
        out[i:i + AGG_CHUNK] = torch.tensordot(
            mask, rows[:, i:i + AGG_CHUNK].to(torch.float32), dims=1) / a
    return out.reshape(bl.shape[1:])


def masked_aggregate_tree(payloads, mask: torch.Tensor):
    """Σ_c mask_c · payload_c / max(Σ mask, 1) as an f32 tree.

    ``payloads`` is a list of trees or one tree with a leading cohort axis.
    """
    stacked = _stack_leafwise(payloads)
    mask = mask.to(torch.float32)
    a = torch.clamp(mask.sum(), min=1.0)
    return tree_map(lambda bl: _masked_mean(mask, bl, a), stacked)


def stale_aggregate_tree(params, payloads, mask: torch.Tensor, *, beta,
                         backend: str = "auto"):
    """Fused Eq. (8) on trees:  w ← w − (β/A) Σ_c mask_c · payload_c,
    A = max(Σ mask, 1).  Returns a tree shaped/typed like ``params``.

    A staleness-discounted update (server ``staleness_discount`` < 1) is the
    same call with ``mask_c = λ^{τ_c} · A / Σ λ^{τ}``.  Params and payloads
    flatten through the cached ``TreeFlattener`` into the one ``[C, N]``
    buffer the kernel reads.
    """
    _check_backend(backend)
    flat = TreeFlattener.for_tree(params)
    p = flat.flatten(params)
    if isinstance(payloads, (list, tuple)):
        buf = torch.stack([flat.flatten(g) for g in payloads])
    else:
        buf = flat.flatten_stacked(payloads)
    out = stale_aggregate_update(p, buf, mask, beta=beta)
    return flat.unflatten(out)
