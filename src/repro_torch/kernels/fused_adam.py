"""Fused Adam update behind one API.

``fused_adam_flat`` is the port of the TPU kernel
``src/repro/kernels/fused_adam.py::fused_adam_flat``: a CUDA C++ kernel for
Hopper (``csrc/fused_adam.cu``), built at first use by ``kernels/_build.py``
and bound through ``ctypes``.  It is bound by bytes; the source's header
note gives the design.

* ``fused_adam_plain`` — the plain torch version of ``_adam_kernel``: the
  same f32 arithmetic in the same order.
* ``fused_adam_flat``  — the wrapper: a CPU tensor takes the plain version,
  a CUDA tensor launches the kernel or raises.  ``LAUNCHES`` counts
  launches.
* ``fused_adam_tree``  — one ``fused_adam_flat`` per leaf.  On a tree of
  DTensors (the server Adam on a mesh) each rank runs it once a leaf on
  its local shards: Adam is elementwise, and p, m, v and g of a leaf are
  placed alike (m and v are made ``zeros_like`` p, the aggregate is placed
  like the params), so the local shards line up.

lr and the bias corrections ``bc = 1 − b^t`` are computed in f32 on the
tensors' device (``t`` may be a device tensor) and reach the kernel as a
3-float device tensor, so a step never syncs with the host.  By default a
call writes new tensors and leaves its inputs as they were.  With
``inplace=True`` (a donated step) it writes p, m and v into the inputs
themselves and returns them: on the card by the kernel's in-place
instance (outputs equal to inputs, so p, m and v are not declared
``__restrict__``), on the CPU by ``copy_`` from the plain version.  g is
never written.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels._build import CSRC, build_library
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten

SOURCE = CSRC / "fused_adam.cu"
KERNEL_DTYPES = (torch.float32, torch.bfloat16)

LAUNCHES = 0          # kernel launches (not plain-version calls)
_FN = None            # the loaded C entry point


def build() -> str:
    """Compile the kernel (if this source has not been built yet) and load
    it.  Returns the compiler's log, empty when it was built before."""
    global _FN
    lib, log = build_library(SOURCE)
    fn = lib.fused_adam
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int64, ctypes.c_void_p]
                   + [ctypes.c_float] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _FN = fn
    return log


def adam_scalars(lr, t, b1: float, b2: float, device) -> torch.Tensor:
    """[lr, 1 − b1^t, 1 − b2^t] as f32 on ``device`` (no host sync when lr
    or t are device tensors)."""
    f32 = dict(dtype=torch.float32, device=device)
    tf = torch.as_tensor(t, **f32)
    return torch.stack([torch.as_tensor(lr, **f32).reshape(()),
                        1.0 - torch.pow(b1, tf), 1.0 - torch.pow(b2, tf)])


def fused_adam_plain(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                     g: torch.Tensor, scal: torch.Tensor, *, b1: float,
                     b2: float, eps: float
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's plain torch version: ``scal`` = [lr, bc1, bc2]."""
    lr, bc1, bc2 = scal[0], scal[1], scal[2]
    gf = g.to(torch.float32)
    m = b1 * m + (1.0 - b1) * gf
    v = b2 * v + (1.0 - b2) * gf * gf
    mh = m / bc1
    vh = v / bc2
    new_p = (p.to(torch.float32) - lr * mh / (torch.sqrt(vh) + eps)).to(
        p.dtype)
    return new_p, m, v


def _check(p, m, v, g) -> None:
    if p.ndim != 1 or m.shape != p.shape or v.shape != p.shape \
            or g.shape != p.shape:
        raise ValueError(f"fused_adam: want p, m, v, g all [N]; got "
                         f"{tuple(p.shape)}, {tuple(m.shape)}, "
                         f"{tuple(v.shape)}, {tuple(g.shape)}")
    for name, t in (("m", m), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused_adam: {name} must be float32, got "
                            f"{t.dtype}")
    for name, t in (("p", p), ("g", g)):
        if not t.is_floating_point():
            raise TypeError(f"fused_adam: {name} must be floating, got "
                            f"{t.dtype}")
    for name, t in (("m", m), ("v", v), ("g", g)):
        if t.device != p.device:
            raise ValueError(f"fused_adam: {name} on {t.device}, p on "
                             f"{p.device}")


def _vector_width(*tensors: torch.Tensor) -> int:
    """4 when every pointer is aligned for 4-element loads, else 1."""
    if all(t.data_ptr() % (4 * t.element_size()) == 0 for t in tensors):
        return 4
    return 1


def fused_adam_flat(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                    g: torch.Tensor, *, lr, t, b1: float = 0.9,
                    b2: float = 0.95, eps: float = 1e-8, inplace: bool = False
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Update one flat tensor.  p [N] (f32 or bf16 on the card, any float
    type on the CPU), m/v [N] f32, g [N] (f32 or bf16 on the card).
    Returns new (p, m, v), or with ``inplace`` the inputs p, m and v
    themselves, updated; p keeps its dtype."""
    _check(p, m, v, g)
    return _update(p, m, v, g, adam_scalars(lr, t, b1, b2, p.device),
                   b1=b1, b2=b2, eps=eps, inplace=inplace)


def _update(p, m, v, g, scal, *, b1, b2, eps, inplace=False):
    global LAUNCHES
    if p.device.type == "cpu":
        out = fused_adam_plain(p, m, v, g, scal, b1=b1, b2=b2, eps=eps)
        if not inplace:
            return out
        for x, y in zip((p, m, v), out):
            x.copy_(y)
        return p, m, v
    if p.device.type != "cuda":
        raise ValueError(f"fused_adam: unsupported device {p.device}")
    for name, x in (("p", p), ("g", g)):
        if x.dtype not in KERNEL_DTYPES:
            raise TypeError(f"fused_adam: the kernel takes {name} in float32 "
                            f"or bfloat16, got {x.dtype}")
    for name, x in (("p", p), ("m", m), ("v", v), ("g", g)):
        if not x.is_contiguous():
            raise ValueError(f"fused_adam: {name} must be contiguous")
    if inplace:
        new_p, new_m, new_v = p, m, v
    else:
        new_p, new_m, new_v = (torch.empty_like(p), torch.empty_like(m),
                               torch.empty_like(v))
    n = p.shape[0]
    if n == 0:
        return new_p, new_m, new_v
    if _FN is None:
        build()
    # in place the outputs are the inputs: the alignment counts each once
    vec = _vector_width(p, m, v, g, *(() if inplace else
                                      (new_p, new_m, new_v)))
    with torch.cuda.device(p.device):
        err = _FN(p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
                  new_p.data_ptr(), new_m.data_ptr(), new_v.data_ptr(), n,
                  scal.data_ptr(), b1, 1.0 - b1, b2, 1.0 - b2, eps,
                  int(p.dtype == torch.bfloat16),
                  int(g.dtype == torch.bfloat16), vec,
                  torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_adam kernel launch failed with CUDA error "
                           f"{err} (N={n}, p {p.dtype}, g {g.dtype})")
    LAUNCHES += 1
    return new_p, new_m, new_v


def _flat_views(p, m, v, g, inplace):
    """A leaf's p, m, v and g as [N]; in place p, m and v must be
    contiguous, so that the flat views are the leaves' own storage."""
    if inplace and not all(x.is_contiguous() for x in (p, m, v)):
        raise ValueError("fused_adam: in place, p, m and v must be "
                         "contiguous")
    flat = (p.reshape(-1), m.reshape(-1), v.reshape(-1), g.reshape(-1))
    _check(*flat)
    return flat


def fused_adam_tree(params, m, v, grads, *, lr, t, b1: float = 0.9,
                    b2: float = 0.95, eps: float = 1e-8,
                    inplace: bool = False):
    """Tree fused Adam: ``fused_adam_flat`` leaf by leaf (one launch per
    leaf on the card).  Returns new (params, m, v) trees, or with
    ``inplace`` the trees given, every leaf updated in place; g is read in
    its own dtype.  DTensor leaves take ``_fused_adam_mesh``."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree_leaves(params)[0], DTensor):
        return _fused_adam_mesh(params, m, v, grads, lr=lr, t=t, b1=b1,
                                b2=b2, eps=eps, inplace=inplace)
    scal = None

    def upd(p, mi, vi, g):
        nonlocal scal
        flat = _flat_views(p, mi, vi, g, inplace)
        if scal is None:            # one [lr, bc1, bc2] for every leaf
            scal = adam_scalars(lr, t, b1, b2, p.device)
        res = _update(*flat, scal, b1=b1, b2=b2, eps=eps, inplace=inplace)
        return tuple(r.reshape(p.shape) for r in res)

    if inplace:
        for leaf in zip(*(tree_leaves(x) for x in (params, m, v, grads))):
            upd(*leaf)
        return params, m, v
    # tuples are leaves to tree_map: one (p, m, v) triple per leaf
    trio = tree_map(upd, params, m, v, grads)
    return tuple(tree_map(lambda r, i=i: r[i], trio) for i in range(3))


def _fused_adam_mesh(params, m, v, grads, *, lr, t, b1, b2, eps,
                     inplace=False):
    """``fused_adam_tree`` on DTensors: one ``[lr, bc1, bc2]`` from the
    replicated ``t``, then the kernel once a leaf on each rank's local
    shards through ``local_map`` (no autograd: the update is first order),
    or with ``inplace`` into each DTensor's own local shard, through
    ``to_local()``.  Every leaf's p, m, v and g must share placements and
    split evenly."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.sharding import check_even
    leaves = [tree_leaves(x) for x in (params, m, v, grads)]
    for p, *rest in zip(*leaves):
        if any(tuple(x.placements) != tuple(p.placements) for x in rest):
            raise ValueError(
                f"fused_adam on a mesh: p, m, v and g of a leaf must be "
                f"placed alike, got {[tuple(x.placements) for x in (p, *rest)]}")
        check_even(p)
    if isinstance(t, DTensor):
        if not all(pl.is_replicate() for pl in t.placements):
            raise ValueError(f"fused_adam on a mesh: t must be replicated, "
                             f"got {t.placements}")
        t = t.to_local()
    p0 = leaves[0][0]
    scal = adam_scalars(lr, t, b1, b2, p0.to_local().device)
    if inplace:
        with torch.no_grad():
            for leaf in zip(*leaves):
                local = [x.to_local() for x in leaf]
                _update(*_flat_views(*local, True), scal, b1=b1, b2=b2,
                        eps=eps, inplace=True)
        return params, m, v

    def local_adam(pl, ml, vl, gl):
        out = []
        for p, mi, vi, g in zip(pl, ml, vl, gl):
            flat = (p.reshape(-1), mi.reshape(-1), vi.reshape(-1),
                    g.reshape(-1))
            _check(*flat)
            out.append(_update(*flat, scal, b1=b1, b2=b2, eps=eps))
        return [r.reshape(p.shape) for i in range(3)
                for p, r in zip(pl, (o[i] for o in out))]

    placements = tuple(p.placements for p in leaves[0])
    with torch.no_grad():
        out = local_map(local_adam, out_placements=placements * 3,
                        in_placements=placements * 4,
                        device_mesh=p0.device_mesh)(*leaves)
    n = len(placements)
    return tuple(tree_unflatten(params, list(out[i * n:(i + 1) * n]))
                 for i in range(3))
