"""Minimal pure-tree optimizers (no ``torch.optim``).

The port of the JAX package's ``optim/optimizers.py``.  ``Optimizer`` is an
(init, update) pair over trees of tensors; ``update(grads, state, params,
lr)`` returns (new_params, new_state) as new tensors and changes nothing in
place.  ``update(..., inplace=True)`` (a donated step) writes the new
values into ``params``' and ``state``'s own tensors instead, leaf by leaf,
and returns those same trees: the same values, bit for bit, without a
second copy of the params and moments.  The learning rate is passed at
call time, so schedules stay outside the optimizer state.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Tuple

import torch

from repro_torch.kernels.fused_adam import fused_adam_tree
from repro_torch.sharding import write_into
from repro_torch.utils.tree import tree_leaves, tree_map, tree_norm


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    # (grads, state, params, lr, *, inplace=False) -> (params, state)
    update: Callable[..., Tuple[Any, Any]]
    name: str = "opt"


def clip_by_global_norm(grads, max_norm: float):
    """Global-norm gradient clipping; returns (clipped, pre_clip_norm)."""
    g_norm = tree_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(g_norm, min=1e-12), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), g_norm


def sgd() -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, lr, *, inplace=False):
        if inplace:
            for p, g in zip(tree_leaves(params), tree_leaves(grads)):
                write_into(p, (p - lr * g).to(p.dtype))
            return params, state
        new = tree_map(lambda p, g: (p - lr * g).to(p.dtype), params, grads)
        return new, state

    return Optimizer(init, update, "sgd")


def momentum(mu: float = 0.9, nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"m": tree_map(lambda p: torch.zeros_like(
            p, dtype=torch.float32), params)}

    def update(grads, state, params, lr, *, inplace=False):
        def leaf(p, mi, g):
            m = mu * mi + g.to(torch.float32)
            s = mu * m + g.to(torch.float32) if nesterov else m
            return (p - lr * s).to(p.dtype), m

        if inplace:
            for p, mi, g in zip(tree_leaves(params),
                                tree_leaves(state["m"]), tree_leaves(grads)):
                new_p, new_m = leaf(p, mi, g)
                write_into(mi, new_m)
                write_into(p, new_p)
            return params, state
        pair = tree_map(leaf, params, state["m"], grads)
        return (tree_map(lambda r: r[0], pair),
                {"m": tree_map(lambda r: r[1], pair)})

    return Optimizer(init, update, "momentum")


def adam_update_plain(grads, state, params, lr, *, b1: float, b2: float,
                      eps: float, weight_decay: float, state_dtype,
                      inplace: bool = False):
    """The reference's Adam math on trees, leaf by leaf in plain torch
    (written into ``params`` and ``state`` with ``inplace``)."""
    t = state["t"] + 1
    tf = t.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, tf)
    bc2 = 1.0 - torch.pow(b2, tf)

    def leaf(p, mi, vi, g):
        mi = b1 * mi + (1 - b1) * g.to(state_dtype)
        vi = b2 * vi + (1 - b2) * torch.square(g.to(state_dtype))
        mh = mi / bc1
        vh = vi / bc2
        upd = mh / (torch.sqrt(vh) + eps)
        if weight_decay:
            upd = upd + weight_decay * p.to(state_dtype)
        return (p.to(state_dtype) - lr * upd).to(p.dtype), mi, vi

    if inplace:
        for x in zip(*(tree_leaves(y) for y in (params, state["m"],
                                                 state["v"], grads))):
            for dst, src in zip(x, leaf(*x)):
                write_into(dst, src)
        write_into(state["t"], t)
        return params, state
    trio = tree_map(leaf, params, state["m"], state["v"], grads)
    new, m, v = (tree_map(lambda r, i=i: r[i], trio) for i in range(3))
    return new, {"m": m, "v": v, "t": t}


def adam(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
         weight_decay: float = 0.0, state_dtype=torch.float32) -> Optimizer:
    """Adam with f32 (or ``state_dtype``) moments and a step counter ``t``
    held as a 0-d int32 tensor on the params' device.

    The route is fixed by the optimizer's own arguments: with
    ``weight_decay == 0`` and ``state_dtype == float32`` — the function the
    TPU kernel computes — ``update`` goes through ``fused_adam_tree`` (the
    fused Adam kernel on CUDA leaves, its plain version on CPU leaves; lr,
    ``1 − b1^t`` and ``1 − b2^t`` stay on the device, so a step never syncs
    with the host).  Otherwise it runs the reference's plain tree math
    (``adam_update_plain``).  The two agree to f32 rounding.
    """
    fused = weight_decay == 0 and state_dtype == torch.float32

    def init(params):
        def zeros(p):
            return torch.zeros_like(p, dtype=state_dtype)
        device = tree_leaves(params)[0].device
        return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "t": torch.zeros((), dtype=torch.int32, device=device)}

    def update(grads, state, params, lr, *, inplace=False):
        if not fused:
            return adam_update_plain(
                grads, state, params, lr, b1=b1, b2=b2, eps=eps,
                weight_decay=weight_decay, state_dtype=state_dtype,
                inplace=inplace)
        t = state["t"] + 1
        new, m, v = fused_adam_tree(params, state["m"], state["v"], grads,
                                    lr=lr, t=t, b1=b1, b2=b2, eps=eps,
                                    inplace=inplace)
        if inplace:
            write_into(state["t"], t)
            return params, state
        return new, {"m": m, "v": v, "t": t}

    return Optimizer(init, update, "adam")


def make_optimizer(name: str, **kw) -> Optimizer:
    if name == "sgd":
        return sgd()
    if name == "momentum":
        return momentum(**{k: v for k, v in kw.items()
                           if k in ("mu", "nesterov")})
    if name == "adam":
        keys = ("b1", "b2", "eps", "weight_decay", "state_dtype")
        return adam(**{k: v for k, v in kw.items() if k in keys})
    raise ValueError(f"unknown optimizer {name!r}")
