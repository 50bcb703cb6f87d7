"""Per-FedAvg meta-gradient — Eq. (3)–(7) of the paper, in ``torch.func``.

The PFL objective per client is ``F_i(w) = f_i(w − α ∇f_i(w))`` (Eq. 4) and
its gradient (Eq. 5):

    ∇F_i(w) = (I − α ∇²f_i(w)) ∇f_i(w − α ∇f_i(w))

The stochastic version (Eq. 7) uses three independent batches: ``D_in``
for the inner adaptation gradient, ``D_o`` for the outer gradient at the
adapted point, and ``D_h`` for the Hessian estimate.  The Hessian is never
materialised: ``(I − α∇²f)v = v − α·HVP(w, v)`` with the HVP computed
forward-over-reverse (``torch.func.jvp`` through ``torch.func.grad``) —
exact and O(params).  Every function here is pure, so ``torch.func.vmap``
batches it over clients.

``autograd=True`` takes the same math through ``torch.autograd.grad``
instead, the HVP by reverse over reverse (the gradient of ``<∇f(w), v>``,
``create_graph=True``): DTensors have no forward-mode AD, and under a
``torch.func`` transform a DTensor is wrapped, so the model code on a mesh
cannot read its layout.  The semi-synchronous step takes this route on
plain tensors and DTensors alike.

``first_order=True`` gives the FO-MAML variant (drops the Hessian term).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch
from torch.func import grad, jvp

from repro_torch.sharding import constrain_like
from repro_torch.utils.tree import (tree_axpy, tree_leaves, tree_map,
                                    tree_unflatten)

LossFn = Callable[..., Any]   # loss_fn(params, batch) -> (scalar, aux)


def _scalar(out):
    return out[0] if isinstance(out, tuple) else out


def _grad(loss_fn: LossFn, params, batch):
    return grad(lambda p: _scalar(loss_fn(p, batch)))(params)


def grad_autograd(loss_fn: LossFn, params, batch, *,
                  create_graph: bool = False):
    """∇f(w; batch) through ``torch.autograd.grad``.  With
    ``create_graph`` the gradient stays differentiable in ``params`` (which
    must then require grad); else ``params`` are leaves of a new graph."""
    if not create_graph:
        params = tree_map(lambda x: x.detach().requires_grad_(True), params)
    with torch.enable_grad():
        loss = _scalar(loss_fn(params, batch))
        leaves = tree_leaves(params)
        g = torch.autograd.grad(loss, leaves, create_graph=create_graph)
        # on a mesh: each gradient laid out as its param
        g = [constrain_like(gi, p) for gi, p in zip(g, leaves)]
    return tree_unflatten(params, g)


def hvp_autograd(loss_fn: LossFn, params, batch, vector):
    """∇²f(w; D_h) · v by reverse over reverse: ∇_w <∇f(w; D_h), v>."""
    p = tree_map(lambda x: x.detach().requires_grad_(True), params)
    with torch.enable_grad():
        g = grad_autograd(loss_fn, p, batch, create_graph=True)
        dot = 0.0
        for gi, vi in zip(tree_leaves(g), tree_leaves(vector)):
            dot = dot + torch.sum(gi * vi)
        leaves = tree_leaves(p)
        h = torch.autograd.grad(dot, leaves)
    return tree_unflatten(params, [constrain_like(hi, x)
                                   for hi, x in zip(h, leaves)])


def adapt(loss_fn: LossFn, params, batch, alpha, *, autograd: bool = False):
    """One inner SGD step: w' = w − α ∇f(w; D_in)  (the personalization step)."""
    if autograd:
        g = grad_autograd(loss_fn, params, batch)
        params = tree_map(lambda x: x.detach(), params)
    else:
        g = _grad(loss_fn, params, batch)
    return tree_axpy(-alpha, g, params)


def hvp(loss_fn: LossFn, params, batch, vector):
    """Hessian-vector product ∇²f(w; D_h) · v via forward-over-reverse."""
    # torch.func wants tangents in the primals' dict key order
    vector = tree_map(lambda _, v: v, params, vector)
    return jvp(lambda p: _grad(loss_fn, p, batch), (params,), (vector,))[1]


def perfed_grad(loss_fn: LossFn, params, batches: Dict[str, Any], alpha, *,
                first_order: bool = False, autograd: bool = False):
    """Stochastic meta-gradient ∇̃F_i(w) of Eq. (7).

    ``batches`` carries the three independent samples: ``{"inner": D_in,
    "outer": D_o, "hessian": D_h}``.  Returns a tree like ``params``.
    """
    w_adapted = adapt(loss_fn, params, batches["inner"], alpha,
                      autograd=autograd)
    if autograd:
        g_outer = grad_autograd(loss_fn, w_adapted, batches["outer"])
    else:
        g_outer = _grad(loss_fn, w_adapted, batches["outer"])
    del w_adapted                 # not held through the HVP
    if first_order:
        return g_outer
    h = (hvp_autograd if autograd else hvp)(loss_fn, params,
                                            batches["hessian"], g_outer)
    return tree_axpy(-alpha, h, g_outer)


def perfed_loss(loss_fn: LossFn, params, batches: Dict[str, Any], alpha, *,
                autograd: bool = False):
    """F_i(w) = f_i(w − α∇f_i(w; D_in); D_o) — the meta-objective value."""
    w_adapted = adapt(loss_fn, params, batches["inner"], alpha,
                      autograd=autograd)
    return _scalar(loss_fn(w_adapted, batches["outer"]))


def perfed_grad_exact(loss_fn: LossFn, params, batch, alpha):
    """Autodiff oracle: d/dw f(w − α∇f(w)) on a single batch.

    With identical batches for inner/outer/hessian, ``perfed_grad`` must
    agree with it to numerical precision.
    """
    def meta_obj(p):
        return _scalar(loss_fn(adapt(loss_fn, p, batch, alpha), batch))
    return grad(meta_obj)(params)
