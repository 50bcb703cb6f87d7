"""Client-side local computation for the algorithm families.

A client receives the global model ``w`` and produces a *payload* — a tree
with the same structure as the params — which the server plugs into
Eq. (8):  w ← w − β/A · Σ payloads.

* ``perfed``  — the paper's Eq. (7) meta-gradient (3 independent batches,
  exact HVP term, optional first-order variant).
* ``fedavg``  — E local epochs of SGD; payload = (w − w_local)/λ (pseudo-
  gradient form so sync/semi/async share the same server rule).
* ``fedprox`` — like fedavg but local objective + (μ/2)‖w − w_global‖².
* ``pfedme``  — Moreau-envelope gradient λ(w − θ̂(w)).

Payload functions are pure in (params, batches, alpha), so the engine
batches them with ``torch.func.vmap``; ``alpha`` may be a per-lane tensor.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.func import grad

from repro_torch.config import FLConfig
from repro_torch.core import perfed
from repro_torch.utils.tree import tree_leaves, tree_map, tree_scale, tree_sub

PayloadFn = Callable[..., Any]    # (params, batches, alpha) -> payload tree


def _scalar_loss(model, params, batch):
    out = model.loss(params, batch)
    return out[0] if isinstance(out, tuple) else out


def _local_sgd(model, params, batches, lr, steps: int, prox_mu: float = 0.0):
    """``steps`` SGD steps over the provided batch list (cycled)."""
    anchor = params

    def obj(q, batch):
        loss = _scalar_loss(model, q, batch)
        if prox_mu > 0.0:
            sq = [torch.sum(torch.square((a - b).to(torch.float32)))
                  for a, b in zip(tree_leaves(q), tree_leaves(anchor))]
            loss = loss + 0.5 * prox_mu * sum(sq)
        return loss

    p = params
    for s in range(steps):
        g = grad(obj)(p, batches[s % len(batches)])
        p = tree_map(lambda a, b: (a - lr * b).to(a.dtype), p, g)
    return p


def make_payload_fn(model, fl: FLConfig, algorithm: str) -> PayloadFn:
    """Payload computation for one client: ``payload(params, batches,
    alpha)``.  ``alpha`` is an argument so heterogeneous per-UE learning
    rates α_i (the paper's §II-B generalisation) share one function."""
    if algorithm == "perfed":
        def payload(params, batches, alpha):
            return perfed.perfed_grad(model.loss, params, batches, alpha,
                                      first_order=fl.first_order)
    elif algorithm in ("fedavg", "fedprox"):
        mu = fl.prox_mu if algorithm == "fedprox" else 0.0
        steps = max(1, fl.local_epochs)

        def payload(params, batches, alpha):
            blist = [batches["inner"], batches["outer"], batches["hessian"]]
            w_local = _local_sgd(model, params, blist, alpha, steps,
                                 prox_mu=mu)
            # pseudo-gradient: Δ/α̂ so the server's β-scaled rule matches SGD
            return tree_scale(tree_sub(params, w_local),
                              1.0 / (alpha * steps))
    elif algorithm == "pfedme":
        # pFedMe [Dinh et al., ref 11]: personalized model θ̂ solves
        # min_θ f_i(θ) + λ/2‖θ − w‖²; the Moreau-envelope gradient
        # ∇F_i(w) = λ(w − θ̂(w)) is the upload
        lam = fl.pfedme_lambda
        steps = max(1, fl.pfedme_steps)

        def payload(params, batches, alpha):
            blist = [batches["inner"], batches["outer"], batches["hessian"]]
            theta = _local_sgd(model, params, blist, alpha, steps,
                               prox_mu=lam)
            return tree_scale(tree_sub(params, theta), lam)
    else:
        raise ValueError(f"unknown algorithm {algorithm!r}")
    return payload


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

def personalized_eval(model, fl: FLConfig, params, client_batches):
    """PFL metric: adapt on the client's support batch, evaluate on its
    held-out query batch.  Returns (loss, maybe-accuracy)."""
    adapted = perfed.adapt(model.loss, params, client_batches["inner"],
                           fl.alpha)
    out = model.loss(adapted, client_batches["outer"])
    return out if isinstance(out, tuple) else (out, {})


def global_eval(model, params, batch):
    out = model.loss(params, batch)
    return out if isinstance(out, tuple) else (out, {})
