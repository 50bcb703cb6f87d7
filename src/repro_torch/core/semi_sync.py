"""Semi-synchronous aggregation as a training step over cohorts.

The port of the JAX package's ``core/semi_sync.py``: the datacenter-scale
mapping of Alg. 1.  Each *cohort* plays the role of a UE.  The server's
"wait for A of n" is a masked sum over the cohort axis; gradients "in
flight" live in a per-cohort buffer carried in the train state.

Per step (round k), given the Alg.-2 schedule mask π_k:

  1. w_{k+1} = w_k − β/A · Σ_{i: π_i=1} buf_i          (Eq. 8 — arriving grads,
     possibly computed against w_{k−τ_i}: that's exactly what the buffer holds)
  2. refresh: cohorts with π_i=1 (or staleness > S) compute a fresh PerFed
     meta-gradient (Eq. 7) against w_{k+1} and overwrite their buffer slot
  3. staleness counters advance.

With n_cohorts=1 and π=[1] this degenerates exactly to synchronous
Per-FedAvg.  The reference shards the cohort axis over a device mesh; here
every cohort lives on one device and ``torch.func.vmap`` maps the
meta-gradient over the cohort axis, one cohort at a time.  The port's
losses take no randomness (as the reference's LM losses ignore their key),
so the step takes an optional ``torch.Generator`` where the reference takes
a key, and passes it to no loss.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch
from torch.func import grad, vmap

from repro_torch.config import ExperimentConfig
from repro_torch.core import perfed
from repro_torch.kernels.stale_aggregate import (masked_aggregate_tree,
                                                 stale_aggregate_tree)
from repro_torch.optim import Optimizer, clip_by_global_norm
from repro_torch.utils.tree import tree_leaves, tree_map


class SemiSyncState(NamedTuple):
    params: Any                  # meta model w_k
    opt_state: Any               # server optimizer state (empty for β-SGD)
    buffers: Any                 # per-cohort pending grads [n_cohorts, ...]
    staleness: torch.Tensor      # [n_cohorts] int32 — rounds since refresh
    step: torch.Tensor           # round counter k


def init_state(model, gen: Optional[torch.Generator], optimizer: Optimizer,
               n_cohorts: int) -> SemiSyncState:
    """Params from ``model.init(gen)`` (on ``gen``'s device); zero buffers
    in the params' dtypes."""
    params = model.init(gen)
    device = tree_leaves(params)[0].device
    buffers = tree_map(lambda p: torch.zeros((n_cohorts,) + tuple(p.shape),
                                             dtype=p.dtype, device=device),
                       params)
    return SemiSyncState(
        params=params,
        opt_state=optimizer.init(params),
        buffers=buffers,
        staleness=torch.zeros((n_cohorts,), dtype=torch.int32, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )


def _scalar_loss(model):
    def fn(p, batch):
        out = model.loss(p, batch)
        return out[0] if isinstance(out, tuple) else out
    return fn


def _cohort_grads(model, cfg: ExperimentConfig, params, cohort_batches
                  ) -> Any:
    """PerFed meta-gradient per cohort: vmap over the leading cohort dim.

    ``cohort_batches`` = {"inner": ..., "outer": ..., "hessian": ...} with
    each leaf shaped [n_cohorts, B_c, ...].  The vmap takes one cohort at a
    time (``chunk_size=1``), as each pod of the reference's mesh computes
    only its own cohort: batched together on one card, the cohorts'
    activations are held at once (four cohorts of mamba2-370m at batch 4 ×
    256 tokens ran an 80 GB H100 out of memory in the first inner
    gradient).
    """
    fl = cfg.fl
    loss = _scalar_loss(model)

    def one(batches):
        if fl.algorithm == "perfed":
            return perfed.perfed_grad(loss, params, batches, fl.alpha,
                                      first_order=fl.first_order)
        # fedavg-style plain gradient on the union batch
        return grad(loss)(params, batches["outer"])

    return vmap(one, chunk_size=1)(cohort_batches)


def uses_fused_eq8(optimizer: Optimizer, cfg: ExperimentConfig) -> bool:
    """Pure Eq. (8) — β-SGD, no clipping — is exactly the fused masked
    stale-aggregation op; anything fancier needs the masked mean first."""
    return optimizer.name == "sgd" and not cfg.train.grad_clip


def make_semi_sync_step(model, cfg: ExperimentConfig, optimizer: Optimizer,
                        n_cohorts: int) -> Callable:
    """Build the semi-synchronous round function.

    step(state, cohort_batches, mask, gen=None) -> (state, metrics)
      mask: float [n_cohorts] on the params' device — π_k (1 = this
      cohort's gradient arrives now).  Nothing syncs with the host.
    """
    fl = cfg.fl
    fused_eq8 = uses_fused_eq8(optimizer, cfg)

    def step_fn(state: SemiSyncState, cohort_batches, mask: torch.Tensor,
                gen: Optional[torch.Generator] = None
                ) -> Tuple[SemiSyncState, Dict[str, torch.Tensor]]:
        zero = torch.zeros((), dtype=torch.float32, device=mask.device)
        # -- 1) server update from arriving (possibly stale) gradients -------
        if fused_eq8:
            gnorm = zero
            new_params = stale_aggregate_tree(state.params, state.buffers,
                                              mask, beta=fl.beta)
            new_opt = state.opt_state
        else:
            agg = masked_aggregate_tree(state.buffers, mask)
            if cfg.train.grad_clip:
                agg, gnorm = clip_by_global_norm(agg, cfg.train.grad_clip)
            else:
                gnorm = zero
            new_params, new_opt = optimizer.update(agg, state.opt_state,
                                                   state.params, fl.beta)

        # -- 2) refresh buffers: scheduled cohorts (+ over-stale ones) -------
        refresh = (mask > 0) | (state.staleness > fl.staleness_bound)
        fresh = _cohort_grads(model, cfg, new_params, cohort_batches)
        new_buffers = tree_map(
            lambda buf, fg: torch.where(
                refresh.reshape((-1,) + (1,) * (buf.ndim - 1)),
                fg.to(buf.dtype), buf),
            state.buffers, fresh)

        # -- 3) staleness bookkeeping ----------------------------------------
        new_staleness = torch.where(refresh, 0, state.staleness + 1)

        metrics = {
            "grad_norm": gnorm,
            "participants": mask.sum(),
            "max_staleness": new_staleness.max(),
        }
        return SemiSyncState(new_params, new_opt, new_buffers,
                             new_staleness.to(torch.int32),
                             state.step + 1), metrics

    return step_fn


# ---------------------------------------------------------------------------
# Plain train step (non-FL baseline)
# ---------------------------------------------------------------------------

class TrainState(NamedTuple):
    params: Any
    opt_state: Any
    step: torch.Tensor


def init_train_state(model, gen: Optional[torch.Generator],
                     optimizer: Optimizer) -> TrainState:
    params = model.init(gen)
    device = tree_leaves(params)[0].device
    return TrainState(params, optimizer.init(params),
                      torch.zeros((), dtype=torch.int32, device=device))


def make_train_step(model, cfg: ExperimentConfig, optimizer: Optimizer,
                    *, perfed_step: bool = True) -> Callable:
    """Single-cohort training step.

    ``perfed_step=True`` → the paper-faithful Per-FedAvg step (inner adapt +
    outer grad + HVP correction, Eq. 7).  ``False`` → plain LM gradient step
    (the FedAvg / standard baseline).
    """
    fl = cfg.fl
    loss = _scalar_loss(model)

    def step_fn(state: TrainState, batches,
                gen: Optional[torch.Generator] = None
                ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        if perfed_step:
            grads = perfed.perfed_grad(loss, state.params, batches, fl.alpha,
                                       first_order=fl.first_order)
            with torch.no_grad():
                value = perfed.perfed_loss(loss, state.params, batches,
                                           fl.alpha)
        else:
            grads = grad(loss)(state.params, batches["outer"])
            with torch.no_grad():
                value = loss(state.params, batches["outer"])
        if cfg.train.grad_clip:
            grads, gnorm = clip_by_global_norm(grads, cfg.train.grad_clip)
        else:
            gnorm = torch.zeros((), dtype=torch.float32,
                                device=state.step.device)
        lr = fl.beta if perfed_step else cfg.train.learning_rate
        new_params, new_opt = optimizer.update(grads, state.opt_state,
                                               state.params, lr)
        return TrainState(new_params, new_opt, state.step + 1), {
            "loss": value, "grad_norm": gnorm}

    return step_fn
