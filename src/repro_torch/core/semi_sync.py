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
Per-FedAvg.  The port's losses take no randomness (as the reference's LM
losses ignore their key), so the step takes an optional
``torch.Generator`` where the reference takes a key, and passes it to no
loss.

The step runs on plain tensors (every cohort on one device) or on a state
of DTensors placed by ``launch/specs.state_shardings`` on a
``DeviceMesh``, the reference's mesh mapping:

* the buffers' cohort dim sits on ``pod`` (each pod holds its own cohorts'
  pending gradients), the rest of every buffer like its param;
* Eq. 8 (the fused path) first gathers the buffers over ``pod`` (every
  rank then holds all C rows of its own param shard, so the cohort sum
  stays local), then runs ``stale_aggregate_flat`` once a round on each
  rank's local shards through ``local_map``: Eq. 8 is elementwise over N;
* otherwise the masked mean is taken on the local shards alike, placed
  like the params; clipping takes the norm over every shard of every leaf,
  and the server Adam runs its kernel once a leaf on the local shards
  (``fused_adam_tree``'s mesh route);
* each pod computes the meta-gradients of its own cohorts, one at a time,
  on the (data, model) sub-mesh, and writes its own buffer rows; params,
  buffers and batches stay sharded throughout.

Both steps take ``donate`` (default False), the counterpart of the
reference's ``jax.jit(step, donate_argnums=(0,))``: a donated step updates
the state it is given in place and returns that same state, every tensor
leaf the argument's own tensor (the same storage, on a mesh each DTensor's
local shard), with the same bits as the undonated step's new state.  It
holds no second copy of the params, moments or buffer bank: Eq. 8 and the
fused Adam launch their in-place kernel instances, the other optimizers
write leaf by leaf, and each refreshed buffer row is written into its slot
as soon as its meta-gradient is made.  The writes keep the functional
step's order: Eq. 8 (or the optimizer) reads every buffer row before any
row is refreshed, and every refresh computes its meta-gradient at the
updated params; each write happens after the last use of the tensor it
overwrites by any autograd graph, under ``no_grad``.

Both routes take the cohorts one at a time (the reference vmaps them: on
its mesh each pod holds one), and both differentiate through
``torch.autograd`` (``perfed``'s ``autograd=True``: the Hessian-vector
product by reverse over reverse): DTensors have no forward-mode AD, under
a ``torch.func`` transform the model code cannot read a DTensor's layout,
and one route for both keeps a world-1 mesh bitwise equal to the plain
step.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import sharding
from repro_torch.config import ExperimentConfig
from repro_torch.core import perfed
from repro_torch.kernels.stale_aggregate import (masked_aggregate_tree,
                                                 stale_aggregate_tree,
                                                 stale_aggregate_update)
from repro_torch.optim import Optimizer, clip_by_global_norm
from repro_torch.sharding import write_into
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


class SemiSyncState(NamedTuple):
    """A semi-synchronous step's state.  An undonated step leaves it as it
    was and returns a new one; after a donated step (``donate=True``) the
    caller's state *is* the new one: every tensor in it was updated in
    place, and the step returned it."""
    params: Any                  # meta model w_k
    opt_state: Any               # server optimizer state (empty for β-SGD)
    buffers: Any                 # per-cohort pending grads [n_cohorts, ...]
    staleness: torch.Tensor      # [n_cohorts] int32 — rounds since refresh
    step: torch.Tensor           # round counter k


def _init_params(model, gen, device):
    return model.init(gen) if device is None else model.init(gen,
                                                             device=device)


def init_state(model, gen: Optional[torch.Generator], optimizer: Optimizer,
               n_cohorts: int, *, device=None, mesh=None,
               rules: Optional[sharding.AxisRules] = None) -> SemiSyncState:
    """Params from ``model.init(gen)`` (on ``gen``'s device, or ``device``;
    ``"meta"`` for shapes only); zero buffers in the params' dtypes.  With
    a ``mesh`` the state is DTensors placed by ``state_shardings`` (params
    by ``rules``), each rank holding only its shards."""
    params = _init_params(model, gen, device)
    dev = tree_leaves(params)[0].device
    state = SemiSyncState(
        params=params,
        opt_state=optimizer.init(params),
        buffers=tree_map(lambda p: torch.empty(
            (n_cohorts,) + tuple(p.shape), dtype=p.dtype, device="meta"),
            params),
        staleness=torch.zeros((n_cohorts,), dtype=torch.int32, device=dev),
        step=torch.zeros((), dtype=torch.int32, device=dev),
    )
    if mesh is None:
        return state._replace(buffers=tree_map(
            lambda b: torch.zeros(b.shape, dtype=b.dtype, device=dev),
            state.buffers))
    from repro_torch.launch.specs import state_shardings
    pl = state_shardings(state, sharding.param_placements(params, mesh,
                                                          rules), mesh)
    return SemiSyncState(
        params=sharding.distribute(params, pl.params, mesh),
        opt_state=sharding.distribute(state.opt_state, pl.opt_state, mesh),
        buffers=tree_map(lambda b, p: sharding.zeros(b.shape, b.dtype, p,
                                                     mesh, dev),
                         state.buffers, pl.buffers),
        staleness=sharding.distribute(state.staleness, pl.staleness, mesh),
        step=sharding.distribute(state.step, pl.step, mesh))


def _scalar_loss(model):
    def fn(p, batch):
        out = model.loss(p, batch)
        return out[0] if isinstance(out, tuple) else out
    return fn


def _meta_grad(model, cfg: ExperimentConfig, params, batches) -> Any:
    """One cohort's PerFed meta-gradient (Eq. 7) through
    ``torch.autograd`` (the HVP by reverse over reverse); fedavg-style
    algorithms take the plain gradient on the outer batch."""
    fl = cfg.fl
    loss = _scalar_loss(model)
    if fl.algorithm == "perfed":
        return perfed.perfed_grad(loss, params, batches, fl.alpha,
                                  first_order=fl.first_order, autograd=True)
    return perfed.grad_autograd(loss, params, batches["outer"])


def uses_fused_eq8(optimizer: Optimizer, cfg: ExperimentConfig) -> bool:
    """Pure Eq. (8) — β-SGD, no clipping — is exactly the fused masked
    stale-aggregation op; anything fancier needs the masked mean first."""
    return optimizer.name == "sgd" and not cfg.train.grad_clip


# ---------------------------------------------------------------------------
# the mesh route's pieces
# ---------------------------------------------------------------------------

def _mesh_of(tree):
    from torch.distributed.tensor import DTensor
    leaf = tree_leaves(tree)[0]
    return leaf.device_mesh if isinstance(leaf, DTensor) else None


@contextlib.contextmanager
def _on_mesh(mesh):
    """The params' mesh active (with the rules in force), or nothing.  On
    a mesh the step's backward passes run on the calling thread: the
    recomputation of checkpointed layers (``cfg.remat``) on DTensors on
    autograd's device thread gave gradients that changed from run to run
    on the card (torch 2.11, mamba2 at 8 layers and more); on the calling
    thread they are bitwise the plain step's."""
    if mesh is None:
        yield
        return
    with sharding.use_mesh(mesh, sharding.active_rules()), \
            torch.autograd.set_multithreading_enabled(False):
        yield


def _local(x):
    """A replicated DTensor's (or a plain tensor's) values on this rank."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        if not all(p.is_replicate() for p in x.placements):
            raise ValueError(f"expected a replicated DTensor, got "
                             f"{x.placements}")
        return x.to_local()
    return x


def _like(new, old):
    """``new`` redistributed to ``old``'s placements (a step's outputs keep
    their inputs' layout, as the reference's out_shardings do)."""
    return sharding.redistribute(new, old.placements)


def _gather_cohorts(buffers):
    """The buffers replicated over ``pod``: every rank then holds all C rows
    of its own param shard."""
    from torch.distributed.tensor import Replicate
    b0 = tree_leaves(buffers)[0]
    names = list(b0.device_mesh.mesh_dim_names)
    if "pod" not in names:
        return buffers
    i = names.index("pod")
    return tree_map(lambda b: sharding.redistribute(b, tuple(
        Replicate() if j == i else p for j, p in enumerate(b.placements))),
        buffers)


def _over_local_shards(fn, params, buffers, mask):
    """``fn(param leaves, buffer leaves, mask)`` on this rank's local shards
    (leaves in ``tree_leaves`` order) through ``local_map``, the buffers
    gathered over ``pod`` first; ``fn`` returns one local tensor a param
    leaf, placed back like that param."""
    from torch.distributed.tensor.experimental import local_map
    p_leaves = tree_leaves(params)
    b_leaves = tree_leaves(_gather_cohorts(buffers))
    for p in p_leaves:
        sharding.check_even(p)
    out = local_map(
        fn, out_placements=tuple(p.placements for p in p_leaves),
        in_placements=tuple(x.placements for x in p_leaves + b_leaves)
        + (None,),
        device_mesh=p_leaves[0].device_mesh,
    )(p_leaves, b_leaves, _local(mask).to(torch.float32))
    return tree_unflatten(params, out)


def _eq8_local(pl, bl, m, *, beta, inplace):
    """Eq. (8) on one rank's local shards: the param leaves ``pl`` and
    buffer leaves ``bl`` flattened to f32 [N] and [C, N], the kernel once
    (into the flat copy of the params with ``inplace``); returns each
    leaf's f32 slice of the result."""
    c = m.shape[0]
    flat = stale_aggregate_update(
        torch.cat([x.reshape(-1).to(torch.float32) for x in pl]),
        torch.cat([x.reshape(c, -1).to(torch.float32) for x in bl], dim=1),
        m, beta=beta, inplace=inplace)
    out, o = [], 0
    for x in pl:
        out.append(flat[o:o + x.numel()].reshape(x.shape))
        o += x.numel()
    return out


def _stale_aggregate_mesh(params, buffers, mask, *, beta, inplace=False):
    """Fused Eq. (8) on DTensors: the kernel (``stale_aggregate_flat``)
    once on each rank's local shards (params [N], buffers [C, N]).  With
    ``inplace`` each param's local shard takes its slice back in place
    (the gathered buffers are only read) and ``params`` is returned."""
    if not inplace:
        return _over_local_shards(
            lambda pl, bl, m: [f.to(x.dtype) for f, x in zip(
                _eq8_local(pl, bl, m, beta=beta, inplace=False), pl)],
            params, buffers, mask)
    p_leaves = tree_leaves(params)
    for p in p_leaves:
        sharding.check_even(p)
    with torch.no_grad():
        pl = [p.to_local() for p in p_leaves]
        flat = _eq8_local(pl, [b.to_local() for b in tree_leaves(
            _gather_cohorts(buffers))], _local(mask).to(torch.float32),
            beta=beta, inplace=True)
        for x, f in zip(pl, flat):
            x.copy_(f)
    return params


def _masked_aggregate_mesh(params, buffers, mask):
    """The masked mean of the buffers on DTensors, placed like the params
    (``masked_aggregate_tree`` on each rank's local shards)."""
    return _over_local_shards(
        lambda pl, bl, m: [masked_aggregate_tree(b, m) for b in bl],
        params, buffers, mask)


def _cohort_view(x, j, sub, pod):
    """Cohort ``j`` of this rank's local rows of a batch leaf [C, B, ...],
    as a DTensor on the sub-mesh ``sub`` (the mesh without ``pod``)."""
    from torch.distributed.tensor import DTensor, Shard
    pl = list(x.placements)
    if pod is not None:
        del pl[pod]
    if any(p.is_shard() and p.dim == 0 for p in pl):
        raise ValueError("the cohort dim of a batch may be split over pod "
                         "only")
    pl = [Shard(p.dim - 1) if p.is_shard() else p for p in pl]
    shape = x.shape[1:]
    return DTensor.from_local(x.to_local()[j], sub, pl, run_check=False,
                              shape=shape,
                              stride=sharding.contiguous_stride(shape))


def _refresh_mesh(model, cfg, params, cohort_batches, buffers, refresh, *,
                  inplace=False):
    """Each pod's cohorts, one at a time on the (data, model) sub-mesh:
    fresh meta-gradients against ``params`` where ``refresh``, the old
    buffer row elsewhere.  Returns the new buffers, placed as before; with
    ``inplace`` each row is written into this rank's own local rows of
    ``buffers`` once its meta-gradient is made, and ``buffers`` is
    returned."""
    from torch.distributed.tensor import DTensor
    mesh = _mesh_of(params)
    names = list(mesh.mesh_dim_names)
    pod = names.index("pod") if "pod" in names else None
    sub = mesh[tuple(n for n in names if n != "pod")] if pod is not None \
        else mesh

    def to_sub(x):
        pl = list(x.placements)
        if pod is not None:
            if not pl[pod].is_replicate():
                raise ValueError("params must be replicated over pod")
            del pl[pod]
        return DTensor.from_local(x.to_local(), sub, pl, run_check=False,
                                  shape=x.shape, stride=x.stride())

    sub_params = tree_map(to_sub, params)
    b0 = tree_leaves(buffers)[0]
    c_loc = b0.to_local().shape[0]
    _, off = sharding.local_box(b0.shape, b0.placements, mesh)
    refresh = _local(refresh)
    batches = tree_map(lambda x: sharding.distribute(
        x, sharding.placements_for(
            ("clients", "batch") + (None,) * (x.ndim - 2), mesh), mesh)
        if not isinstance(x, DTensor) else x, cohort_batches)
    rows = []
    for j in range(c_loc):
        cb = tree_map(lambda x: _cohort_view(x, j, sub, pod), batches)
        with sharding.use_mesh(sub, sharding.active_rules()):
            fresh = _meta_grad(model, cfg, sub_params, cb)
        row = tree_map(
            lambda f, b: torch.where(refresh[off[0] + j],
                                     f.to_local().to(b.dtype),
                                     b.to_local()[j]),
            fresh, buffers)
        del fresh
        if not inplace:
            rows.append(row)
            continue
        with torch.no_grad():
            for b, r in zip(tree_leaves(buffers), tree_leaves(row)):
                b.to_local()[j].copy_(r)
    if inplace:
        return buffers
    return tree_map(lambda b, *r: DTensor.from_local(
        torch.stack(r), mesh, b.placements, run_check=False, shape=b.shape,
        stride=b.stride()), buffers, *rows)


def make_semi_sync_step(model, cfg: ExperimentConfig, optimizer: Optimizer,
                        n_cohorts: int, *, donate: bool = False) -> Callable:
    """Build the semi-synchronous round function.

    step(state, cohort_batches, mask, gen=None) -> (state, metrics)
      mask: float [n_cohorts] on the params' device — π_k (1 = this
      cohort's gradient arrives now).  Nothing syncs with the host.
      A state of DTensors takes the mesh route (module docstring); its
      batches may be plain tensors (each rank holding all of them) or
      DTensors placed by ``train_batch_specs``.

    With ``donate`` the step updates ``state`` in place and returns it:
    after the call the caller's old state *is* the new one (module
    docstring).
    """
    fl = cfg.fl
    fused_eq8 = uses_fused_eq8(optimizer, cfg)

    def step_fn(state: SemiSyncState, cohort_batches, mask: torch.Tensor,
                gen: Optional[torch.Generator] = None
                ) -> Tuple[SemiSyncState, Dict[str, torch.Tensor]]:
        mesh = _mesh_of(state.params)
        with _on_mesh(mesh):
            zero = torch.zeros((), dtype=torch.float32, device=mask.device)
            # -- 1) server update from arriving (possibly stale) gradients --
            if fused_eq8:
                gnorm = zero
                new_params = (
                    stale_aggregate_tree(state.params, state.buffers, mask,
                                         beta=fl.beta, inplace=donate)
                    if mesh is None
                    else _stale_aggregate_mesh(state.params, state.buffers,
                                               mask, beta=fl.beta,
                                               inplace=donate))
                new_opt = state.opt_state
            else:
                agg = (masked_aggregate_tree(state.buffers, mask)
                       if mesh is None else _masked_aggregate_mesh(
                           state.params, state.buffers, mask))
                if cfg.train.grad_clip:
                    agg, gnorm = clip_by_global_norm(agg, cfg.train.grad_clip)
                else:
                    gnorm = zero
                new_params, new_opt = optimizer.update(
                    agg, state.opt_state, state.params, fl.beta,
                    inplace=donate)
                # the f32 aggregate (4 B a param) is not held through the
                # refresh
                del agg
                if mesh is not None and not donate:
                    new_params = tree_map(_like, new_params, state.params)

            # -- 2) refresh buffers: scheduled cohorts (+ over-stale ones) --
            refresh = (mask > 0) | (state.staleness > fl.staleness_bound)
            new_buffers = (_refresh_plain if mesh is None else _refresh_mesh)(
                model, cfg, new_params, cohort_batches, state.buffers,
                refresh, inplace=donate)

            # -- 3) staleness bookkeeping -------------------------------------
            new_staleness = torch.where(refresh, 0, state.staleness + 1)

            metrics = {
                "grad_norm": gnorm,
                "participants": mask.sum(),
                "max_staleness": new_staleness.max(),
            }
            if donate:
                write_into(state.staleness, new_staleness)
                write_into(state.step, state.step + 1)
                return state, metrics
            return SemiSyncState(new_params, new_opt, new_buffers,
                                 new_staleness.to(torch.int32),
                                 state.step + 1), metrics

    return step_fn


def _refresh_plain(model, cfg, params, cohort_batches, buffers, refresh, *,
                   inplace=False):
    """Every cohort, one at a time: a fresh meta-gradient where
    ``refresh``, the old buffer row elsewhere.  (Batched together on one
    card, the cohorts' activations would be held at once: four cohorts of
    mamba2-370m at batch 4 × 256 tokens ran an 80 GB H100 out of memory.)
    With ``inplace`` each cohort's row is written into ``buffers``' own
    slot, a leaf at a time, as soon as its meta-gradient is made (no
    stacked copy), and ``buffers`` is returned."""
    rows = []
    for c in range(refresh.shape[0]):
        fresh = _meta_grad(model, cfg, params,
                           tree_map(lambda x: x[c], cohort_batches))
        if inplace:
            with torch.no_grad():
                for f, b in zip(tree_leaves(fresh), tree_leaves(buffers)):
                    b[c].copy_(torch.where(refresh[c], f.to(b.dtype), b[c]))
            del fresh
            continue
        rows.append([torch.where(refresh[c], f.to(b.dtype), b[c])
                     for f, b in zip(tree_leaves(fresh),
                                     tree_leaves(buffers))])
        del fresh
    if inplace:
        return buffers
    # stacked a leaf at a time, each leaf's rows dropped once stacked, so
    # the rows and the new buffers are not held whole at once
    out = []
    for i in range(len(rows[0])):
        out.append(torch.stack([r[i] for r in rows]))
        for r in rows:
            r[i] = None
    return tree_unflatten(buffers, out)


# ---------------------------------------------------------------------------
# Plain train step (non-FL baseline)
# ---------------------------------------------------------------------------

class TrainState(NamedTuple):
    """A plain train step's state; after a donated step (``donate=True``)
    the caller's state *is* the new one, updated in place."""
    params: Any
    opt_state: Any
    step: torch.Tensor


def init_train_state(model, gen: Optional[torch.Generator],
                     optimizer: Optimizer, *, device=None) -> TrainState:
    params = _init_params(model, gen, device)
    device = tree_leaves(params)[0].device
    return TrainState(params, optimizer.init(params),
                      torch.zeros((), dtype=torch.int32, device=device))


def make_train_step(model, cfg: ExperimentConfig, optimizer: Optimizer,
                    *, perfed_step: bool = True,
                    donate: bool = False) -> Callable:
    """Single-cohort training step.

    ``perfed_step=True`` → the paper-faithful Per-FedAvg step (inner adapt +
    outer grad + HVP correction, Eq. 7).  ``False`` → plain LM gradient step
    (the FedAvg / standard baseline).  A state of DTensors runs on their
    mesh; both differentiate through ``torch.autograd``, as the
    semi-synchronous step does.  With ``donate`` the step writes the new
    params, optimizer state and step into ``state``'s own tensors (after
    the gradients are made) and returns ``state``: the caller's old state
    *is* the new one.
    """
    fl = cfg.fl
    loss = _scalar_loss(model)

    def step_fn(state: TrainState, batches,
                gen: Optional[torch.Generator] = None
                ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        mesh = _mesh_of(state.params)
        with _on_mesh(mesh):
            return _train_step(state, batches, mesh)

    def _train_step(state, batches, mesh):
        if perfed_step:
            grads = perfed.perfed_grad(loss, state.params, batches, fl.alpha,
                                       first_order=fl.first_order,
                                       autograd=True)
            with torch.no_grad():
                value = perfed.perfed_loss(loss, state.params, batches,
                                           fl.alpha, autograd=True)
        else:
            grads = perfed.grad_autograd(loss, state.params,
                                         batches["outer"])
            with torch.no_grad():
                value = loss(state.params, batches["outer"])
        if cfg.train.grad_clip:
            grads, gnorm = clip_by_global_norm(grads, cfg.train.grad_clip)
        else:
            gnorm = torch.zeros((), dtype=torch.float32,
                                device=state.step.device)
        lr = fl.beta if perfed_step else cfg.train.learning_rate
        metrics = {"loss": value, "grad_norm": gnorm}
        if donate:
            optimizer.update(grads, state.opt_state, state.params, lr,
                             inplace=True)
            write_into(state.step, state.step + 1)
            return state, metrics
        new_params, new_opt = optimizer.update(grads, state.opt_state,
                                               state.params, lr)
        if mesh is not None:
            new_params = tree_map(_like, new_params, state.params)
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return step_fn
