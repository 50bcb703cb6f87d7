"""Abstract input/state specs for the dry run (meta tensors, no allocation).

The port of the JAX package's ``launch/specs.py``.  ``build_case(cfg,
shape, mesh, ...)`` returns everything ``dryrun.py`` needs: the step
function, abstract arguments (tensors on the ``meta`` device) and their
DTensor placements in and out.  Placements stand where the reference has
``NamedSharding``s; ``sharding.placements_spec`` reads them back as the
reference's per-dim mesh axes.

Sharding policy (resolved per-arch by divisibility):
  params        2-D sharded by repro_torch.sharding rules (feature→model,
                embed→data)
  batch dims    → ("pod","data")
  decode caches → heads→model if divisible else seq→model; batch→data if
                  divisible else left whole
  semi-sync cohort buffers → cohort axis on "pod"
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch import sharding
from repro_torch.config import (ExperimentConfig, FLConfig, ModelConfig,
                                ShapeConfig, TrainConfig)
from repro_torch.core import semi_sync
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.sharding import mesh_shape, spec_placements
from repro_torch.utils.tree import tree_map

META = "meta"


def _abs(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _divides(n: int, k: int) -> bool:
    return k > 0 and n > 0 and n % k == 0


def _spec(mesh, *axes) -> tuple:
    """Placements of a per-dim spec, axes absent from the mesh dropped."""
    names = set(mesh.mesh_dim_names)

    def keep(a):
        if a is None:
            return None
        a = tuple(x for x in ((a,) if isinstance(a, str) else a)
                  if x in names)
        return None if not a else (a[0] if len(a) == 1 else a)

    return spec_placements(tuple(keep(a) for a in axes), mesh)


def arch_rules(cfg: ModelConfig, mesh) -> sharding.AxisRules:
    """Per-arch rule overrides driven by divisibility constraints."""
    rules = sharding.AxisRules()
    msize = mesh_shape(mesh).get("model", 1)
    over = {}
    if cfg.moe is not None and not _divides(cfg.moe.num_experts, msize):
        # too few experts for the model axis (mixtral 8e on 16): let the
        # expert FFN dim take the model axis instead (dense-TP style)
        over["experts"] = ()
    if cfg.vocab_size and not _divides(cfg.vocab_size, msize):
        over["vocab"] = ()
    if over:
        rules = rules.with_overrides(**over)
    return rules


def batch_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes carrying the batch dim — honours the active rule set
    (pure-DP setups map batch over the model axis too)."""
    cand = sharding.active_rules().rules.get("batch", ("pod", "data"))
    return tuple(a for a in cand if a in mesh.mesh_dim_names)


def _batch_size(mesh, axes) -> int:
    ms = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= ms[a]
    return n


# ---------------------------------------------------------------------------
# abstract batches
# ---------------------------------------------------------------------------

def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                      triplet: bool = True, n_cohorts: int = 0):
    """Abstract train batch (the Eq.-7 triplet), plus placements."""
    b, s = shape.global_batch, shape.seq_len
    lead = (n_cohorts, b // max(n_cohorts, 1)) if n_cohorts else (b,)
    tok_shape = lead + (s,)
    if cfg.family == "audio":
        tok_shape = tok_shape + (cfg.num_audio_codebooks,)

    def one_batch():
        d = {"tokens": _abs(tok_shape, torch.int32),
             "targets": _abs(tok_shape, torch.int32)}
        if cfg.family == "vlm":
            img = lead + (cfg.num_image_tokens, cfg.d_model)
            d["image_embeds"] = _abs(img, getattr(torch, cfg.dtype))
        return d

    batch = ({"inner": one_batch(), "outer": one_batch(),
              "hessian": one_batch()} if triplet else one_batch())

    ba = batch_axes(mesh)
    if n_cohorts:
        # cohort → pod, per-cohort batch → data
        placements = tree_map(lambda _: _spec(mesh, "pod", "data"), batch)
    else:
        placements = tree_map(lambda _: _spec(mesh, ba), batch)
    return batch, placements


def decode_inputs_specs(cfg: ModelConfig, shape: ShapeConfig, mesh):
    b = shape.global_batch
    tok_shape = (b, 1) if cfg.family != "audio" \
        else (b, 1, cfg.num_audio_codebooks)
    tokens = _abs(tok_shape, torch.int32)
    pos = _abs((), torch.int32)
    ba = batch_axes(mesh)
    tok_pl = _spec(mesh, ba) if _divides(b, _batch_size(mesh, ba)) \
        else _spec(mesh)
    return tokens, pos, tok_pl, _spec(mesh)


# ---------------------------------------------------------------------------
# cache sharding
# ---------------------------------------------------------------------------

def cache_shardings(cache_abs, mesh, batch: int, policy: str = "auto"):
    """Assign placements to an abstract cache tree by leaf path.

    ``policy="replicate"``: keep the whole cache replicated — for tiny-batch
    long-context decode this trades per-device memory for ZERO cache
    collectives (§Perf lever for the collective-bound long_500k cases).
    """
    ms = mesh_shape(mesh)
    dsize = ms.get("data", 1)
    msize = ms.get("model", 1)
    batch_ok = _divides(batch, dsize)
    if policy == "replicate":
        return tree_map(lambda _: _spec(mesh), cache_abs)

    def assign(path, leaf):
        dims: list = [None] * leaf.ndim
        # layout conventions (see models/*.init_cache):
        #   k/v   [L, B, S, H, D]      pos [L, B, S]
        #   ckv   [L, B, S, R]         kr  [L, B, S, R]
        #   conv  [L, B, W, C]         state [L, B, H, P, N]   h [L, B, W]
        if leaf.ndim >= 2 and batch_ok:
            dims[1] = "data"
        key = path[-1]
        if key in ("k", "v") and leaf.ndim == 5:
            if _divides(leaf.shape[3], msize):
                dims[3] = "model"
            elif _divides(leaf.shape[2], msize):
                dims[2] = "model"
        elif key in ("ckv", "kr") and leaf.ndim == 4:
            if _divides(leaf.shape[2], msize):
                dims[2] = "model"
        elif key == "conv" and leaf.ndim == 4:
            if _divides(leaf.shape[3], msize):
                dims[3] = "model"
        elif key == "state" and leaf.ndim == 5:
            if _divides(leaf.shape[2], msize):
                dims[2] = "model"
            elif _divides(leaf.shape[3], msize):
                dims[3] = "model"
        elif key == "h" and leaf.ndim == 3:
            if _divides(leaf.shape[2], msize):
                dims[2] = "model"
        return _spec(mesh, *dims)

    return sharding._map_with_path(assign, cache_abs)


# ---------------------------------------------------------------------------
# state sharding
# ---------------------------------------------------------------------------

def state_shardings(state_abs, params_placements, mesh):
    """Placements for TrainState / SemiSyncState given the params'."""
    from torch.distributed.tensor import Shard
    names = list(mesh.mesh_dim_names)
    if isinstance(state_abs, semi_sync.SemiSyncState):
        # buffers: cohort leading dim → pod, rest like params (one dim
        # further along)
        def buf_pl(pl):
            out = [Shard(p.dim + 1) if p.is_shard() else p for p in pl]
            if "pod" in names:
                out[names.index("pod")] = Shard(0)
            return tuple(out)
        buf_sh = tree_map(buf_pl, params_placements)
        opt_sh = _opt_shardings(state_abs.opt_state, params_placements, mesh)
        return semi_sync.SemiSyncState(
            params=params_placements, opt_state=opt_sh, buffers=buf_sh,
            staleness=_spec(mesh, None), step=_spec(mesh))
    opt_sh = _opt_shardings(state_abs.opt_state, params_placements, mesh)
    return semi_sync.TrainState(params=params_placements, opt_state=opt_sh,
                                step=_spec(mesh))


def _opt_shardings(opt_abs, params_placements, mesh):
    if isinstance(opt_abs, tuple) and len(opt_abs) == 0:
        return ()
    out = {}
    for key, sub in opt_abs.items():
        if key in ("m", "v"):
            out[key] = params_placements
        else:
            out[key] = tree_map(lambda _: _spec(mesh), sub)
    return out


# ---------------------------------------------------------------------------
# case builder
# ---------------------------------------------------------------------------

class LowerCase(NamedTuple):
    name: str
    fn: Callable            # runs on DTensors placed by in_shardings
    args: Tuple             # abstract args (meta tensors)
    in_shardings: Tuple     # placements trees matching args
    out_shardings: Any      # placements trees matching fn's outputs
    meta: Dict[str, Any]


def build_case(model_cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               fl: Optional[FLConfig] = None,
               train: Optional[TrainConfig] = None,
               moe_impl: str = "gather",
               semi_sync_cohorts: Optional[int] = None,
               perfed_step: bool = True,
               cache_policy: str = "auto",
               rules: Optional[sharding.AxisRules] = None,
               seed: int = 0, donate: bool = False) -> LowerCase:
    """Assemble one (arch × shape × mesh) case.  Params are abstract, so
    ``seed`` draws nothing; it is kept for the reference's signature.

    ``donate`` means what the reference's ``donate_argnums`` means for the
    case: a train step updates its state (argument 0) in place and returns
    it (``donate=True`` of the steps); a decode step writes its cache
    (argument 1) in place, as the port's ring always does.  Undonated, the
    decode step first copies the cache, so that, as in the reference, its
    argument stays as it was.  Prefill donates nothing that any output
    could take."""
    fl = fl or FLConfig()
    train = train or TrainConfig(seq_len=shape.seq_len,
                                 global_batch_size=shape.global_batch)
    cfg = dataclasses.replace(model_cfg, max_seq_len=max(model_cfg.max_seq_len,
                                                         shape.seq_len))
    exp = ExperimentConfig(model=cfg, fl=fl, train=train)
    model = build_model(cfg, moe_impl=moe_impl)
    rules = rules or arch_rules(cfg, mesh)

    params_abs = model.init(None, device=META)
    psh = sharding.param_placements(params_abs, mesh, rules)

    meta = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_shape(mesh),
            "kind": shape.kind}
    rep = _spec(mesh)

    if shape.kind == "train":
        optimizer = make_optimizer("sgd")   # Alg.-1 server = β-SGD (faithful)
        if semi_sync_cohorts and semi_sync_cohorts > 1:
            step = semi_sync.make_semi_sync_step(model, exp, optimizer,
                                                 semi_sync_cohorts,
                                                 donate=donate)
            state_abs = semi_sync.init_state(model, None, optimizer,
                                             semi_sync_cohorts, device=META)
            batch_abs, batch_sh = train_batch_specs(
                cfg, shape, mesh, triplet=True, n_cohorts=semi_sync_cohorts)
            mask_abs = _abs((semi_sync_cohorts,), torch.float32)
            args = (state_abs, batch_abs, mask_abs)
            st_sh = state_shardings(state_abs, psh, mesh)
            in_sh = (st_sh, batch_sh, _spec(mesh, None))
            out_sh = (st_sh, {"grad_norm": rep, "participants": rep,
                              "max_staleness": rep})
            name = f"{cfg.name}:{shape.name}:semi_sync"
        else:
            step = semi_sync.make_train_step(model, exp, optimizer,
                                             perfed_step=perfed_step,
                                             donate=donate)
            state_abs = semi_sync.init_train_state(model, None, optimizer,
                                                   device=META)
            batch_abs, batch_sh = train_batch_specs(cfg, shape, mesh,
                                                    triplet=True)
            args = (state_abs, batch_abs)
            st_sh = state_shardings(state_abs, psh, mesh)
            in_sh = (st_sh, batch_sh)
            out_sh = (st_sh, {"loss": rep, "grad_norm": rep})
            name = f"{cfg.name}:{shape.name}:perfed" if perfed_step \
                else f"{cfg.name}:{shape.name}:plain"
        return LowerCase(name, step, args, in_sh, out_sh, meta)

    if shape.kind == "prefill":
        batch_abs, batch_sh = train_batch_specs(cfg, shape, mesh,
                                                triplet=False)
        cache_len = min(shape.seq_len, _cache_len(cfg, shape))
        cache_abs = model.init_cache(shape.global_batch, cache_len,
                                     device=META)
        csh = cache_shardings(cache_abs, mesh, shape.global_batch)

        def prefill_fn(params, tokens, image_embeds=None):
            # the cache to fill, placed on the mesh (the ssm family makes
            # its own and ignores it)
            kw = {"cache": sharding.distribute(model.init_cache(
                shape.global_batch, cache_len, device=META), csh, mesh)}
            if cfg.family == "vlm":
                kw["image_embeds"] = image_embeds
            return model.prefill(params, tokens, cache_len, **kw)

        args = [params_abs, batch_abs["tokens"]]
        in_sh = [psh, batch_sh["tokens"]]
        if cfg.family == "vlm":
            args.append(batch_abs["image_embeds"])
            in_sh.append(batch_sh["image_embeds"])
        ba = batch_axes(mesh)
        logit_sh = _spec(mesh, ba)
        return LowerCase(f"{cfg.name}:{shape.name}:prefill", prefill_fn,
                         tuple(args), tuple(in_sh), (logit_sh, csh), meta)

    # decode
    tokens_abs, pos_abs, tok_sh, pos_sh = decode_inputs_specs(cfg, shape, mesh)
    cache_len = _cache_len(cfg, shape)
    window = _decode_window(cfg, shape)
    cache_abs = model.init_cache(shape.global_batch, cache_len, device=META)
    csh = cache_shardings(cache_abs, mesh, shape.global_batch,
                          policy=cache_policy)

    def decode_fn(params, cache, tokens, pos, img=None):
        kw = {"window": window} if window is not None else {}
        pos = pos.to_local()            # replicated: the same on every rank
        if not donate:
            cache = tree_map(_copy_local, cache)
        if cfg.family == "vlm":
            kw["image_embeds"] = img
        return model.decode_step(params, cache, tokens, pos, **kw)

    args = [params_abs, cache_abs, tokens_abs, pos_abs]
    in_sh = [psh, csh, tok_sh, pos_sh]
    if cfg.family == "vlm":
        args.append(_abs((shape.global_batch, cfg.num_image_tokens,
                          cfg.d_model), getattr(torch, cfg.dtype)))
        ba = batch_axes(mesh)
        bdim = ba if _divides(shape.global_batch, _batch_size(mesh, ba)) \
            else None
        in_sh.append(_spec(mesh, bdim))
    return LowerCase(f"{cfg.name}:{shape.name}:decode", decode_fn,
                     tuple(args), tuple(in_sh), (rep, csh), meta)


def _copy_local(x: torch.Tensor) -> torch.Tensor:
    """A copy of ``x`` laid out as ``x`` is: a DTensor's local shard cloned
    (DTensor's own ``clone`` may gather a cache leaf first)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x.clone()
    return DTensor.from_local(x.to_local().clone(), x.device_mesh,
                              x.placements, run_check=False, shape=x.shape,
                              stride=x.stride())


def _cache_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """KV-cache length: full history for decode_32k; the sliding window for
    long_500k (sub-quadratic memory — full 524k cache is never materialised
    for attention archs; SSM/hybrid have O(1) state anyway)."""
    if cfg.family in ("ssm",):
        return 0
    if cfg.sliding_window:
        return min(shape.seq_len, cfg.sliding_window)
    if shape.seq_len > 65536:
        return cfg.long_context_window
    return shape.seq_len


def _decode_window(cfg: ModelConfig, shape: ShapeConfig) -> Optional[int]:
    if cfg.family in ("ssm", "hybrid"):
        return None
    if cfg.sliding_window:
        return None                      # model already windows natively
    if shape.seq_len > 65536:
        return cfg.long_context_window   # sliding-window long-context variant
    return None
