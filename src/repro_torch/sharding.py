"""Logical-axis sharding rules → per-dim mesh axes → DTensor placements.

The port of the JAX package's ``sharding.py``.  The model code never names
physical mesh axes.  It tags tensors and params with *logical* axis names
("batch", "heads", "ffn", "experts", "vocab", "embed", ...), and this module
maps them onto whatever ``torch.distributed.device_mesh.DeviceMesh`` is
active:

  single-pod  : (data=16, model=16)
  multi-pod   : (pod=2, data=16, model=16)

``logical_spec`` resolves names to the reference's ``PartitionSpec`` as a
plain tuple, one entry a tensor dim: a mesh-axis name, a tuple of names, or
``None``.  ``spec_placements`` turns that into DTensor placements, one a
mesh dim.  A tensor dim split over ``("pod", "data")`` becomes ``Shard(d)``
on both mesh dims, ``pod`` major: DTensor splits a dim by its mesh dims in
mesh order, the order ``PartitionSpec`` gives it.  A spec that names its
axes against mesh order has no DTensor placement and raises.

Resolution reads only the mesh's dim names and sizes, so it is the same on
a real mesh (gloo, nccl) and on a fake one (the ``"fake"`` backend), which
the dry run uses.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field, replace
from typing import Dict, Optional, Sequence, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axis, ...]


@dataclass(frozen=True)
class AxisRules:
    """Logical-name → tuple of candidate physical axes.

    For each logical axis we keep an ordered tuple of physical axes; at spec
    resolution time the first subset of axes present in the active mesh (and
    not already consumed by another dimension of the same tensor) is used.
    """
    rules: dict = field(default_factory=lambda: dict(
        # --- activations ---
        batch=("pod", "data"),
        seq=(),                      # sequence replicated by default
        act_embed=(),                # activation d_model replicated
        act_heads=("model",),        # attention activations split by head
        act_ffn=("model",),
        cache_batch=("data",),
        cache_seq=(),                # decode cache sequence dim
        cache_heads=("model",),
        # --- parameters (2-D sharded: feature->model, embed->data ZeRO-style) ---
        embed=("data",),             # d_model dim of weights
        heads=("model",),            # q/o head dims
        kv_heads=("model",),
        ffn=("model",),              # FFN hidden
        experts=("model",),          # MoE expert dim
        vocab=("model",),
        ssm_inner=("model",),        # mamba d_inner
        lru=("model",),              # rg-lru width
        mla_rank=(),                 # MLA latent kept replicated
        layers=(),                   # stacked scan-layer dim
        # --- FL / client axis ---
        clients=("pod",),            # semi-sync cohort axis
    ))

    def with_overrides(self, **kw) -> "AxisRules":
        d = dict(self.rules)
        d.update(kw)
        return replace(self, rules=d)


class _ShardingCtx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: AxisRules = AxisRules()


_CTX = _ShardingCtx()


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[AxisRules] = None):
    """Activate a mesh + rule set for spec resolution and ``constrain``.
    With a mesh, the plain tensors that code running on DTensors makes
    (positions, masks, scalars) count as replicated DTensors
    (``implicit_replication``), as a JAX array is whole on every device."""
    old_mesh, old_rules = _CTX.mesh, _CTX.rules
    _CTX.mesh = mesh
    if rules is not None:
        _CTX.rules = rules
    if mesh is not None:
        _register_missing_strategies()
    try:
        if mesh is None:
            yield
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield
    finally:
        _CTX.mesh, _CTX.rules = old_mesh, old_rules


def _register_missing_strategies() -> None:
    """Give DTensor a sharding strategy for ``aten.flip`` (``cumsum``'s
    backward) where its torch has none (2.11 has none; later ones do): any
    dim not flipped may stay sharded, the flipped dims are replicated."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    flip = torch.ops.aten.flip.default
    prop = DTensor._op_dispatcher.sharding_propagator
    if flip in prop.op_strategy_funcs or flip in getattr(
            prop, "op_single_dim_strategy_funcs", {}):
        return

    @register_sharding(flip)
    def _flip_strategy(x, dims):
        flipped = {d % x.ndim for d in dims}
        return [([Replicate()], [Replicate(), None])] + [
            ([Shard(d)], [Shard(d), None]) for d in range(x.ndim)
            if d not in flipped]


def active_mesh():
    return _CTX.mesh


def active_rules() -> AxisRules:
    return _CTX.rules


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} in mesh order (the reference's ``mesh.shape``)."""
    if mesh is None:
        return {}
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def logical_spec(names: Sequence[Optional[str]], mesh=None,
                 rules: Optional[AxisRules] = None) -> Spec:
    """Resolve a sequence of logical axis names to per-dim mesh axes.

    Physical axes already used by an earlier dimension of the same tensor are
    skipped (a mesh axis may shard at most one dim).
    """
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules
    if mesh is None:
        return (None,) * len(names)
    avail = set(mesh.mesh_dim_names)
    used: set = set()
    out = []
    for name in names:
        if name is None:
            out.append(None)
            continue
        cand = rules.rules.get(name, ())
        picked = tuple(a for a in cand if a in avail and a not in used)
        used.update(picked)
        if len(picked) == 0:
            out.append(None)
        elif len(picked) == 1:
            out.append(picked[0])
        else:
            out.append(picked)
    return tuple(out)


def spec_placements(spec: Spec, mesh) -> tuple:
    """Per-dim mesh axes → DTensor placements, one a mesh dim.

    ``Shard(d)`` on every mesh dim that tensor dim ``d`` names, else
    ``Replicate()``.  A dim split over several mesh axes takes them major
    first in mesh order, which is the order the spec must name them in.
    """
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} is split over {axes}, against mesh "
                             f"order {tuple(names)}: DTensor splits a dim "
                             f"major-first in mesh order")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def placements_for(names: Sequence[Optional[str]], mesh=None,
                   rules: Optional[AxisRules] = None) -> tuple:
    """``spec_placements(logical_spec(names))`` on the given or active mesh."""
    mesh = mesh or _CTX.mesh
    return spec_placements(logical_spec(names, mesh, rules), mesh)


class _Redistribute(torch.autograd.Function):
    """``DTensor.redistribute`` whose backward is itself (toward the input's
    layout), so a graph through it is differentiable twice, which the HVP
    needs; torch 2.11's own is not.  A sum over ranks (Partial) takes the
    same gradient on each rank."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = tuple(x.placements)
        return x.redistribute(x.device_mesh, tuple(placements))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        want = tuple(Replicate() if p.is_partial() else p
                     for p in ctx.placements)
        return redistribute(g, want), None


def redistribute(x: torch.Tensor, placements) -> torch.Tensor:
    """DTensor ``x`` laid out by ``placements`` (itself if it already is),
    differentiable twice."""
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    return _Redistribute.apply(x, placements)


def constrain(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """The reference's ``with_sharding_constraint`` against logical axes:
    the identity without a mesh (or on a plain tensor); a DTensor is
    redistributed to the resolved placements."""
    from torch.distributed.tensor import DTensor
    mesh = _CTX.mesh
    if mesh is None or not isinstance(x, DTensor):
        return x
    return redistribute(x, spec_placements(logical_spec(names, x.device_mesh),
                                           x.device_mesh))


def replicate_dim(x: torch.Tensor, d: int) -> torch.Tensor:
    """DTensor ``x`` with tensor dim ``d`` gathered (every mesh dim that
    shards it made ``Replicate``), the rest of its layout kept."""
    from torch.distributed.tensor import Replicate
    return redistribute(x, tuple(Replicate() if p.is_shard(d) else p
                                 for p in x.placements))


def constrain_like(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` laid out as DTensor ``like`` (a plain ``x`` is taken as
    replicated first); ``x`` as it is when ``like`` is a plain tensor."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(like, DTensor):
        return x
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, like.device_mesh,
                               (Replicate(),) * like.device_mesh.ndim,
                               run_check=False)
    return redistribute(x, like.placements)


def write_into(dst: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``src`` written into ``dst`` in place (a donated step's update),
    cast to ``dst``'s dtype as ``copy_`` casts; returns ``dst``.  A DTensor
    ``dst`` is written through its own local shard (``to_local()``), with
    ``src`` laid out like it first (``constrain_like``), so its placements
    and storage stay what they were."""
    from torch.distributed.tensor import DTensor
    with torch.no_grad():
        if isinstance(dst, DTensor):
            dst.to_local().copy_(constrain_like(src, dst).to_local())
        else:
            dst.copy_(src)
    return dst


class _ToLocal(torch.autograd.Function):
    """A DTensor's local shard; the gradient goes back as a DTensor laid
    out by ``grad_placements`` (Partial where ranks computed pieces of one
    value).  Each direction's backward applies the other, so the pair is
    differentiable twice (``local_map``'s is not: the HVP needs it)."""

    @staticmethod
    def forward(ctx, x, grad_placements):
        ctx.meta = (x.device_mesh, tuple(grad_placements), x.shape)
        return x.to_local().view_as(x.to_local())

    @staticmethod
    def backward(ctx, g):
        mesh, pl, shape = ctx.meta
        return _FromLocal.apply(g, mesh, pl, shape), None


class _FromLocal(torch.autograd.Function):
    """A local tensor as the shard of a DTensor of global ``shape`` laid out
    by ``placements``; its gradient, relaid to ``placements``, goes back
    as the local shard."""

    @staticmethod
    def forward(ctx, t, mesh, placements, shape):
        from torch.distributed.tensor import DTensor
        ctx.placements = tuple(placements)
        return DTensor.from_local(t.contiguous().view_as(t), mesh, placements,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=contiguous_stride(shape))

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        # a sum over ranks (Partial) takes the same gradient on each rank
        want = tuple(Replicate() if p.is_partial() else p
                     for p in ctx.placements)
        return _ToLocal.apply(redistribute(g, want), ctx.placements), \
            None, None, None


def map_local(fn, args, in_placements, out_placements, grad_placements=None):
    """``fn`` on the local shards of DTensor ``args`` (each first laid out
    by its ``in_placements``), its tensor outputs placed back as DTensors
    by ``out_placements`` — ``local_map``'s job, differentiable twice.
    ``grad_placements`` (default: the in placements) lay out each input's
    gradient: Partial on the mesh dims whose ranks each computed a piece of
    it.  Outputs have the global shapes ``fn`` gives on one rank's shards
    times the split of each sharded dim, so every split must be even."""
    mesh = next(a.device_mesh for a in args if hasattr(a, "device_mesh"))
    grad_placements = grad_placements or in_placements
    local = []
    for a, pl, gpl in zip(args, in_placements, grad_placements):
        if pl is None:
            local.append(a)
            continue
        a = redistribute(a, pl)
        check_even(a)
        local.append(_ToLocal.apply(a, gpl))
    out = fn(*local)
    single = not isinstance(out, (tuple, list))
    outs = [out] if single else list(out)
    placed = []
    for t, pl in zip(outs, out_placements):
        shape = list(t.shape)
        for i, p in enumerate(pl):
            if p.is_shard():
                shape[p.dim] *= mesh.shape[i]
        placed.append(_FromLocal.apply(t, mesh, pl, shape))
    return placed[0] if single else tuple(placed)


def summed(placements, axes, mesh) -> tuple:
    """``placements`` with Partial on the mesh dims named in ``axes`` that
    they replicate: the layout of a ``map_local`` input's gradient when
    the ranks along those dims each computed a piece of it."""
    from torch.distributed.tensor import Partial
    return tuple(Partial() if n in axes and p.is_replicate() else p
                 for n, p in zip(mesh.mesh_dim_names, placements))


# ---------------------------------------------------------------------------
# Parameter spec resolution by tree path
# ---------------------------------------------------------------------------

# Ordered (key-substring → logical axes per trailing dims) rules.  The logical
# names are matched against the *last* len(names) dims of the parameter; any
# leading dims (e.g. the stacked scan-layer dim) get the "layers" rule (= None).
_PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    ("tok_embed",        ("vocab", "embed")),
    ("pos_embed",        (None, "embed")),
    ("lm_head",          ("embed", "vocab")),
    # attention
    ("w_q",              ("embed", "heads")),
    ("w_k",              ("embed", "kv_heads")),
    ("w_v",              ("embed", "kv_heads")),
    ("w_o",              ("heads", "embed")),
    # MLA
    ("w_dq",             ("embed", "mla_rank")),
    ("w_uq",             ("mla_rank", "heads")),
    ("w_dkv",            ("embed", "mla_rank")),
    ("w_kr",             ("embed", None)),
    ("w_uk",             ("mla_rank", "heads")),
    ("w_uv",             ("mla_rank", "heads")),
    # dense mlp
    ("w_gate",           ("embed", "ffn")),
    ("w_up",             ("embed", "ffn")),
    ("w_down",           ("ffn", "embed")),
    # moe
    ("router",           ("embed", "experts")),
    ("moe_gate",         ("experts", "embed", "ffn")),
    ("moe_up",           ("experts", "embed", "ffn")),
    ("moe_down",         ("experts", "ffn", "embed")),
    ("shared_gate",      ("embed", "ffn")),
    ("shared_up",        ("embed", "ffn")),
    ("shared_down",      ("ffn", "embed")),
    # ssm (mamba2)
    ("in_proj",          ("embed", "ssm_inner")),
    ("out_proj",         ("ssm_inner", "embed")),
    ("conv_w",           (None, "ssm_inner")),
    ("conv_b",           ("ssm_inner",)),
    ("A_log",            (None,)),
    ("dt_bias",          (None,)),
    ("D_skip",           (None,)),
    # rg-lru / hybrid
    ("lru_in",           ("embed", "lru")),
    ("lru_out",          ("lru", "embed")),
    ("lru_a",            ("lru",)),
    ("lru_gate",         (None, "lru")),
    # lstm / small models — replicated
    ("lstm",             ()),
    ("conv",             ()),
    ("dense",            ()),
    ("bias",             ()),
    # norms — replicated
    ("scale",            ()),
    ("norm",             ()),
)


def param_logical_axes(path: str, ndim: int) -> Tuple[Optional[str], ...]:
    """Logical axes for a parameter given its tree path string + rank."""
    for key, names in _PARAM_RULES:
        if key in path:
            names = tuple(names)[-ndim:] if len(names) > ndim else names
            lead = ndim - len(names)
            return ("layers",) * lead + tuple(names)
    return (None,) * ndim


def _path_str(path) -> str:
    """``/``-joined tree path: a sequence of keys, or a string as it is."""
    if isinstance(path, str):
        return path
    return "/".join(str(p) for p in path)


def _map_with_path(fn, tree, prefix=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    return fn(prefix, tree)


def param_specs(params, mesh=None, rules: Optional[AxisRules] = None):
    """Per-dim mesh-axes tree matching ``params`` (by path-name rules)."""
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules

    def spec_for(path, leaf):
        names = param_logical_axes(_path_str(path), leaf.ndim)
        return logical_spec(names, mesh, rules)

    return _map_with_path(spec_for, params)


def param_placements(params, mesh=None, rules: Optional[AxisRules] = None):
    """DTensor placements tree for params (``None`` leaves without a mesh)."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return _map_with_path(lambda _, __: None, params)
    return _map_with_path(lambda _, s: spec_placements(s, mesh),
                          param_specs(params, mesh, rules))


def local_box(shape, placements, mesh) -> Tuple[tuple, tuple]:
    """(local shape, global offset) of this rank's shard of a tensor of
    ``shape`` placed by ``placements`` on ``mesh``: each ``Shard(d)`` cuts
    dim ``d`` into ``torch.chunk``'s pieces, mesh dims in order, as DTensor
    does.  Reads the mesh coordinate only, so it also runs under
    ``FakeTensorMode``."""
    size, off = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if not pl.is_shard():
            continue
        d, k = pl.dim, mesh.shape[i]
        step = -(-size[d] // k)
        start = min(coord[i] * step, size[d])
        off[d] += start
        size[d] = min(step, size[d] - start)
    return tuple(size), tuple(off)


def contiguous_stride(shape) -> tuple:
    """Row-major strides of ``shape``."""
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def check_even(x) -> None:
    """Raise unless every shard of DTensor ``x`` has the same shape (a
    local result is placed back by ``local_map`` as if it had)."""
    for i, p in enumerate(x.placements):
        if p.is_shard() and x.shape[p.dim] % x.device_mesh.shape[i]:
            raise ValueError(f"dim {p.dim} of {tuple(x.shape)} does not "
                             f"split evenly over mesh dim "
                             f"{x.device_mesh.mesh_dim_names[i]}")


def zeros(shape, dtype, placements, mesh, device) -> "torch.Tensor":
    """A zero DTensor of global ``shape``; each rank allocates its shard
    only."""
    from torch.distributed.tensor import DTensor
    local, _ = local_box(shape, placements, mesh)
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device),
                              mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def placements_spec(placements, mesh, ndim: int) -> Spec:
    """DTensor placements → per-dim mesh axes (``spec_placements``'
    inverse): the reference's ``PartitionSpec`` entries."""
    dims: list = [[] for _ in range(ndim)]
    for name, p in zip(mesh.mesh_dim_names, placements):
        if p.is_shard():
            dims[p.dim].append(name)
    return tuple(None if not d else (d[0] if len(d) == 1 else tuple(d))
                 for d in dims)


def _is_placements(x) -> bool:
    from torch.distributed.tensor import Placement
    return isinstance(x, tuple) and bool(x) and all(
        isinstance(p, Placement) for p in x)


def distribute(tree, placements, mesh):
    """Place each tensor of ``tree`` (dicts, tuples, named tuples) on
    ``mesh`` by the matching node of ``placements``: a placements tuple
    there covers every tensor below it.  A rank keeps only its own shard of
    each (every rank holds the same global values, as a seeded init gives
    them)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, torch.Tensor):
        shape, offset = local_box(tree.shape, placements, mesh)
        local = tree[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
        # a shard of its own storage: a contiguous slice (a dim-0 shard) of
        # the whole would keep the whole alive, and be counted whole by
        # the dry run's storage liveness
        local = (local.clone() if local.untyped_storage().nbytes()
                 > local.numel() * local.element_size()
                 else local.contiguous())
        return DTensor.from_local(local, mesh, placements,
                                  run_check=False, shape=tree.shape,
                                  stride=contiguous_stride(tree.shape))
    leaf = _is_placements(placements)
    if isinstance(tree, dict):
        return {k: distribute(v, placements if leaf else placements[k], mesh)
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        out = [distribute(v, placements if leaf else placements[i], mesh)
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return tree


def param_shardings(params, mesh=None, rules: Optional[AxisRules] = None):
    """``params`` distributed on the mesh by ``param_placements`` (the tree
    as it is without a mesh)."""
    mesh = mesh or _CTX.mesh
    if mesh is None:
        return params
    return distribute(params, param_placements(params, mesh, rules), mesh)
