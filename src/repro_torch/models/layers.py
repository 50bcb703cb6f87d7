"""Shared neural-net layers of the dense transformer, functional in torch.

The dense subset of the JAX package's ``models/layers.py``, function for
function: params are nested dicts of tensors with the reference's names and
layouts (dense weights ``[in, out]``), activations flow in ``cfg.dtype`` and
softmax/norm statistics accumulate in float32.  Decode caches are dicts of
tensors with static shapes; sliding-window caches are ring buffers storing
absolute positions (-1 = empty), so one attention code path serves full,
windowed and ring-buffer caches.

``sharding.constrain`` stands where the reference's does: the identity
without a mesh, a DTensor redistribution on one.  Under a mesh, DTensors
flow through the same code (``implicit_replication`` lifts the plain
tensors the code makes, such as positions and masks, to replicated ones).

Differences from the reference, none of which changes a result:

* Torch has no scatter ``mode="drop"``: ``attention_apply`` masks the ring
  buffer's writes instead, and writes the cache IN PLACE (the reference
  returns a new cache) so a full-width cache is never copied per step.
* ``preferred_element_type=float32`` becomes float32 operands (a bf16 →
  float32 cast is exact, so the products are the same).

Multi-head latent attention (DeepSeek-V2) and the mixture of experts
(``moe_apply_gather``, Mixtral and DeepSeek-V2) follow the reference step
for step.  Two differences, again without changing a result:

* the router runs in IEEE float32 whatever the TF32 setting (a TF32
  product would flip experts), and its top-k breaks ties as
  ``jax.lax.top_k`` does, the lower expert index first;
* the reference's ``.at[token].add`` combine becomes a fixed-order sum of
  each token's k contributions (ascending expert index, the order of the
  reference's sorted updates), where a scatter-add on the card would
  use atomics and change bf16 outputs from run to run.

The expert-parallel ``moe_apply_ep`` runs on a ``DeviceMesh``: routing
on DTensors, the capacity buckets, expert products and combine of each
shard's experts on its local tensors through ``local_map``, and one
all-reduce over ``model`` in place of the reference's ``psum``.
"""
from __future__ import annotations

import contextlib
import itertools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch.distributed.tensor import DTensor

from repro_torch import sharding
from repro_torch.config import ModelConfig

Params = Dict[str, Any]

# ---------------------------------------------------------------------------
# activation checkpointing (cfg.remat)
# ---------------------------------------------------------------------------

def _in_functorch_transform() -> bool:
    """True inside ``torch.func.grad``/``vjp``/``jvp``/``vmap``: functorch
    keeps a stack of interpreters, one per transform being traced, and it
    is empty outside every transform."""
    return torch._C._functorch.peek_interpreter_stack() is not None


def remat(fn, enabled: bool):
    """``fn`` under ``torch.utils.checkpoint.checkpoint(use_reentrant=
    False)`` when ``enabled`` (``cfg.remat``, the reference's
    ``jax.checkpoint`` per layer): its activations are recomputed in the
    backward pass instead of saved.  Gradients, and the HVP by reverse over
    reverse, are bitwise the same.  The checkpoint is skipped, changing
    only memory, where it would save nothing (grad mode off) and inside a
    ``torch.func`` transform, whose ``grad``, ``vjp`` and ``jvp`` refuse
    the saved-tensor hooks a checkpoint installs.  On DTensors the
    recomputation must run on the calling thread, under the forward's
    ``sharding.use_mesh`` (thread-local): the semi-synchronous step keeps
    its backward there on a mesh (``semi_sync._on_mesh``)."""
    if not enabled:
        return fn

    def run(*args):
        if not torch.is_grad_enabled() or _in_functorch_transform():
            return fn(*args)
        return torch.utils.checkpoint.checkpoint(fn, *args,
                                                 use_reentrant=False)
    return run


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def normal(gen: Optional[torch.Generator], shape, device) -> torch.Tensor:
    """float32 N(0, 1) draws from ``gen``; shapes only on the meta device."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, device="meta")
    return torch.randn(shape, generator=gen, device=device)


def lead_indices(lead: Tuple[int, ...]):
    """Every index of the leading axes ``lead`` in row-major order (one
    ``...`` when there are none)."""
    return itertools.product(*map(range, lead)) if lead else [...]


def dense_init(gen, in_dim: int, out_dim: int, dtype, scale=None, *,
               device="cpu", lead: Tuple[int, ...] = ()) -> torch.Tensor:
    """``lead`` stacks independent draws along leading axes (the layer
    axis, or the hybrid's (group, block) axes); each ``[in, out]`` draw is
    made in float32 and cast, so no float32 copy of a whole stack is ever
    held."""
    scale = scale if scale is not None else 1.0 / math.sqrt(in_dim)
    out = torch.empty(lead + (in_dim, out_dim), dtype=dtype, device=device)
    if out.device.type == "meta":
        return out
    for idx in lead_indices(lead):
        out[idx] = (normal(gen, (in_dim, out_dim), device) * scale).to(dtype)
    return out


def pad_seq(x: torch.Tensor, before: int, after: int = 0) -> torch.Tensor:
    """Zeros before and after dim 1 (the sequence) of ``x``: ``F.pad``'s
    values, built by concatenation, which every DTensor version lays out
    on any mesh (torch 2.11's ``constant_pad_nd`` strategy gives a 2-D mesh
    a one-placement layout)."""
    zero = torch.zeros_like(x[:, :1])
    parts = ([zero.expand(-1, before, *x.shape[2:])] if before else []) \
        + [x] + ([zero.expand(-1, after, *x.shape[2:])] if after else [])
    return torch.cat(parts, dim=1) if len(parts) > 1 else x


# ---------------------------------------------------------------------------
# normalisation
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, *, device="cpu", lead=()) -> Params:
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}


def _rms_stats(a: torch.Tensor, eps: float):
    """ve = mean(a²) + eps and r = rsqrt(ve) over the last dim."""
    ve = torch.mean(torch.square(a), dim=-1, keepdim=True) + eps
    return ve, torch.rsqrt(ve)


def _rms_tangent(a, da, r, c):
    """The JAX package's tangents of (mean(a²), r, a · r) along ``da``:
    ``jax.lax.rsqrt``'s JVP rule multiplies a tangent of ve by the primal
    c = -0.5 · (r / ve)."""
    dve = torch.mean(da * (2.0 * a), dim=-1, keepdim=True)
    dr = dve * c
    return dve, dr, da * r + a * dr


def _rms_vjp_tangent(a, g, ve, r, da, dg):
    """The JAX package's tangent of ``_RMSUnitVJP`` along (da, dg), op for
    op as ``jax.jvp`` differentiates the VJP, and the tangent of a · r
    along da.  dg None: zero."""
    n = a.shape[-1]
    c = -0.5 * (r / ve)
    dve, dr, dm = _rms_tangent(a, da, r, c)
    # d(r / ve) = dr / ve - dve · r · ve^-2
    dc = -0.5 * (dr / ve + (-dve * r) * (1.0 / (ve * ve)))
    s = torch.sum(a * g, dim=-1, keepdim=True)
    ds = torch.sum(da * g if dg is None else da * g + a * dg, dim=-1,
                   keepdim=True)
    dgr = g * dr if dg is None else dg * r + g * dr
    return dgr + (((ds * c + s * dc) / n) * (2.0 * a)
                  + ((s * c) / n) * (2.0 * da)), dm


class _RMSUnitVJP(torch.autograd.Function):
    """``_RMSUnit``'s VJP as ``jax.vjp`` takes it, g·r + (sum(a·g)·c/n)·2a
    (ve and r: ``_RMSUnit``'s, functions of a), with the JAX package's
    derivatives: its JVP is ``jax.jvp``'s of the same ops, and its
    backward gives the same two pieces, the one in a by symmetry (the VJP
    is the gradient of <g, a·r> in a, so its Jacobian in a is a
    Hessian)."""
    generate_vmap_rule = True

    @staticmethod
    def forward(a, g, ve, r):
        s = torch.sum(a * g, dim=-1, keepdim=True)
        return g * r + ((s * (-0.5 * (r / ve))) / a.shape[-1]) * (2.0 * a)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)
        ctx.save_for_forward(*inputs)

    @staticmethod
    def backward(ctx, w):
        a, g, ve, r = ctx.saved_tensors
        hw, jw = _rms_vjp_tangent(a, g, ve, r, w, None)
        return hw, jw, None, None

    @staticmethod
    def jvp(ctx, da, dg, _dve, _dr):
        a, g, ve, r = ctx.saved_tensors
        return _rms_vjp_tangent(a, g, ve, r, da, dg)[0]


class _RMSUnit(torch.autograd.Function):
    """(a · r, ve, r), r = rsqrt(ve), ve = mean(a²) + eps over the last dim
    (ve and r not differentiable: their derivatives are a · r's), with the
    JAX package's first and second derivatives op for op.  Torch's rsqrt
    backward is -0.5 · g · r³: by reverse over reverse it multiplies the
    second-order cotangent (~|a|·|v|) by g (~|a|) before r² (~1/|a|²) and
    overflows float32 where ``jax.jvp`` through ``jax.grad`` stays finite;
    with the JAX package's rules the port overflows where the JAX package
    does."""
    generate_vmap_rule = True

    @staticmethod
    def forward(a, eps):
        ve, r = _rms_stats(a, eps)
        return a * r, ve, r

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, ctx.eps = inputs
        _, ve, r = output
        ctx.mark_non_differentiable(ve, r)
        ctx.save_for_backward(a, ve, r)
        ctx.save_for_forward(a)

    @staticmethod
    def backward(ctx, g, _gve, _gr):
        a, ve, r = ctx.saved_tensors
        return _RMSUnitVJP.apply(a, g, ve, r), None

    @staticmethod
    def jvp(ctx, da, _):
        a, = ctx.saved_tensors
        ve, r = _rms_stats(a, ctx.eps)
        return _rms_tangent(a, da, r, -0.5 * (r / ve))[2], None, None


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """The JAX package's ``rmsnorm``: x · rsqrt(mean(x²) + eps) · scale in
    float32, differentiated by its rules (``_RMSUnit``) wherever
    gradients are taken."""
    xf = x.float()
    y = (_RMSUnit.apply(xf, eps)[0] if torch.is_grad_enabled()
         else xf * _rms_stats(xf, eps)[1])
    return (y * params["scale"].float()).to(x.dtype)


def layernorm_init(d: int, dtype, *, device="cpu", lead=()) -> Params:
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device),
            "bias_ln": torch.zeros(lead + (d,), dtype=dtype, device=device)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5
              ) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias_ln"].float()
    return y.to(x.dtype)


def make_norm(cfg: ModelConfig):
    if cfg.norm == "layernorm":
        return layernorm_init, layernorm
    return rmsnorm_init, rmsnorm


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: [..., L, H, D] (D even), positions: broadcastable to [..., L].
    D splits into halves (not interleaved pairs), as in the reference."""
    d = x.shape[-1]
    if d % 2:
        raise ValueError("rope head_dim must be even")
    freqs = torch.exp(-torch.arange(0, d, 2, dtype=torch.float32,
                                    device=x.device) / d * math.log(theta))
    ang = positions.float()[..., None] * freqs                   # [..., L, D/2]
    cos = torch.cos(ang)[..., None, :]                            # [..., L, 1, D/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention core
# ---------------------------------------------------------------------------

def _attn_scores_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *,
                      causal: bool, window: int) -> torch.Tensor:
    """Boolean mask [.., Lq, Lk]; k_pos < 0 marks invalid (ring-buffer hole)."""
    valid = k_pos >= 0
    m = valid[..., None, :]
    if causal:
        m = m & (k_pos[..., None, :] <= q_pos[..., :, None])
    if window:
        m = m & (q_pos[..., :, None] - k_pos[..., None, :] < window)
    return m


SDPA_CHUNK = 1024   # q-chunk length for the memory-efficient path


def _sdpa_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                mask: torch.Tensor, scale: float, cast_f32: bool = True
                ) -> torch.Tensor:
    """One q-block of attention. q [B,Lq,Hq,D], k/v [B,Lk,Hkv,Dk/Dv],
    mask [B,Lq,Lk].  Both einsums take float32 operands, as the
    reference's ``preferred_element_type=float32`` does; with
    ``cast_f32=False`` the probabilities are rounded to v's dtype first,
    as in the reference."""
    b, lq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    qg = q.reshape(b, lq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    logits = logits.masked_fill(~mask[:, None, None, :, :], -1e30)
    probs = torch.softmax(logits, dim=-1)
    if not cast_f32:
        probs = probs.to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(), v.float())
    return out.reshape(b, lq, hq, v.shape[-1]).to(q.dtype)


def attention_shards(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     *pos: torch.Tensor) -> torch.Tensor:
    """``fn(q, k, v, *pos)`` (flash or ``sdpa`` on plain tensors) on
    DTensors, each rank on its own batch rows and query heads
    (``sharding.map_local``): attention is independent per (batch row,
    head).  Query heads group over kv heads locally only when the model
    axis splits the kv heads evenly; else each query head gets its own copy
    of its kv head first.  k, v and the positions are gathered along the
    key sequence (a decode cache may split it)."""
    from torch.distributed.tensor import Replicate
    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    m = mesh.shape[names.index("model")] if "model" in names else 1
    pos = tuple(p if isinstance(p, DTensor) else DTensor.from_local(
        p, mesh, (Replicate(),) * mesh.ndim, run_check=False) for p in pos)
    if k.shape[2] % m:
        g = q.shape[2] // k.shape[2]
        k, v = (sharding.replicate_dim(t, 2).repeat_interleave(g, dim=2)
                for t in (k, v))
    batch = tuple(a for a in ("pod", "data") if a in names) or None
    qkv = sharding.spec_placements(
        (batch, None, "model" if m > 1 else None, None), mesh)
    pp = sharding.spec_placements((batch, None), mesh)
    return sharding.map_local(fn, (q, k, v) + pos,
                              (qkv,) * 3 + (pp,) * len(pos), (qkv,))


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool, window: int,
         scale: Optional[float] = None, chunk: int = SDPA_CHUNK,
         cast_f32: bool = True) -> torch.Tensor:
    """Scaled dot-product attention with GQA head-group broadcast.

    When Lq > ``chunk`` the query axis is processed in chunks so the
    [Lq, Lk] score matrix is never fully materialised.  The reference pads
    the last chunk with masked rows and drops them; here the last chunk is
    simply shorter (rows are independent, so the kept rows are the same).

    q: [B, Lq, Hq, D], k/v: [B, Lk, Hkv, D].
    q_pos [B, Lq], k_pos [B, Lk] — absolute positions; k_pos < 0 = invalid.
    """
    b, lq, hq, d = q.shape
    if hq % k.shape[2]:
        raise ValueError(f"{hq} query heads do not group over "
                         f"{k.shape[2]} kv heads")
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if isinstance(q, DTensor):
        return attention_shards(
            lambda q_, k_, v_, qp, kp: sdpa(
                q_, k_, v_, q_pos=qp, k_pos=kp, causal=causal, window=window,
                scale=scale, chunk=chunk, cast_f32=cast_f32),
            q, k, v, q_pos, k_pos)

    if lq <= chunk:
        mask = _attn_scores_mask(q_pos, k_pos, causal=causal, window=window)
        return _sdpa_block(q, k, v, mask, scale, cast_f32)

    outs = []
    for s in range(0, lq, chunk):
        qpc = q_pos[:, s:s + chunk]
        mask = _attn_scores_mask(qpc, k_pos, causal=causal, window=window)
        mask = mask & (qpc >= 0)[..., :, None]
        outs.append(_sdpa_block(q[:, s:s + chunk], k, v, mask, scale,
                                cast_f32))
    return torch.cat(outs, dim=1)


def attention_init(gen, cfg: ModelConfig, *, device="cpu", lead=()
                   ) -> Params:
    dt = _dt(cfg)
    hd = cfg.resolved_head_dim
    kw = dict(device=device, lead=lead)
    return {
        "w_q": dense_init(gen, cfg.d_model, cfg.num_heads * hd, dt, **kw),
        "w_k": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dt, **kw),
        "w_v": dense_init(gen, cfg.d_model, cfg.num_kv_heads * hd, dt, **kw),
        "w_o": dense_init(gen, cfg.num_heads * hd, cfg.d_model, dt,
                          scale=1.0 / math.sqrt(
                              cfg.num_heads * hd * 2 * cfg.num_layers), **kw),
    }


def init_kv_cache(cfg: ModelConfig, batch: int, cache_len: int,
                  num_layers: Optional[int] = None, *, stacked: bool = True,
                  device="cpu") -> Params:
    """Ring-buffer KV cache. ``pos`` holds absolute positions (-1 = empty)."""
    dt = _dt(cfg)
    hd = cfg.resolved_head_dim
    nl = num_layers if num_layers is not None else cfg.num_layers
    lead = (nl,) if stacked else ()
    shape = lead + (batch, cache_len, cfg.num_kv_heads, hd)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": torch.full(lead + (batch, cache_len), -1, dtype=torch.int32,
                          device=device),
    }


def _write_ring(cache: Params, positions: torch.Tensor,
                **new: torch.Tensor) -> None:
    """Write each new entry [B, Lq, ...] into the cache's buffer of the
    same name at slot = pos % W, and the positions into ``cache["pos"]``,
    in place.  Of more than W new tokens only the last W are kept, as the
    reference's out-of-bounds slot with ``mode="drop"`` keeps them (those
    with pos >= pos[-1] - W + 1), so slots never collide.  Several new
    tokens come from a prefill, whose positions are consecutive: the kept
    ones are the last W, a slice whose size needs no look at the data."""
    b, lq = next(iter(new.values())).shape[:2]
    w = cache["pos"].shape[1]
    pos_b = torch.broadcast_to(positions, (lq,)).to(torch.int32)
    if lq > w:
        new = {name: t[:, lq - w:] for name, t in new.items()}
        pos_b = pos_b[lq - w:]
    # (one new token is always kept: pos >= pos - W + 1)
    slots = (pos_b % w).long()
    if isinstance(cache["pos"], DTensor):
        _blend_ring(cache, slots, pos_b, b, new)
        return
    for name, t in new.items():
        cache[name].index_copy_(1, slots, t.to(cache[name].dtype))
    cache["pos"].index_copy_(1, slots,
                             torch.broadcast_to(pos_b, (b, pos_b.shape[0])))


def _blend_ring(cache: Params, slots: torch.Tensor, pos_b: torch.Tensor,
                b: int, new: Dict[str, torch.Tensor]) -> None:
    """``_write_ring``'s writes on a mesh: each slot takes its new entry
    (one decoded token broadcast over the slots, or several gathered to
    [B, W, ...]) where one lands, its old one elsewhere — an elementwise
    blend, right in any layout of the cache, copied back in place
    (DTensor's in-place ``index_copy_`` may re-lay the destination without
    moving its data)."""
    w = cache["pos"].shape[1]
    hit = slots[None, :] == torch.arange(w, device=slots.device)[:, None]
    written = hit.any(dim=1)                                   # [W]
    src = torch.argmax(hit.to(torch.int32), dim=1)             # [W]
    for name, t in list(new.items()) + [
            ("pos", torch.broadcast_to(pos_b, (b, pos_b.shape[0])))]:
        c = cache[name]
        keep = written.reshape((1, w) + (1,) * (c.ndim - 2))
        t = t if t.shape[1] == 1 else t[:, src]
        c.copy_(sharding.constrain_like(
            torch.where(keep, t.to(c.dtype), c), c))


def _project_heads(x: torch.Tensor, w: torch.Tensor, h: int, hd: int
                   ) -> torch.Tensor:
    """x [B, L, d] @ w [d, h * hd] → [B, L, h, hd].  On a mesh whose ranks
    split w's head dim into pieces that cut heads (h does not divide over
    them: GQA's few kv heads), the heads are cut apart and stacked (copies,
    the same values): DTensor cannot view such a split into heads, nor, in
    a second-order backward, its gradient; its split gathers the dim."""
    y = x @ w
    if sharding.active_mesh() is not None and isinstance(w, DTensor):
        k = 1
        for i, p in enumerate(w.placements):
            if p.is_shard(w.ndim - 1):
                k *= w.device_mesh.shape[i]
        if h % k:
            return torch.stack(torch.split(y, hd, dim=-1), dim=2)
    return y.reshape(y.shape[0], y.shape[1], h, hd)


def attention_apply(params: Params, x: torch.Tensor, *, cfg: ModelConfig,
                    positions: torch.Tensor,
                    cache: Optional[Params] = None,
                    kv_input: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    window: int = 0) -> Tuple[torch.Tensor, Optional[Params]]:
    """Unified attention.

    * train/prefill: ``cache is None`` or to-be-filled; ``x`` is [B, L, d].
    * decode:        ``cache`` holds past K/V; ``x`` is [B, 1, d].
    * cross:         ``kv_input`` [B, Lk, d] supplies the K/V source: no
      RoPE, no causal mask, no window, and always ``sdpa`` (the flash
      kernel takes one L for q and k), as in the reference.

    Returns (out [B, L, d], the cache written in place, or None).
    """
    b, lq, _ = x.shape
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads

    q = _project_heads(x, params["w_q"], hq, hd)
    src = kv_input if kv_input is not None else x
    lk = src.shape[1]
    k = _project_heads(src, params["w_k"], hkv, hd)
    v = _project_heads(src, params["w_v"], hkv, hd)

    if kv_input is None and cfg.attention != "none":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = sharding.constrain(q, "batch", None, "act_heads", None)

    q_pos = torch.broadcast_to(positions, (b, lq))
    if kv_input is not None:
        # dense cross-attention: every query sees every source token
        k_pos = torch.zeros((b, lk), dtype=torch.int32, device=x.device)
        causal, window = False, 0
    elif cache is not None:
        _write_ring(cache, positions, k=k, v=v)
        if lq == 1:
            # decode: attend against the cache contents
            k, v, k_pos = cache["k"], cache["v"], cache["pos"]
        else:
            # prefill: attend within the fresh sequence (the ring buffer
            # may only retain the last W entries; outputs need the full
            # window relative to each query position)
            k_pos = q_pos
    else:
        k_pos = q_pos

    if cfg.attn_impl == "pallas" and cache is None and kv_input is None:
        from repro_torch.kernels import flash_attention as fa
        if isinstance(q, DTensor):
            out = attention_shards(
                lambda q_, k_, v_: fa.flash_attention(
                    q_, k_, v_, causal=causal, window=window), q, k, v)
        else:
            out = fa.flash_attention(q, k, v, causal=causal, window=window)
    else:
        out = sdpa(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=causal,
                   window=window, cast_f32=cfg.attn_cast_f32)
    out = out.reshape(b, lq, hq * hd) @ params["w_o"]
    return out, cache


# ---------------------------------------------------------------------------
# Multi-head Latent Attention (DeepSeek-V2)
# ---------------------------------------------------------------------------

def mla_init(gen, cfg: ModelConfig, *, device="cpu", lead=()) -> Params:
    m = cfg.mla
    dt = _dt(cfg)
    h = cfg.num_heads
    qk_head = m.qk_nope_head_dim + m.qk_rope_head_dim
    kw = dict(device=device, lead=lead)
    p: Params = {
        "w_dkv": dense_init(gen, cfg.d_model, m.kv_lora_rank, dt, **kw),
        "w_kr": dense_init(gen, cfg.d_model, m.qk_rope_head_dim, dt, **kw),
        "w_uk": dense_init(gen, m.kv_lora_rank, h * m.qk_nope_head_dim, dt,
                           **kw),
        "w_uv": dense_init(gen, m.kv_lora_rank, h * m.v_head_dim, dt, **kw),
        "w_o": dense_init(gen, h * m.v_head_dim, cfg.d_model, dt,
                          scale=1.0 / math.sqrt(
                              h * m.v_head_dim * 2 * cfg.num_layers), **kw),
        "norm_ckv": rmsnorm_init(m.kv_lora_rank, dt, **kw),
    }
    if m.q_lora_rank:
        p["w_dq"] = dense_init(gen, cfg.d_model, m.q_lora_rank, dt, **kw)
        p["w_uq"] = dense_init(gen, m.q_lora_rank, h * qk_head, dt, **kw)
        p["norm_q"] = rmsnorm_init(m.q_lora_rank, dt, **kw)
    else:
        p["w_q"] = dense_init(gen, cfg.d_model, h * qk_head, dt, **kw)
    return p


def init_mla_cache(cfg: ModelConfig, batch: int, cache_len: int,
                   num_layers: Optional[int] = None, *, device="cpu"
                   ) -> Params:
    """MLA latent cache: per position the normalised latent c_kv [rank]
    and the rotary key [rope_dim]; ``pos`` as in ``init_kv_cache``."""
    m = cfg.mla
    dt = _dt(cfg)
    nl = num_layers if num_layers is not None else cfg.num_layers
    return {
        "ckv": torch.zeros((nl, batch, cache_len, m.kv_lora_rank), dtype=dt,
                           device=device),
        "kr": torch.zeros((nl, batch, cache_len, m.qk_rope_head_dim),
                          dtype=dt, device=device),
        "pos": torch.full((nl, batch, cache_len), -1, dtype=torch.int32,
                          device=device),
    }


def mla_apply(params: Params, x: torch.Tensor, *, cfg: ModelConfig,
              positions: torch.Tensor, cache: Optional[Params] = None,
              window: int = 0) -> Tuple[torch.Tensor, Optional[Params]]:
    """MLA attention.  Train and prefill materialise k/v heads and run
    ``sdpa`` (qk head dim 192 differs from v's 128 at full width, which the
    flash kernel does not take; the reference runs ``sdpa`` here too, under
    either ``attn_impl``).  A decode step (``cache`` and one token) runs
    the *absorbed* form against the latent cache: scores q_nope·(W_uk c) +
    q_rope·k_r computed as (q_nope W_ukᵀ)·c, and the output W_uv applied
    after the latent is aggregated.  Its casts are the reference's, one for
    one.  Returns (out, the cache written in place, or None)."""
    m = cfg.mla
    b, lq, _ = x.shape
    h = cfg.num_heads
    dn, dr, dv = m.qk_nope_head_dim, m.qk_rope_head_dim, m.v_head_dim

    if m.q_lora_rank:
        q = rmsnorm(params["norm_q"], x @ params["w_dq"]) @ params["w_uq"]
    else:
        q = x @ params["w_q"]
    q = q.reshape(b, lq, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)

    ckv = rmsnorm(params["norm_ckv"], x @ params["w_dkv"])         # [B,L,rank]
    kr = (x @ params["w_kr"])[:, :, None, :]                       # [B,L,1,dr]
    kr = apply_rope(kr, positions, cfg.rope_theta)[:, :, 0, :]     # [B,L,dr]

    scale = 1.0 / math.sqrt(dn + dr)
    q_pos = torch.broadcast_to(positions, (b, lq))
    if cache is not None:
        _write_ring(cache, positions, ckv=ckv, kr=kr)

    if cache is not None and lq == 1:
        # absorbed decode.  ``preferred_element_type=float32`` is float32
        # operands here (exact for bf16), so ``cast`` reduces to the
        # reference's explicit roundings: q_lat to the cache's dtype and,
        # without attn_cast_f32, the probabilities and the latent to the
        # weights' dtype
        cckv, ckr, cpos = cache["ckv"], cache["kr"], cache["pos"]
        w_uk = params["w_uk"].reshape(m.kv_lora_rank, h, dn)
        q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope.float(),
                             w_uk.float())                        # [B,Lq,H,r]
        s_lat = torch.einsum("bqhr,bkr->bhqk",
                             q_lat.to(cckv.dtype).float(), cckv.float())
        s_rope = torch.einsum("bqhd,bkd->bhqk", q_rope.float(), ckr.float())
        logits = (s_lat + s_rope) * scale
        mask = _attn_scores_mask(q_pos, cpos, causal=True, window=window)
        logits = logits.masked_fill(~mask[:, None, :, :], -1e30)
        probs = torch.softmax(logits, dim=-1)
        if not cfg.attn_cast_f32:
            probs = probs.to(cckv.dtype)
        # out_h = probs · (W_uv c): aggregate the latent, then up-project
        lat = torch.einsum("bhqk,bkr->bqhr", probs.float(), cckv.float())
        w_uv = params["w_uv"].reshape(m.kv_lora_rank, h, dv)
        if not cfg.attn_cast_f32:
            lat = lat.to(w_uv.dtype)
        out = torch.einsum("bqhr,rhd->bqhd", lat.float(), w_uv.float())
        out = out.to(x.dtype).reshape(b, lq, h * dv) @ params["w_o"]
        return out, cache

    # train / prefill: materialise k/v heads (the standard formulation)
    k_nope = (ckv @ params["w_uk"]).reshape(b, lq, h, dn)
    vh = (ckv @ params["w_uv"]).reshape(b, lq, h, dv)
    kh = torch.cat([k_nope, torch.broadcast_to(kr[:, :, None, :],
                                               (b, lq, h, dr))], dim=-1)
    qh = torch.cat([q_nope, q_rope], dim=-1)
    out = sdpa(qh, kh, vh, q_pos=q_pos, k_pos=q_pos, causal=True,
               window=window, scale=scale, cast_f32=cfg.attn_cast_f32)
    out = out.reshape(b, lq, h * dv) @ params["w_o"]
    return out, cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x), the value ``logaddexp(x, 0)``'s,
    its derivatives those of max(x, 0) + log1p(e^-|x|), finite at every
    order.  ``torch.logaddexp``'s backward divides by 1 + e^-x, which
    overflows below x ≈ -88, and a Hessian-vector product by reverse over
    reverse then reads 0 · inf = NaN there (the JAX package's softplus
    has a guarded JVP).  The written-out form alone is not the value:
    torch's vectorised ``log1p`` is off by up to 1.5e-4 relative.  -|x|
    is x - 2·relu(x): ``abs``'s double backward has no DTensor rule."""
    pos = torch.relu(x)
    smooth = pos + torch.log1p(torch.exp(x - 2.0 * pos))
    return torch.logaddexp(x, torch.zeros_like(x)).detach() \
        + (smooth - smooth.detach())


def _act(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        return lambda x: F.gelu(x, approximate="tanh")
    if name == "sq_relu":
        return lambda x: torch.square(F.relu(x))
    raise ValueError(f"unknown activation {name!r}")


def mlp_init(gen, cfg: ModelConfig, d_ff: Optional[int] = None,
             prefix: str = "", *, device="cpu", lead=()) -> Params:
    dt = _dt(cfg)
    f = d_ff or cfg.d_ff
    gated = cfg.activation in ("silu", "gelu")
    kw = dict(device=device, lead=lead)
    p = {
        prefix + "w_up": dense_init(gen, cfg.d_model, f, dt, **kw),
        prefix + "w_down": dense_init(
            gen, f, cfg.d_model, dt,
            scale=1.0 / math.sqrt(f * 2 * cfg.num_layers), **kw),
    }
    if gated:
        p[prefix + "w_gate"] = dense_init(gen, cfg.d_model, f, dt, **kw)
    return p


def mlp_apply(params: Params, x: torch.Tensor, cfg: ModelConfig,
              prefix: str = "") -> torch.Tensor:
    act = _act(cfg.activation)
    up = x @ params[prefix + "w_up"]
    if prefix + "w_gate" in params:
        h = act(x @ params[prefix + "w_gate"]) * up
    else:
        h = act(up)
    h = sharding.constrain(h, "batch", None, "act_ffn")
    return h @ params[prefix + "w_down"]


# ---------------------------------------------------------------------------
# Mixture of Experts
# ---------------------------------------------------------------------------

def moe_init(gen, cfg: ModelConfig, *, device="cpu", lead=()) -> Params:
    """The router in float32, the expert banks ``[E, in, out]`` (and the
    shared experts) in the model dtype, as in the reference."""
    e = cfg.moe
    dt = _dt(cfg)
    f = e.expert_d_ff or cfg.d_ff
    d = cfg.d_model
    sc_in = 1.0 / math.sqrt(d)
    sc_out = 1.0 / math.sqrt(f * 2 * cfg.num_layers)
    kw = dict(device=device, lead=lead)
    bank = dict(device=device, lead=lead + (e.num_experts,))
    p: Params = {
        "router": dense_init(gen, d, e.num_experts, torch.float32,
                             scale=sc_in, **kw),
        "moe_gate": dense_init(gen, d, f, dt, sc_in, **bank),
        "moe_up": dense_init(gen, d, f, dt, sc_in, **bank),
        "moe_down": dense_init(gen, f, d, dt, sc_out, **bank),
    }
    if e.num_shared_experts:
        fs = f * e.num_shared_experts
        p["shared_gate"] = dense_init(gen, d, fs, dt, scale=sc_in, **kw)
        p["shared_up"] = dense_init(gen, d, fs, dt, scale=sc_in, **kw)
        p["shared_down"] = dense_init(gen, fs, d, dt, scale=sc_out, **kw)
    return p


@contextlib.contextmanager
def _ieee_f32():
    """float32 matmuls in IEEE float32 within the block (no TF32)."""
    prec = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prec)


def _route(params: Params, xf: torch.Tensor, e
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing.  xf: [T, d] f32.  Returns (probs [T,k], idx [T,k],
    aux).  A stable descending sort keeps tied experts in index order, the
    order ``jax.lax.top_k`` returns them in."""
    with _ieee_f32():
        logits = xf @ params["router"]                             # [T, E]
    full = torch.softmax(logits, dim=-1)
    probs, idx = torch.sort(full, dim=-1, descending=True, stable=True)
    probs = probs[:, :e.experts_per_token]
    idx = idx[:, :e.experts_per_token]
    probs = probs / torch.clamp(probs.sum(-1, keepdim=True), min=1e-9)
    # Switch-style load-balance loss
    # a one-hot count (bincount's values; its output size depends on
    # the data, which neither meta tensors nor DTensor can propagate)
    counts = (idx.reshape(-1, 1) == torch.arange(
        e.num_experts, device=idx.device)).sum(0).float()
    frac_tokens = counts / torch.clamp(counts.sum(), min=1.0)
    frac_probs = full.mean(dim=0)
    aux = e.num_experts * torch.sum(frac_tokens * frac_probs) \
        * e.router_aux_loss_coef
    return probs, idx, aux


def moe_capacity(t: int, e) -> int:
    """Slots an expert has for a call of ``t`` tokens (a multiple of 8)."""
    cap = int(math.ceil(t * e.experts_per_token / e.num_experts
                        * e.capacity_factor))
    return max(8, -(-cap // 8) * 8)


def moe_dispatch(idx: torch.Tensor, num_experts: int, cap: int
                 ) -> torch.Tensor:
    """The reference's capacity buckets: the (token, slot) pairs sorted
    stably by expert, each expert's first ``cap`` kept.  Returns each
    pair's row in the [E * cap + 1] expert buffer, [T, k]; a dropped pair
    gets the last row, E * cap.  On a mesh every rank computes every
    token's row from the replicated routing (``local_map``)."""
    if isinstance(idx, DTensor):
        from torch.distributed.tensor import Replicate
        from torch.distributed.tensor.experimental import local_map
        rep = (Replicate(),) * idx.device_mesh.ndim
        return local_map(moe_dispatch, out_placements=(rep,),
                         in_placements=(rep, None, None),
                         device_mesh=idx.device_mesh,
                         redistribute_inputs=True)(idx, num_experts, cap)
    t, k = idx.shape
    e_flat = idx.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    se = e_flat[order]
    # each expert's first row in ``se``: the count of pairs routed below it
    # (searchsorted's value; DTensor has no strategy for searchsorted)
    starts = (e_flat[:, None] < torch.arange(
        num_experts, device=se.device, dtype=se.dtype)).sum(0)
    slot = torch.arange(t * k, device=se.device) - starts[se]
    dst = torch.where(slot < cap, se * cap + slot,
                      torch.full_like(slot, num_experts * cap))
    out = torch.empty_like(dst)
    out[order] = dst                          # back to (token, slot) order
    return out.reshape(t, k)


def _combine(pl: torch.Tensor, il: torch.Tensor, dst: torch.Tensor,
             ho: torch.Tensor, n_rows: int, dtype) -> torch.Tensor:
    """Each token's contributions from ``ho`` [rows + 1, d], scaled by its
    gates ``pl`` rounded to ``dtype`` and summed in ascending expert order
    (a token's k experts differ, so the order is unique); dropped pairs,
    and pairs of another shard's experts, point at the zero row
    ``n_rows``."""
    by_expert = torch.argsort(il, dim=-1)
    dst = torch.gather(dst, 1, by_expert)
    gate = (torch.gather(pl, 1, by_expert) * (dst < n_rows)).to(dtype)
    out = ho.new_zeros((il.shape[0], ho.shape[1]))
    for j in range(il.shape[1]):
        out = out + ho[dst[:, j]] * gate[:, j, None]
    return out


def moe_apply_gather(params: Params, x: torch.Tensor, cfg: ModelConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-bucketed sort/gather MoE (the reference's single-host
    path).  The expert products are batched matmuls over [E, cap, d]; each
    token's kept contributions, scaled by its gate rounded to x's dtype,
    are summed in ascending expert order in x's dtype."""
    e = cfg.moe
    b, sl, d = x.shape
    t = b * sl
    xf = x.reshape(t, d)
    probs, idx, aux = _route(params, xf.float(), e)

    cap = moe_capacity(t, e)
    dst = moe_dispatch(idx, e.num_experts, cap)                    # [T, k]
    buf = x.new_zeros((e.num_experts * cap + 1, d))
    buf[dst.reshape(-1)] = xf.repeat_interleave(e.experts_per_token, dim=0)
    hb = buf[:-1].reshape(e.num_experts, cap, d)
    act = _act("silu")
    hg = torch.bmm(hb, params["moe_gate"])
    hu = torch.bmm(hb, params["moe_up"])
    ho = torch.bmm(act(hg) * hu, params["moe_down"])
    ho = torch.cat([ho.reshape(e.num_experts * cap, d), x.new_zeros((1, d))])
    out = _combine(probs, idx, dst, ho, e.num_experts * cap, x.dtype)

    if e.num_shared_experts:
        out = out + _shared_expert(params, xf, cfg)
    return out.reshape(b, sl, d), aux


def _shared_expert(params: Params, xf: torch.Tensor, cfg: ModelConfig
                   ) -> torch.Tensor:
    act = _act("silu")
    h = act(xf @ params["shared_gate"]) * (xf @ params["shared_up"])
    return h @ params["shared_down"]


def moe_apply_ep(params: Params, x: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE: experts live on the ``model`` mesh axis, tokens
    are replicated across it; each shard computes only its experts on its
    local tensors (``sharding.map_local``, the reference's ``shard_map``),
    and the contributions combine by one all-reduce over ``model`` (the
    output is a Partial sum there, reduced where it is next used).
    Routing stays outside, as in the reference.  Without a mesh with a
    ``model`` axis (or on a plain tensor, which a mesh cannot hold shards
    of) it is ``moe_apply_gather``.

    With fewer experts than shards, each expert's FFN width splits into
    ``rep`` chunks, E·rep virtual experts (the gated MLP is additive over
    f-chunks through w_down), so every shard owns exactly one; the shard
    cuts its chunk from the replicated weights."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = sharding.active_mesh()
    if (mesh is None or "model" not in mesh.mesh_dim_names
            or not isinstance(x, DTensor)):
        return moe_apply_gather(params, x, cfg)
    e = cfg.moe
    b, sl, d = x.shape
    t_global = b * sl
    k = e.experts_per_token
    names = list(mesh.mesh_dim_names)
    mi = names.index("model")
    ep = mesh.shape[mi]
    f_dim = params["moe_gate"].shape[-1]
    # routing outside local_map
    probs, idx, aux = _route(params, x.reshape(t_global, d).float(), e)

    if e.num_experts % ep == 0:
        rep = 1
        w_pl = tuple(Shard(0) if i == mi else Replicate()
                     for i in range(len(names)))
        # each batch shard adds its tokens' part of an expert's gradient
        w_grad = tuple(Shard(0) if i == mi else Partial()
                       for i in range(len(names)))
    elif ep % e.num_experts == 0:
        rep = ep // e.num_experts
        if f_dim % rep:
            raise ValueError(f"expert width {f_dim} does not split into "
                             f"{rep} chunks")
        w_pl = (Replicate(),) * len(names)
        # each shard's gradient is its own chunk of one expert
        w_grad = (Partial(),) * len(names)
    else:
        raise ValueError(f"experts={e.num_experts} incompatible with "
                         f"model axis {ep}")
    e_loc = e.num_experts * rep // ep
    k_eff = k * rep
    fr = f_dim // rep

    batch_axes = tuple(a for a in ("pod", "data") if a in names)
    x_pl = sharding.spec_placements((batch_axes or None, None, None), mesh)
    # a token's output (and its gradient) sums over the model shards
    x_sum = tuple(Partial() if i == mi else p for i, p in enumerate(x_pl))
    n_batch_shards = 1
    for a in batch_axes:
        n_batch_shards *= mesh.shape[names.index(a)]
    t_loc = t_global // n_batch_shards
    cap = int(math.ceil(t_loc * k / e.num_experts * e.capacity_factor))
    cap = max(8, -(-cap // 8) * 8)
    my = mesh.get_local_rank(mi) * e_loc       # first (virtual) expert here

    def shard_fn(xb, pb, ib, wg, wu, wd):
        bb, ll, _ = xb.shape
        tl = bb * ll
        xl = xb.reshape(tl, d)
        pl = pb.reshape(tl, k)
        il = ib.reshape(tl, k)
        if rep > 1:
            # virtual expert v = e·rep + r: expert e's f-chunk r
            il = (il[..., None] * rep + torch.arange(
                rep, device=il.device)).reshape(tl, k_eff)
            pl = pl.repeat_interleave(rep, dim=-1)
            ex, r = divmod(my, rep)
            cut = slice(r * fr, (r + 1) * fr)
            wg, wu = wg[ex:ex + 1, :, cut], wu[ex:ex + 1, :, cut]
            wd = wd[ex:ex + 1, cut, :]
        e_rel = il - my
        mine = (e_rel >= 0) & (e_rel < e_loc)
        # the sentinel expert e_loc ("not mine") sorts last and is dropped
        dst = moe_dispatch(torch.where(mine, e_rel, e_loc), e_loc + 1, cap)
        dst = torch.where(dst < e_loc * cap, dst, e_loc * cap)
        buf = xl.new_zeros((e_loc * cap + 1, d))
        buf[dst.reshape(-1)] = xl.repeat_interleave(k_eff, dim=0)
        h = buf[:-1].reshape(e_loc, cap, d)
        act = _act("silu")
        ho = torch.bmm(act(torch.bmm(h, wg)) * torch.bmm(h, wu), wd)
        ho = torch.cat([ho.reshape(e_loc * cap, d), xl.new_zeros((1, d))])
        out = _combine(pl, il, dst, ho, e_loc * cap, xl.dtype)
        return out.reshape(bb, ll, d)

    out = sharding.map_local(
        shard_fn, (x, probs.to(x.dtype).reshape(b, sl, k),
                   idx.reshape(b, sl, k), params["moe_gate"],
                   params["moe_up"], params["moe_down"]),
        (x_pl, x_pl, x_pl, w_pl, w_pl, w_pl), (x_sum,),
        (x_sum, x_sum, x_pl, w_grad, w_grad, w_grad))

    if e.num_shared_experts:
        xf = x.reshape(t_global, d)
        out = out + _shared_expert(params, xf, cfg).reshape(b, sl, d)
    return out, aux


def moe_apply(params: Params, x: torch.Tensor, cfg: ModelConfig,
              impl: str = "gather") -> Tuple[torch.Tensor, torch.Tensor]:
    if impl == "ep":
        return moe_apply_ep(params, x, cfg)
    return moe_apply_gather(params, x, cfg)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def embedding_init(gen, cfg: ModelConfig, *, device="cpu") -> Params:
    dt = _dt(cfg)
    emb = torch.empty((cfg.vocab_size, cfg.d_model), dtype=dt, device=device)
    if emb.device.type != "meta":
        emb.copy_(normal(gen, emb.shape, device) * 0.02)
    p = {"tok_embed": emb}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(gen, cfg.d_model, cfg.vocab_size, dt,
                                  device=device)
    return p


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of the table (``F.embedding``: the same values as indexing).
    On a mesh the vocab dim is gathered first: a lookup into a split vocab
    leaves a masked partial sum, which DTensor cannot always reduce
    (``cross_entropy`` has the same trouble) nor compare on meta tensors."""
    table = params["tok_embed"]
    if isinstance(table, DTensor):
        table = sharding.replicate_dim(table, 0)
    return F.embedding(tokens.long(), table)


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    if "lm_head" in params:
        return x @ params["lm_head"]
    return x @ params["tok_embed"].T


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy in f32. logits [..., V], targets [...] int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    if sharding.active_mesh() is not None:
        # on a mesh the vocab dim may be sharded, and DTensor's gather over
        # it leaves a masked partial it cannot reduce; a one-hot masked sum
        # is the same value (one term, the rest exact zeros) and reduces as
        # a plain sum
        hot = torch.arange(logits.shape[-1], device=logits.device) \
            == targets.long()[..., None]
        gold = torch.where(hot, logits, 0.0).sum(-1)
    else:
        gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
