"""Shared neural-net layers of the dense transformer, functional in torch.

The dense subset of the JAX package's ``models/layers.py``, function for
function: params are nested dicts of tensors with the reference's names and
layouts (dense weights ``[in, out]``), activations flow in ``cfg.dtype`` and
softmax/norm statistics accumulate in float32.  Decode caches are dicts of
tensors with static shapes; sliding-window caches are ring buffers storing
absolute positions (-1 = empty), so one attention code path serves full,
windowed and ring-buffer caches.

Differences from the reference, none of which changes a result:

* ``sharding.constrain`` is the identity without a mesh and is dropped.
* Torch has no scatter ``mode="drop"``: ``attention_apply`` masks the ring
  buffer's writes instead, and writes the cache IN PLACE (the reference
  returns a new cache) so a full-width cache is never copied per step.
* ``preferred_element_type=float32`` becomes float32 operands (a bf16 →
  float32 cast is exact, so the products are the same).

MLA, MoE and cross-attention are not ported yet (ROADMAP queue 1, model
zoo): ``TransformerLM`` and ``attention_apply`` raise on them.
"""
from __future__ import annotations

import itertools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig

Params = Dict[str, Any]

NOT_PORTED = "not ported yet (ROADMAP queue 1, model zoo)"


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


# ---------------------------------------------------------------------------
# normalisation
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype, *, device="cpu", lead=()) -> Params:
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
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


def _write_ring(cache: Params, k: torch.Tensor, v: torch.Tensor,
                positions: torch.Tensor) -> None:
    """Write new k/v [B, Lq, Hkv, D] into the ring buffer at slot = pos % W,
    in place.  Of more than W new tokens only the last W are kept, as the
    reference's out-of-bounds slot with ``mode="drop"`` keeps them, so
    slots never collide."""
    b, lq = k.shape[:2]
    w = cache["k"].shape[1]
    pos_b = torch.broadcast_to(positions, (lq,)).to(torch.int32)
    if lq > 1:
        keep = pos_b >= (pos_b[-1] - w + 1)
        idx = torch.nonzero(keep).flatten()       # host sync: prefill only
        k, v, pos_b = k[:, idx], v[:, idx], pos_b[idx]
    # (one new token is always kept: pos >= pos - W + 1)
    slots = (pos_b % w).long()
    cache["k"].index_copy_(1, slots, k.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slots, v.to(cache["v"].dtype))
    cache["pos"].index_copy_(1, slots,
                             torch.broadcast_to(pos_b, (b, pos_b.shape[0])))


def attention_apply(params: Params, x: torch.Tensor, *, cfg: ModelConfig,
                    positions: torch.Tensor,
                    cache: Optional[Params] = None,
                    kv_input: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    window: int = 0) -> Tuple[torch.Tensor, Optional[Params]]:
    """Unified attention.

    * train/prefill: ``cache is None`` or to-be-filled; ``x`` is [B, L, d].
    * decode:        ``cache`` holds past K/V; ``x`` is [B, 1, d].

    Returns (out [B, L, d], the cache written in place, or None).
    """
    if kv_input is not None:
        raise NotImplementedError(f"cross-attention is {NOT_PORTED}")
    b, lq, _ = x.shape
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.num_heads, cfg.num_kv_heads

    q = (x @ params["w_q"]).reshape(b, lq, hq, hd)
    k = (x @ params["w_k"]).reshape(b, lq, hkv, hd)
    v = (x @ params["w_v"]).reshape(b, lq, hkv, hd)

    if cfg.attention != "none":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)

    q_pos = torch.broadcast_to(positions, (b, lq))
    if cache is not None:
        _write_ring(cache, k, v, positions)
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

    if cfg.attn_impl == "pallas" and cache is None:
        from repro_torch.kernels import flash_attention as fa
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
    else:
        out = sdpa(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=causal,
                   window=window, cast_f32=cfg.attn_cast_f32)
    out = out.reshape(b, lq, hq * hd) @ params["w_o"]
    return out, cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

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
    return h @ params[prefix + "w_down"]


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
    return params["tok_embed"][tokens.long()]


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    if "lm_head" in params:
        return x @ params["lm_head"]
    return x @ params["tok_embed"].T


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token cross-entropy in f32. logits [..., V], targets [...] int."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)
