"""RecurrentGemma-style hybrid: RG-LRU recurrent blocks + local attention,
interleaved 2:1 (two recurrent blocks, then one local-MQA block).
[arXiv:2402.19427]

The port of the JAX package's ``models/hybrid.py``.  Params keep the
reference's names and stacking: ``rec_layers`` ``[n_groups, 2, ...]``,
``attn_layers`` ``[n_groups, ...]`` and ``tail_layers`` ``[n_tail, ...]``,
so the JAX package's params carried over as numpy
(``utils.tree.from_numpy_tree``) are the port's params.  The reference
scans the stacks with ``lax.scan``; here Python loops walk them, taking
views.  ``cfg.remat`` checkpoints each block of the groups in the
training forward (``layers.remat``), the tail's recurrent blocks not, as
the reference does (memory changes, results do not).

The linear recurrence h_t = a_t h_{t-1} + b_t runs as a log-depth scan in
plain torch at train/prefill time (``rglru_scan``: the reference's
``associative_scan`` combine, doubling over the time axis, 12 steps at L
4,096) and as an O(1) step at decode time.  The reference has no kernel
for it.  With ``cfg.attn_impl == "pallas"`` the attention blocks of a call
without a cache (``forward``, ``loss``, ``predict``) run the flash kernel
(``kernels/flash_attention.py``, head dim 256 at full width), one launch
per attention block; ``prefill`` and ``decode_step`` go through ``sdpa``,
as in the reference, and write the cache in place.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch


from repro_torch import sharding
from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.utils.tree import tree_map

Params = Dict[str, Any]

_C_RGLRU = 8.0   # Griffin's fixed exponent scale


def _lru_width(cfg: ModelConfig) -> int:
    return cfg.hybrid.lru_width or cfg.d_model


# ---------------------------------------------------------------------------
# RG-LRU core
# ---------------------------------------------------------------------------

def _decay_and_input(u, log_a, gate_i):
    a = torch.exp(log_a)
    # multiplier sqrt(1 - a^2), computed stably from log a
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, mult * (gate_i * u)


def rglru_scan(u: torch.Tensor, log_a: torch.Tensor, gate_i: torch.Tensor,
               h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gated linear recurrence over time.

    u       [B, L, W]  inputs (post input-gate)
    log_a   [B, L, W]  per-step log decay (<= 0)
    gate_i  [B, L, W]  input gate in [0, 1]
    Returns (h [B, L, W], h_last [B, W]).

    An inclusive scan with the reference's combine (a1 a2, a2 b1 + b2),
    by doubling: after the step of offset d, position t holds the
    composition of steps (t - 2d, t]; ceil(log2 L) steps in all.  Nothing
    is written in place, so autograd runs through it.
    """
    a, b = _decay_and_input(u, log_a, gate_i)
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    lq = b.shape[1]
    d = 1
    while d < lq:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        if 2 * d < lq:
            a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b, b[:, -1]


def rglru_step(h: torch.Tensor, u: torch.Tensor, log_a: torch.Tensor,
               gate_i: torch.Tensor) -> torch.Tensor:
    a, b = _decay_and_input(u, log_a, gate_i)
    return a * h + b


class RecurrentGemmaLM:
    """Language model over integer tokens.

    Public API (as in the reference):
      init(gen) -> params
      loss(params, batch, rng) -> (scalar_loss, metrics)
      forward(params, tokens) -> (logits, None, aux)
      prefill(params, tokens, cache_len) -> (logits_last, cache)
      decode_step(params, cache, tokens, pos) -> (logits, cache)
    """

    def __init__(self, cfg: ModelConfig):
        pat = cfg.hybrid.pattern
        if pat.count("attn") != 1 or len(pat) != 3:
            raise ValueError(f"expect 2 rglru : 1 attn, got {pat}")
        self.cfg = cfg
        self.group = len(pat)
        self.n_groups = cfg.num_layers // self.group
        self.n_tail = cfg.num_layers - self.n_groups * self.group

    # ------------------------------------------------------------- init ---
    def _rec_layers_init(self, gen, lead, device) -> Params:
        cfg = self.cfg
        w = _lru_width(cfg)
        dt = L._dt(cfg)
        kw = dict(device=device, lead=lead)
        conv_w = torch.empty(lead + (4, w), dtype=dt, device=device)
        if conv_w.device.type != "meta":
            for idx in L.lead_indices(lead):
                conv_w[idx] = (L.normal(gen, (4, w), device) / 2.0).to(dt)
        # Λ init so a^c ∈ (0.9, 0.999)-ish
        lru_a = torch.log(torch.expm1(-torch.log(torch.linspace(
            0.9, 0.999, w, dtype=torch.float32, device=device)) / _C_RGLRU))
        return {
            "norm_attn": L.rmsnorm_init(cfg.d_model, dt, **kw),
            "lru_in": L.dense_init(gen, cfg.d_model, w, dt, **kw),
            "lru_in_gate": L.dense_init(gen, cfg.d_model, w, dt, **kw),
            "conv_w": conv_w,
            "conv_b": torch.zeros(lead + (w,), dtype=dt, device=device),
            "lru_gate_a": L.dense_init(gen, w, w, dt, **kw),
            "lru_gate_i": L.dense_init(gen, w, w, dt, **kw),
            "lru_a": lru_a.expand(lead + (w,)).clone(),
            "lru_out": L.dense_init(gen, w, cfg.d_model, dt,
                                    scale=1.0 / math.sqrt(w * cfg.num_layers),
                                    **kw),
            "norm_ffn": L.rmsnorm_init(cfg.d_model, dt, **kw),
            **L.mlp_init(gen, cfg, **kw),
        }

    def _attn_layers_init(self, gen, lead, device) -> Params:
        cfg = self.cfg
        dt = L._dt(cfg)
        kw = dict(device=device, lead=lead)
        return {
            "norm_attn": L.rmsnorm_init(cfg.d_model, dt, **kw),
            "attn": L.attention_init(gen, cfg, **kw),
            "norm_ffn": L.rmsnorm_init(cfg.d_model, dt, **kw),
            **L.mlp_init(gen, cfg, **kw),
        }

    def init(self, gen: Optional[torch.Generator], *, device=None) -> Params:
        """Random params drawn from ``gen`` on ``gen``'s device, or on
        ``device``, or else on the card; ``device="meta"`` gives shapes and
        dtypes only."""
        cfg = self.cfg
        if device is None:
            device = gen.device if gen is not None else "cuda"
        p: Params = {
            "embedding": L.embedding_init(gen, cfg, device=device),
            "final_norm": L.rmsnorm_init(cfg.d_model, L._dt(cfg),
                                         device=device),
            "rec_layers": self._rec_layers_init(gen, (self.n_groups, 2),
                                                device),
            "attn_layers": self._attn_layers_init(gen, (self.n_groups,),
                                                  device),
        }
        if self.n_tail:
            p["tail_layers"] = self._rec_layers_init(gen, (self.n_tail,),
                                                     device)
        return p

    # ---------------------------------------------------------- blocks ----
    def _rec_apply(self, pl: Params, x: torch.Tensor, *,
                   conv_state: Optional[torch.Tensor] = None,
                   h_state: Optional[torch.Tensor] = None,
                   decode: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """One recurrent block → (out, conv tail [B, 3, W], h_last [B, W]),
        the last two in x's dtype."""
        cfg = self.cfg
        resid = x
        xn = L.rmsnorm(pl["norm_attn"], x)
        u = xn @ pl["lru_in"]                                        # [B,L,W]
        gate_branch = L._act("gelu")(xn @ pl["lru_in_gate"])
        lq = u.shape[1]
        cw = pl["conv_w"].shape[0]
        if decode:
            hist = torch.cat([conv_state, u], dim=1)                 # [B,cw,W]
            u_c = (torch.einsum("bwc,wc->bc", hist, pl["conv_w"])
                   + pl["conv_b"])[:, None, :]
            new_conv = hist[:, 1:, :]
        else:
            pad = L.pad_seq(u, cw - 1)
            u_c = sum(pad[:, i:i + lq, :] * pl["conv_w"][i][None, None, :]
                      for i in range(cw)) + pl["conv_b"]
            new_conv = pad[:, pad.shape[1] - (cw - 1):, :]
        r = torch.sigmoid(u_c @ pl["lru_gate_a"]).float()
        gi = torch.sigmoid(u_c @ pl["lru_gate_i"]).float()
        log_a = -_C_RGLRU * L.softplus(pl["lru_a"])[None, None, :] * r
        uf = u_c.float()
        if decode:
            h_last = rglru_step(h_state.float(), uf[:, 0, :], log_a[:, 0, :],
                                gi[:, 0, :])
            hseq = h_last[:, None, :]
        else:
            hseq, h_last = rglru_scan(
                uf, log_a, gi,
                h0=None if h_state is None else h_state.float())
        y = (hseq.to(x.dtype) * gate_branch) @ pl["lru_out"]
        x = resid + y
        h2 = L.rmsnorm(pl["norm_ffn"], x)
        x = x + L.mlp_apply(pl, h2, cfg)
        return x, new_conv.to(x.dtype), h_last.to(x.dtype)

    def _attn_apply(self, pl: Params, x: torch.Tensor, positions, cache,
                    window) -> torch.Tensor:
        cfg = self.cfg
        h = L.rmsnorm(pl["norm_attn"], x)
        out, _ = L.attention_apply(pl["attn"], h, cfg=cfg,
                                   positions=positions, cache=cache,
                                   causal=True, window=window)
        x = x + out
        h = L.rmsnorm(pl["norm_ffn"], x)
        return x + L.mlp_apply(pl, h, cfg)

    def _blocks(self, params: Params):
        """The stack in order: ("rec", params, index into the cache's
        recurrent axis) or ("attn", params, index into its attention
        axis)."""
        for g in range(self.n_groups):
            for j in range(2):
                yield "rec", tree_map(lambda t: t[g, j],
                                      params["rec_layers"]), 2 * g + j
            yield "attn", tree_map(lambda t: t[g], params["attn_layers"]), g
        for i in range(self.n_tail):
            yield "rec", tree_map(lambda t: t[i], params["tail_layers"]), \
                2 * self.n_groups + i

    # --------------------------------------------------------- forward ----
    def forward(self, params: Params, tokens: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None, cache=None, **_kw):
        cfg = self.cfg
        if positions is None:
            positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                     device=tokens.device)
        window = cfg.hybrid.attention_window
        x = sharding.constrain(L.embed(params["embedding"], tokens), "batch",
                               None, None)
        def rec(lp, xi):
            return self._rec_apply(lp, xi)[0]

        # the groups' blocks checkpointed, the tail's not, as the reference
        rec_one = L.remat(rec, cfg.remat)
        attn_one = L.remat(lambda lp, xi: self._attn_apply(
            lp, xi, positions, None, window), cfg.remat)
        tail = 2 * self.n_groups
        for kind, lp, i in self._blocks(params):
            if kind == "attn":
                x = attn_one(lp, x)
            else:
                x = (rec_one if i < tail else rec)(lp, x)
        x = L.rmsnorm(params["final_norm"], x)
        logits = L.unembed(params["embedding"], x)
        return logits, None, torch.zeros((), dtype=torch.float32,
                                         device=logits.device)

    def loss(self, params: Params, batch: Dict[str, torch.Tensor], rng=None):
        logits, _, _ = self.forward(params, batch["tokens"])
        ce = L.cross_entropy(logits, batch["targets"], batch.get("mask"))
        return ce, {"ce": ce}

    def predict(self, params: Params, batch: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
        return self.forward(params, batch["tokens"])[0]

    # ------------------------------------------------------- serving ------
    def init_cache(self, batch: int, cache_len: int, *, device="cuda"
                   ) -> Params:
        """Conv tails and RG-LRU states of the recurrent blocks, and a ring
        KV cache of min(cache_len, window) slots for the attention blocks."""
        cfg = self.cfg
        w = _lru_width(cfg)
        dt = L._dt(cfg)
        window = min(cache_len, cfg.hybrid.attention_window)
        n_rec = self.n_groups * 2 + self.n_tail
        return {
            "conv": torch.zeros((n_rec, batch, 3, w), dtype=dt,
                                device=device),
            "h": torch.zeros((n_rec, batch, w), dtype=dt, device=device),
            "attn": L.init_kv_cache(cfg, batch, window,
                                    num_layers=self.n_groups, device=device),
        }

    def _run_with_cache(self, params: Params, tokens: torch.Tensor,
                        cache: Params, positions: torch.Tensor, decode: bool
                        ) -> Tuple[torch.Tensor, Params]:
        """The stack over ``tokens`` with the cache; writes every layer's
        new conv tail, state and KV entries into ``cache`` in place."""
        window = self.cfg.hybrid.attention_window
        x = L.embed(params["embedding"], tokens)
        for kind, lp, i in self._blocks(params):
            if kind == "rec":
                x, new_conv, new_h = self._rec_apply(
                    lp, x, conv_state=cache["conv"][i],
                    h_state=cache["h"][i] if decode else None, decode=decode)
                cache["conv"][i].copy_(new_conv)
                cache["h"][i].copy_(new_h)
            else:
                x = self._attn_apply(lp, x, positions,
                                     tree_map(lambda t: t[i], cache["attn"]),
                                     window)
        return L.rmsnorm(params["final_norm"], x), cache

    def prefill(self, params: Params, tokens: torch.Tensor, cache_len: int,
                *, cache: Optional[Params] = None, **_kw
                ) -> Tuple[torch.Tensor, Params]:
        """``cache``: an empty cache to fill in place (a new one by
        default)."""
        if cache is None:
            cache = self.init_cache(tokens.shape[0], cache_len,
                                    device=tokens.device)
        positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)
        x, cache = self._run_with_cache(params, tokens, cache, positions,
                                        decode=False)
        return L.unembed(params["embedding"], x[:, -1:]), cache

    def decode_step(self, params: Params, cache: Params, tokens: torch.Tensor,
                    pos, **_kw) -> Tuple[torch.Tensor, Params]:
        """tokens [B, 1]; pos: absolute position of this token (an int or a
        scalar tensor)."""
        positions = torch.as_tensor(pos, device=tokens.device).reshape(1) \
            .to(torch.int32)
        x, cache = self._run_with_cache(params, tokens, cache, positions,
                                        decode=True)
        return L.unembed(params["embedding"], x), cache
