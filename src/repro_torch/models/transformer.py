"""Decoder-only transformer stack: dense (llama-style GQA/RoPE, sliding
window), MoE (Mixtral: GQA + mixture of experts; DeepSeek-V2: MLA +
routed and shared experts) and the gated cross-attention interleave of the
vlm family (Llama-3.2-Vision).

The port of the JAX package's ``models/transformer.py``.  Params keep the
reference's names and its stacked leading layer axis
(``params["layers"][name]`` is ``[num_layers, ...]``, the experts
``params["layers"]["moe"]`` likewise, the cross layers
``params["cross_layers"][name]`` ``[n_cross, ...]``), so the JAX package's
params carried over as numpy (``utils.tree.from_numpy_tree``) are the
port's params.  The reference scans the stack with ``lax.scan`` (over
groups of ``cross_attn_every`` self layers and one cross layer when the
model has cross layers); here a Python loop walks the layer axis, taking
views, and runs cross layer ``j`` after self layer ``(j + 1) *
cross_attn_every - 1``, the same order.  The self layers keep their
indices into the cache; the cross layers have none.  ``cfg.remat``
(activation checkpointing) changes memory, not results, and is not
applied: the port serves and scores at full width, it does not train
there.

With ``cfg.attn_impl == "pallas"`` a GQA self-attention call without a
cache (``forward``, ``loss``, ``predict``) runs through the flash kernel
(``kernels/flash_attention.py``); prefill, decode, cross-attention and MLA
go through ``sdpa``, as in the reference.  ``prefill`` and ``decode_step``
write the cache in place and return it.

``moe_impl="ep"`` runs ``layers.moe_apply_ep`` (expert parallelism on
the active mesh; the gather MoE without one).  ``sharding.constrain``
stands at the reference's call sites (tokens, the embedding, each
layer's output, the logits); the audio subclass shares them, where the
reference's own audio forward has the embedding's.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import sharding
from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.utils.tree import tree_map

Params = Dict[str, Any]


class TransformerLM:
    """Language model over integer tokens.

    Public API (as in the reference):
      init(gen) -> params
      loss(params, batch, rng) -> (scalar_loss, metrics)
      forward(params, tokens, ...) -> (logits, cache, aux)
      prefill(params, tokens, cache_len) -> (logits_last, cache)
      decode_step(params, cache, tokens, pos) -> (logits, cache)
    """

    def __init__(self, cfg: ModelConfig, moe_impl: str = "gather"):
        self.cfg = cfg
        self.moe_impl = moe_impl
        self.is_moe = cfg.moe is not None
        self.is_mla = cfg.attention == "mla"
        self.n_cross = (cfg.num_layers // cfg.cross_attn_every
                        if cfg.cross_attn_every else 0)
        if self.n_cross and cfg.num_layers % cfg.cross_attn_every:
            raise ValueError(f"{cfg.num_layers} layers do not group by "
                             f"cross_attn_every={cfg.cross_attn_every}")

    # ------------------------------------------------------------- init ---
    def init(self, gen: Optional[torch.Generator], *, device=None) -> Params:
        """Random params drawn from ``gen`` on ``gen``'s device, or on
        ``device``, or else on the card; ``device="meta"`` gives shapes and
        dtypes only."""
        cfg = self.cfg
        if device is None:
            device = gen.device if gen is not None else "cuda"
        dt = L._dt(cfg)
        norm_init, _ = L.make_norm(cfg)
        kw = dict(device=device, lead=(cfg.num_layers,))
        layer = {
            "norm_attn": norm_init(cfg.d_model, dt, **kw),
            "norm_ffn": norm_init(cfg.d_model, dt, **kw),
            "attn": (L.mla_init(gen, cfg, **kw) if self.is_mla
                     else L.attention_init(gen, cfg, **kw)),
        }
        if self.is_moe:
            layer["moe"] = L.moe_init(gen, cfg, **kw)
        else:
            layer.update(L.mlp_init(gen, cfg, **kw))
        params = {
            "embedding": L.embedding_init(gen, cfg, device=device),
            "final_norm": norm_init(cfg.d_model, dt, device=device),
            "layers": layer,
        }
        if self.n_cross:
            kw = dict(device=device, lead=(self.n_cross,))
            params["cross_layers"] = {
                "norm_cross": norm_init(cfg.d_model, dt, **kw),
                "attn": L.attention_init(gen, cfg, **kw),
                # zero-init gated residual: a new cross layer starts as
                # the identity
                "gate_cross": torch.zeros(self.n_cross, dtype=dt,
                                          device=device),
            }
        return params

    # ---------------------------------------------------------- layers ----
    def _layer_apply(self, p: Params, x: torch.Tensor,
                     positions: torch.Tensor, cache: Optional[Params],
                     window: int
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One layer → (x, its router's aux loss, or None without
        experts)."""
        cfg = self.cfg
        _, norm = L.make_norm(cfg)
        h = norm(p["norm_attn"], x)
        if self.is_mla:
            attn_out, _ = L.mla_apply(p["attn"], h, cfg=cfg,
                                      positions=positions, cache=cache,
                                      window=window)
        else:
            attn_out, _ = L.attention_apply(p["attn"], h, cfg=cfg,
                                            positions=positions, cache=cache,
                                            causal=True, window=window)
        x = x + attn_out
        h = norm(p["norm_ffn"], x)
        if self.is_moe:
            ffn_out, aux = L.moe_apply(p["moe"], h, cfg, impl=self.moe_impl)
        else:
            ffn_out, aux = L.mlp_apply(p, h, cfg), None
        return sharding.constrain(x + ffn_out, "batch", None, None), aux

    def _cross_apply(self, p: Params, x: torch.Tensor, kv: torch.Tensor
                     ) -> torch.Tensor:
        """One gated cross-attention layer over ``kv`` [B, Lk, d]:
        x + tanh(gate) * attention."""
        _, norm = L.make_norm(self.cfg)
        h = norm(p["norm_cross"], x)
        out, _ = L.attention_apply(
            p["attn"], h, cfg=self.cfg,
            positions=torch.zeros((1,), dtype=torch.int32, device=x.device),
            kv_input=kv, causal=False)
        return x + torch.tanh(p["gate_cross"]).to(x.dtype) * out

    # --------------------------------------------------------- forward ----
    def forward(self, params: Params, tokens: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[Params] = None,
                image_embeds: Optional[torch.Tensor] = None,
                window: Optional[int] = None,
                ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
        """Returns (logits [B, L, V], the cache written in place or None,
        aux_loss).  A model with cross layers needs ``image_embeds`` [B,
        N_img, d]; the others ignore it, as in the reference."""
        cfg = self.cfg
        if self.n_cross and image_embeds is None:
            raise ValueError("a forward with cross layers needs "
                             "image_embeds")
        lq = tokens.shape[1]
        if positions is None:
            positions = torch.arange(lq, dtype=torch.int32,
                                     device=tokens.device)
        win = cfg.sliding_window if window is None else window

        tokens = sharding.constrain(tokens, "batch", None)
        x = sharding.constrain(self._embed(params, tokens), "batch", None,
                               None)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.num_layers):
            lp = tree_map(lambda a: a[i], params["layers"])
            lc = (tree_map(lambda a: a[i], cache) if cache is not None
                  else None)
            x, a = self._layer_apply(lp, x, positions, lc, win)
            if a is not None:
                aux = aux + a
            if self.n_cross and (i + 1) % cfg.cross_attn_every == 0:
                j = (i + 1) // cfg.cross_attn_every - 1
                x = self._cross_apply(
                    tree_map(lambda a: a[j], params["cross_layers"]), x,
                    image_embeds)

        x = L.make_norm(cfg)[1](params["final_norm"], x)
        return self._unembed(params, x), cache, aux

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        return L.embed(params["embedding"], tokens)

    def _unembed(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return sharding.constrain(L.unembed(params["embedding"], x),
                                  "batch", None, "vocab")

    # ------------------------------------------------------------ loss ----
    def loss(self, params: Params, batch: Dict[str, torch.Tensor], rng=None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        logits, _, aux = self.forward(params, batch["tokens"],
                                      image_embeds=batch.get("image_embeds"))
        ce = L.cross_entropy(logits, batch["targets"], batch.get("mask"))
        return ce + aux, {"ce": ce, "aux": aux}

    def predict(self, params: Params, batch: Dict[str, torch.Tensor]
                ) -> torch.Tensor:
        logits, _, _ = self.forward(params, batch["tokens"],
                                    image_embeds=batch.get("image_embeds"))
        return logits

    # ------------------------------------------------------- serving ------
    def init_cache(self, batch: int, cache_len: int, *, device="cuda"
                   ) -> Params:
        if self.is_mla:
            return L.init_mla_cache(self.cfg, batch, cache_len, device=device)
        return L.init_kv_cache(self.cfg, batch, cache_len, device=device)

    def prefill(self, params: Params, tokens: torch.Tensor, cache_len: int,
                *, image_embeds: Optional[torch.Tensor] = None,
                window: Optional[int] = None, cache: Optional[Params] = None
                ) -> Tuple[torch.Tensor, Params]:
        """``cache``: an empty cache (as ``init_cache`` makes it) to fill in
        place, such as one placed on a mesh; a new one by default."""
        if cache is None:
            cache = self.init_cache(tokens.shape[0], cache_len,
                                    device=tokens.device)
        logits, cache, _ = self.forward(params, tokens, cache=cache,
                                        image_embeds=image_embeds,
                                        window=window)
        return logits[:, -1:], cache

    def decode_step(self, params: Params, cache: Params, tokens: torch.Tensor,
                    pos, *, image_embeds: Optional[torch.Tensor] = None,
                    window: Optional[int] = None
                    ) -> Tuple[torch.Tensor, Params]:
        """tokens [B, 1]; pos: absolute position of this token (an int or a
        scalar tensor)."""
        positions = torch.as_tensor(pos, device=tokens.device).reshape(1) \
            .to(torch.int32)
        logits, cache, _ = self.forward(params, tokens, positions=positions,
                                        cache=cache,
                                        image_embeds=image_embeds,
                                        window=window)
        return logits, cache
