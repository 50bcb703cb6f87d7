"""Decoder-only transformer stack: dense (llama-style GQA/RoPE, sliding
window) and MoE (Mixtral: GQA + mixture of experts; DeepSeek-V2: MLA +
routed and shared experts).

The port of the JAX package's ``models/transformer.py`` for ``family``
"dense" and "moe".  Params keep the reference's names and its stacked
leading layer axis (``params["layers"][name]`` is ``[num_layers, ...]``,
the experts ``params["layers"]["moe"]`` likewise), so the JAX package's
params carried over as numpy (``utils.tree.from_numpy_tree``) are the
port's params.  The reference scans the stack with ``lax.scan``; here a
Python loop walks the layer axis, taking views.  ``cfg.remat``
(activation checkpointing) changes memory, not results, and is not
applied: this slice serves and scores, it does not train at full width.

With ``cfg.attn_impl == "pallas"`` a GQA call without a cache
(``forward``, ``loss``, ``predict``) runs attention through the flash
kernel (``kernels/flash_attention.py``); prefill and decode go through
``sdpa``, and MLA always does, as in the reference.  ``prefill`` and
``decode_step`` write the cache in place and return it.

Cross-attention (the vlm family) is not ported yet (ROADMAP queue 1), nor
is ``moe_impl="ep"`` (queue 1, item 5: it needs a device mesh).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

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
        if cfg.cross_attn_every:
            raise NotImplementedError(f"cross-attention is {L.NOT_PORTED}")
        self.cfg = cfg
        self.moe_impl = moe_impl
        self.is_moe = cfg.moe is not None
        self.is_mla = cfg.attention == "mla"
        if self.is_moe and moe_impl == "ep":
            raise NotImplementedError(f"moe_impl='ep' is {L.NO_MESH}")

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
        return {
            "embedding": L.embedding_init(gen, cfg, device=device),
            "final_norm": norm_init(cfg.d_model, dt, device=device),
            "layers": layer,
        }

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
            return x + ffn_out, aux
        return x + L.mlp_apply(p, h, cfg), None

    # --------------------------------------------------------- forward ----
    def forward(self, params: Params, tokens: torch.Tensor, *,
                positions: Optional[torch.Tensor] = None,
                cache: Optional[Params] = None,
                image_embeds: Optional[torch.Tensor] = None,
                window: Optional[int] = None,
                ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
        """Returns (logits [B, L, V], the cache written in place or None,
        aux_loss)."""
        if image_embeds is not None:
            raise NotImplementedError(f"cross-attention is {L.NOT_PORTED}")
        cfg = self.cfg
        lq = tokens.shape[1]
        if positions is None:
            positions = torch.arange(lq, dtype=torch.int32,
                                     device=tokens.device)
        win = cfg.sliding_window if window is None else window

        x = L.embed(params["embedding"], tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.num_layers):
            lp = tree_map(lambda a: a[i], params["layers"])
            lc = (tree_map(lambda a: a[i], cache) if cache is not None
                  else None)
            x, a = self._layer_apply(lp, x, positions, lc, win)
            if a is not None:
                aux = aux + a

        x = L.make_norm(cfg)[1](params["final_norm"], x)
        logits = L.unembed(params["embedding"], x)
        return logits, cache, aux

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
                window: Optional[int] = None
                ) -> Tuple[torch.Tensor, Params]:
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
