"""Decoder-only transformer stack, dense family (llama-style GQA/RoPE).

The port of the JAX package's ``models/transformer.py`` for ``family ==
"dense"``.  Params keep the reference's names and its stacked leading layer
axis (``params["layers"][name]`` is ``[num_layers, ...]``), so the JAX
package's params carried over as numpy (``utils.tree.from_numpy_tree``)
are the port's params.  The reference scans the stack with ``lax.scan``;
here a Python loop walks the layer axis, taking views.  ``cfg.remat``
(activation checkpointing) changes memory, not results, and is not applied:
this slice serves and scores, it does not train at full width.

With ``cfg.attn_impl == "pallas"`` a call without a cache (``forward``,
``loss``, ``predict``) runs attention through the flash kernel
(``kernels/flash_attention.py``); prefill and decode go through ``sdpa``,
as in the reference.  ``prefill`` and ``decode_step`` write the cache in
place and return it.

MoE, MLA and cross-attention are not ported yet (ROADMAP queue 1, model zoo).
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

    def __init__(self, cfg: ModelConfig):
        if cfg.moe is not None:
            raise NotImplementedError(f"mixture of experts is {L.NOT_PORTED}")
        if cfg.attention == "mla":
            raise NotImplementedError(f"MLA attention is {L.NOT_PORTED}")
        if cfg.cross_attn_every:
            raise NotImplementedError(f"cross-attention is {L.NOT_PORTED}")
        self.cfg = cfg

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
        lead = (cfg.num_layers,)
        layer = {
            "norm_attn": norm_init(cfg.d_model, dt, device=device, lead=lead),
            "norm_ffn": norm_init(cfg.d_model, dt, device=device, lead=lead),
            "attn": L.attention_init(gen, cfg, device=device, lead=lead),
        }
        layer.update(L.mlp_init(gen, cfg, device=device, lead=lead))
        return {
            "embedding": L.embedding_init(gen, cfg, device=device),
            "final_norm": norm_init(cfg.d_model, dt, device=device),
            "layers": layer,
        }

    # ---------------------------------------------------------- layers ----
    def _layer_apply(self, p: Params, x: torch.Tensor,
                     positions: torch.Tensor, cache: Optional[Params],
                     window: int) -> torch.Tensor:
        cfg = self.cfg
        _, norm = L.make_norm(cfg)
        h = norm(p["norm_attn"], x)
        attn_out, _ = L.attention_apply(p["attn"], h, cfg=cfg,
                                        positions=positions, cache=cache,
                                        causal=True, window=window)
        x = x + attn_out
        h = norm(p["norm_ffn"], x)
        return x + L.mlp_apply(p, h, cfg)

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
        for i in range(cfg.num_layers):
            lp = tree_map(lambda a: a[i], params["layers"])
            lc = (tree_map(lambda a: a[i], cache) if cache is not None
                  else None)
            x = self._layer_apply(lp, x, positions, lc, win)

        x = L.make_norm(cfg)[1](params["final_norm"], x)
        logits = L.unembed(params["embedding"], x)
        aux = torch.zeros((), dtype=torch.float32, device=logits.device)
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
