"""Llama-3.2-Vision-style VLM text decoder. [hf:meta-llama/Llama-3.2-11B-Vision]

The port of the JAX package's ``models/vlm.py``.  The vision frontend (ViT
encoder + projector) is a stub, as in the reference: ``image_embeds`` [B,
N_img, d_model] stand in for the patch embeddings, and when a call gives
none, ``stub_image_embeds`` makes the reference's deterministic stand-in.
The language decoder is ``TransformerLM`` with a gated cross-attention
layer after every ``cfg.cross_attn_every`` self-attention layers.

Every decode step projects the image tokens to K and V again in each cross
layer, as the reference does: there is no cross K/V cache.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import TransformerLM


class VisionLM(TransformerLM):
    """TransformerLM + mandatory image embeddings through cross-attention."""

    def __init__(self, cfg: ModelConfig, moe_impl: str = "gather"):
        if cfg.cross_attn_every <= 0:
            raise ValueError("the vlm family needs cross_attn_every > 0")
        super().__init__(cfg, moe_impl)

    def stub_image_embeds(self, batch: int, dtype=None, *, device="cuda"
                          ) -> torch.Tensor:
        """Deterministic stand-in for the ViT+projector output: sin(i *
        0.001) * 0.02 over the flat index i of [N_img, d], in float32,
        then cast to the config's dtype."""
        cfg = self.cfg
        n = cfg.num_image_tokens or 576
        dt = dtype or L._dt(cfg)
        base = torch.arange(n * cfg.d_model, dtype=torch.float32,
                            device=device)
        emb = torch.sin(base * 0.001).reshape(n, cfg.d_model) * 0.02
        return torch.broadcast_to(emb[None], (batch, n, cfg.d_model)).to(dt)

    def _image(self, tokens: torch.Tensor,
               image_embeds: Optional[torch.Tensor]) -> torch.Tensor:
        if image_embeds is not None:
            return image_embeds
        return self.stub_image_embeds(tokens.shape[0], device=tokens.device)

    def predict(self, params, batch):
        logits, _, _ = self.forward(
            params, batch["tokens"],
            image_embeds=self._image(batch["tokens"],
                                     batch.get("image_embeds")))
        return logits

    def loss(self, params, batch, rng=None):
        tokens = batch["tokens"]
        logits, _, aux = self.forward(
            params, tokens,
            image_embeds=self._image(tokens, batch.get("image_embeds")))
        ce = L.cross_entropy(logits, batch["targets"], batch.get("mask"))
        return ce + aux, {"ce": ce, "aux": aux}

    def prefill(self, params, tokens, cache_len, *, image_embeds=None,
                window=None):
        return super().prefill(params, tokens, cache_len,
                               image_embeds=self._image(tokens, image_embeds),
                               window=window)

    def decode_step(self, params, cache, tokens, pos, *, image_embeds=None,
                    window=None):
        return super().decode_step(
            params, cache, tokens, pos,
            image_embeds=self._image(tokens, image_embeds), window=window)
