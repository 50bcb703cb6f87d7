"""MusicGen-style audio decoder over EnCodec tokens. [arXiv:2306.05284]

The port of the JAX package's ``models/audio.py``.  The EnCodec codec is a
stub, as in the reference: the model consumes and produces discrete codec
tokens.  MusicGen's delay-pattern multi-codebook stream is modelled with K
parallel codebooks: the input embedding is the sum of the per-codebook
embeddings, and K parallel LM heads give the output.  Tokens are [B, L, K],
logits [B, L, K, V].  The reference writes its own ``forward`` (the same
layer scan without the image path); here ``AudioLM`` overrides only the
transformer's ``_embed`` and ``_unembed``, and a model without cross
layers ignores ``image_embeds``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch import sharding
from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models.transformer import Params, TransformerLM


class AudioLM(TransformerLM):
    """tokens have shape [B, L, K] (K = num_audio_codebooks)."""

    def __init__(self, cfg: ModelConfig, moe_impl: str = "gather"):
        if cfg.num_audio_codebooks <= 0:
            raise ValueError("the audio family needs num_audio_codebooks > 0")
        super().__init__(cfg, moe_impl)
        self.k_cb = cfg.num_audio_codebooks

    def init(self, gen: Optional[torch.Generator], *, device=None) -> Params:
        """The transformer's params with per-codebook embeddings [K, V, d]
        and heads [K, d, V] in place of the single-stream ones."""
        cfg = self.cfg
        if device is None:
            device = gen.device if gen is not None else "cuda"
        params = super().init(gen, device=device)
        dt = L._dt(cfg)
        shape = (self.k_cb, cfg.vocab_size, cfg.d_model)
        tok_embed = torch.empty(shape, dtype=dt, device=device)
        lm_head = torch.empty((self.k_cb, cfg.d_model, cfg.vocab_size),
                              dtype=dt, device=device)
        if tok_embed.device.type != "meta":
            tok_embed.copy_(L.normal(gen, shape, device) * 0.02)
            for i in range(self.k_cb):    # one f32 head at a time
                lm_head[i] = (L.normal(gen, lm_head.shape[1:], device)
                              / math.sqrt(cfg.d_model)).to(dt)
        params["embedding"] = {"tok_embed": tok_embed, "lm_head": lm_head}
        return params

    def _embed(self, params: Params, tokens: torch.Tensor) -> torch.Tensor:
        """tokens [B, L, K] -> sum_k embed_k(tokens[..., k]), added in the
        reference's order and dtype: ((e0 + e1) + e2) + ..., each sum
        rounded to the params' dtype (a reduction over K in float32 would
        round once, and differ in bf16)."""
        emb = params["embedding"]["tok_embed"]                      # [K, V, d]
        x = L.embed({"tok_embed": emb[0]}, tokens[..., 0])
        for i in range(1, self.k_cb):
            x = x + L.embed({"tok_embed": emb[i]}, tokens[..., i])
        return x

    def _unembed(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        # [B, L, d] -> [B, L, K, V]
        head = params["embedding"]["lm_head"]
        if isinstance(x, DTensor):
            return _unembed_shards(x, head)
        return torch.einsum("bld,kdv->blkv", x, head)

    def loss(self, params, batch, rng=None):
        logits, _, aux = self.forward(params, batch["tokens"])   # [B,L,K,V]
        targets = batch["targets"]                               # [B,L,K]
        mask = batch.get("mask")
        if mask is not None:
            mask = mask[..., None] * torch.ones_like(targets,
                                                     dtype=torch.float32)
        ce = L.cross_entropy(logits, targets, mask)
        return ce + aux, {"ce": ce, "aux": aux}


def _unembed_shards(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    """The K heads on DTensors, each rank on its own batch rows and vocab
    shard (``sharding.map_local``): DTensor's own einsum of a batch-split
    x with a [K, d, V] head split on d and V reshapes a local tensor it
    cannot view.  x's gradient sums over the vocab shards, the head's over
    the batch shards."""
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    m = mesh.shape[names.index("model")] if "model" in names else 1
    batch = tuple(n for n in ("pod", "data") if n in names) or None
    vocab = "model" if m > 1 and head.shape[-1] % m == 0 else None
    xp = sharding.spec_placements((batch, None, None), mesh)
    hp = sharding.spec_placements((None, None, vocab), mesh)
    return sharding.map_local(
        lambda a, w: torch.einsum("bld,kdv->blkv", a, w), (x, head),
        (xp, hp), (sharding.spec_placements((batch, None, None, vocab),
                                            mesh),),
        (sharding.summed(xp, (vocab,), mesh),
         sharding.summed(hp, batch or (), mesh)))
