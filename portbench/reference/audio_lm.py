"""Plain reference of the audio family (MusicGen-style decoder over K
EnCodec codebooks) as the configuration runs it: the sum of K codebook
embeddings, pre-norm layers of RMSNorm, multi-head attention with rotary
positions and a causal mask, and a tanh-GELU gated MLP, a final RMSNorm
and K output heads; the loss is the mean cross-entropy over every
position and codebook.  Float32 throughout; params are read as float32
a layer at a time, so the stack is never held in float32 at once."""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference.common import (EXACT, Numerics, cross_entropy, nll,
                                        rmsnorm, rope)

HEAD_BLOCK = 8            # query heads scored at a time (bounds memory)


def _attention(x, p, cfg, num):
    b, sl, _ = x.shape
    hq, hkv = cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg["d_model"] // hq
    q = num.mm(x, p["w_q"]).view(b, sl, hq, hd)
    k = num.mm(x, p["w_k"]).view(b, sl, hkv, hd)
    v = num.mm(x, p["w_v"]).view(b, sl, hkv, hd)
    q, k = rope(q, cfg["rope_theta"]), rope(k, cfg["rope_theta"])
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))         # [B, H, L, D]
    g = hq // hkv
    keep = torch.ones(sl, sl, dtype=torch.bool, device=x.device).tril()
    outs = []
    for h0 in range(0, hq, HEAD_BLOCK):
        qh = q[:, h0:h0 + HEAD_BLOCK]
        kh = k.repeat_interleave(g, 1)[:, h0:h0 + HEAD_BLOCK]
        vh = v.repeat_interleave(g, 1)[:, h0:h0 + HEAD_BLOCK]
        s = num.einsum("bhqd,bhkd->bhqk", qh, kh) / math.sqrt(hd)
        pr = torch.softmax(s.masked_fill(~keep, -math.inf), dim=-1)
        outs.append(num.einsum("bhqk,bhkd->bhqd", pr, vh))
    o = torch.cat(outs, dim=1).transpose(1, 2).reshape(b, sl, hq * hd)
    return num.mm(o, p["w_o"])


def _mlp(x, p, num):
    gate = F.gelu(num.mm(x, p["w_gate"]), approximate="tanh")
    return num.mm(gate * num.mm(x, p["w_up"]), p["w_down"])


def _layer_params(params: Dict, i: int) -> Dict:
    lp = params["layers"]
    return {"norm_attn": lp["norm_attn"]["scale"][i].float(),
            "norm_ffn": lp["norm_ffn"]["scale"][i].float(),
            **{k: lp["attn"][k][i].float() for k in lp["attn"]},
            **{k: lp[k][i].float() for k in ("w_up", "w_gate", "w_down")}}


def logits(params: Dict, tokens: torch.Tensor, cfg: Dict,
           num: Numerics = EXACT) -> torch.Tensor:
    """tokens [B, L, K] -> logits [B, L, K, V] in float32."""
    emb = params["embedding"]["tok_embed"]                      # [K, V, d]
    x = sum(num.q(emb[k].float())[tokens[..., k].long()]
            for k in range(emb.shape[0]))
    for i in range(cfg["num_layers"]):
        p = _layer_params(params, i)
        x = x + _attention(rmsnorm(x, p["norm_attn"]), p, cfg, num)
        x = x + _mlp(rmsnorm(x, p["norm_ffn"]), p, num)
    x = rmsnorm(x, params["final_norm"]["scale"].float())
    head = params["embedding"]["lm_head"].float()               # [K, d, V]
    return num.einsum("bld,kdv->blkv", x, head)


def scores(params: Dict, batch: Dict, cfg: Dict, num: Numerics = EXACT
           ) -> torch.Tensor:
    """The negative log-likelihood of every target position."""
    return nll(logits(params, batch["tokens"], cfg, num), batch["targets"])


def loss(params: Dict, batch: Dict, cfg: Dict, num: Numerics = EXACT
         ) -> torch.Tensor:
    return cross_entropy(logits(params, batch["tokens"], cfg, num),
                         batch["targets"])
