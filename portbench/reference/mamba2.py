"""Plain reference of Mamba-2 (SSD) as the configuration runs it: each
layer RMSNorm, the input projection into (z, x, B, C, dt), a causal
depthwise convolution and SiLU over (x, B, C), the selective state-space
scan (one group: B and C shared by every head) with the skip D, the
output gated by SiLU(z) and RMS-normed, the output projection into the
residual; a final RMSNorm and the output head (the embedding's
transpose where the head is tied to it).  The scan is the chunked
form of the SSD paper (arXiv:2405.21060, its minimal listing): within a
chunk the quadratic form, between chunks the carried state.  Float32
throughout, params read as float32 a layer at a time."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from portbench.reference.common import (EXACT, Numerics, cross_entropy, nll,
                                        rmsnorm)


def ssd_scan(x, dt, a, b, c, chunk: int, num: Numerics = EXACT):
    """y_t = C_t . h_t with h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t^T.
    x [B, L, H, P], dt [B, L, H], a [H], b and c [B, L, N] -> y like x."""
    bs, sl, h, p = x.shape
    n = b.shape[-1]
    pad = (-sl) % chunk
    if pad:
        x, dt, b, c = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
                       for t in (x, dt, b, c))
    nc = x.shape[1] // chunk
    x = x.reshape(bs, nc, chunk, h, p)
    dt = dt.reshape(bs, nc, chunk, h)
    b = b.reshape(bs, nc, chunk, n)
    c = c.reshape(bs, nc, chunk, n)
    cum = torch.cumsum(dt * a, dim=2)                        # [B, Z, Q, H]
    keep = torch.ones(chunk, chunk, dtype=torch.bool,
                      device=x.device).tril()
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # [B,Z,i,j,H]
    decay = torch.exp(seg.masked_fill(~keep[..., None], -torch.inf))
    xdt = x * dt[..., None]
    scores = num.einsum("bzin,bzjn->bzij", c, b)
    y = num.einsum("bzijh,bzjhp->bzihp", scores[..., None] * decay, xdt)
    # each chunk's state, from its own inputs
    to_end = torch.exp(cum[:, :, -1:, :] - cum)              # [B, Z, Q, H]
    states = num.einsum("bzjn,bzjhp->bzhpn", b, xdt * to_end[..., None])
    carried, s = [], torch.zeros(bs, h, p, n, device=x.device)
    for z in range(nc):
        carried.append(s)
        s = s * torch.exp(cum[:, z, -1, :])[..., None, None] + states[:, z]
    carried = torch.stack(carried, dim=1)                    # [B,Z,H,P,N]
    y = y + num.einsum("bzin,bzhpn->bzihp", c, carried) \
        * torch.exp(cum)[..., None]
    return y.reshape(bs, nc * chunk, h, p)[:, :sl]


def _layer(x, p, cfg, num):
    s = cfg["ssm"]
    d_inner = s["expand"] * cfg["d_model"]
    hp, n, w = s["head_dim"], s["state_dim"], s["conv_width"]
    h = d_inner // hp
    bs, sl, _ = x.shape
    zxbcdt = num.mm(rmsnorm(x, p["norm_attn"]), p["in_proj"])
    z = zxbcdt[..., :d_inner]
    xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * n]
    dt_raw = zxbcdt[..., 2 * d_inner + 2 * n:]
    padded = F.pad(xbc, (0, 0, w - 1, 0))
    conv = sum(padded[:, i:i + sl] * p["conv_w"][i] for i in range(w)) \
        + p["conv_b"]
    u = F.silu(conv)
    xs = u[..., :d_inner].reshape(bs, sl, h, hp)
    b, c = u[..., d_inner:d_inner + n], u[..., d_inner + n:]
    dt = F.softplus(dt_raw + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    y = ssd_scan(xs, dt, a, b, c, s["chunk_size"], num) \
        + p["D_skip"][:, None] * xs
    y = rmsnorm(y.reshape(bs, sl, d_inner) * F.silu(z), p["norm_gate"])
    return x + num.mm(y, p["out_proj"])


def _layer_params(params: Dict, i: int) -> Dict:
    lp = params["layers"]
    out = {k: lp[k][i].float() for k in lp
           if not isinstance(lp[k], dict)}
    out["norm_attn"] = lp["norm_attn"]["scale"][i].float()
    out["norm_gate"] = lp["norm_gate"]["scale"][i].float()
    return out


def logits(params: Dict, tokens: torch.Tensor, cfg: Dict,
           num: Numerics = EXACT) -> torch.Tensor:
    """tokens [B, L] -> logits [B, L, V] in float32."""
    x = num.q(params["embedding"]["tok_embed"].float())[tokens.long()]
    for i in range(cfg["num_layers"]):
        x = _layer(x, _layer_params(params, i), cfg, num)
    x = rmsnorm(x, params["final_norm"]["scale"].float())
    emb = params["embedding"]
    head = emb["lm_head"] if "lm_head" in emb else emb["tok_embed"].T
    return num.mm(x, head.float())


def scores(params: Dict, batch: Dict, cfg: Dict, num: Numerics = EXACT
           ) -> torch.Tensor:
    """The negative log-likelihood of every target position."""
    return nll(logits(params, batch["tokens"], cfg, num), batch["targets"])


def loss(params: Dict, batch: Dict, cfg: Dict, num: Numerics = EXACT
         ) -> torch.Tensor:
    return cross_entropy(logits(params, batch["tokens"], cfg, num),
                         batch["targets"])
