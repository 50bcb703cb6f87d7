"""Mamba-2 (SSD — state-space duality) stack. [arXiv:2405.21060]

The port of the JAX package's ``models/ssm.py``.  Training and prefill use
the chunked SSD algorithm (chunk-local quadratic term + inter-chunk linear
state recurrence); decode is the O(1)-per-token recurrent step.

Params keep the reference's names and its stacked leading layer axis
(``params["layers"][name]`` is ``[num_layers, ...]``), so the JAX package's
params carried over as numpy (``utils.tree.from_numpy_tree``) are the
port's params.  A Python loop walks the layer axis where the reference
scans it.  The training forward writes nothing in place, so
``torch.func.grad``, ``jvp`` and ``vmap`` run through it.  ``cfg.remat``
checkpoints each layer of the training forward (``layers.remat``), as the
reference does; it changes memory, not results, and steps aside inside a
``torch.func`` transform.

With ``cfg.attn_impl == "pallas"``, ``forward``/``loss``/``predict`` run the
chunked scan through the SSD kernel (``kernels/ssd_scan.ssd_chunked``, one
launch per layer); ``prefill`` and ``decode_step`` stay on the model's own
scan, as in the reference.  ``"xla"`` (the default, and the reference's only
path) computes what the reference's ``ssm.py`` computes.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch import sharding
from repro_torch.config import ModelConfig
from repro_torch.models import layers as L
from repro_torch.utils.tree import tree_map

Params = Dict[str, Any]


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = s.num_heads or d_inner // s.head_dim
    return d_inner, nheads, s.head_dim, s.state_dim


def segsum(x: torch.Tensor) -> torch.Tensor:
    """Stable 'segment sum': out[..., i, j] = sum_{j < m <= i} x[..., m].

    Returns -inf above the diagonal (used as log-decay matrix L).
    """
    t = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, -math.inf)


def _scan_shards(scan, x, dt, a, b, c, chunk):
    """``scan`` on DTensors, each rank on its own batch rows and heads
    (``sharding.map_local``): the scan is independent per (batch row,
    head).  b and c are shared across heads and ``a`` across batch rows,
    so their gradients sum over the ranks that split the other dim."""
    from torch.distributed.tensor import Partial
    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    m = mesh.shape[names.index("model")] if "model" in names else 1
    batch = tuple(n for n in ("pod", "data") if n in names) or None
    heads = "model" if m > 1 and x.shape[2] % m == 0 else None

    def pl(*spec):
        return sharding.spec_placements(spec, mesh)

    def summed(placements, axes):
        return tuple(Partial() if n in axes and p.is_replicate() else p
                     for n, p in zip(names, placements))

    xp, dtp, ap, bcp = (pl(batch, None, heads, None), pl(batch, None, heads),
                        pl(heads), pl(batch, None, None))
    return sharding.map_local(
        lambda *t: scan(*t, chunk), (x, dt, a, b, c),
        (xp, dtp, ap, bcp, bcp), (xp, pl(batch, heads, None, None)),
        (xp, dtp, summed(ap, batch or ()), summed(bcp, (heads,)),
         summed(bcp, (heads,))))


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None,
                chunk_fn: Optional[Callable] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x  [B, L, H, P]   inputs (per-head channels)
    dt [B, L, H]      positive step sizes
    a  [H]            negative per-head decay rates
    b  [B, L, N]      input projections (shared across heads, G=1)
    c  [B, L, N]      output projections
    Returns (y [B, L, H, P], final_state [B, H, P, N]).

    ``chunk_fn`` (``kernels/ssd_scan.ssd_chunk``'s signature) replaces the
    chunk-local terms (steps 1-2 and the decays); it is given f32,
    contiguous inputs and the rest of the scan then runs in f32.
    """
    bs, sl, h, p = x.shape
    n = b.shape[-1]
    l_orig = sl
    if sl % chunk:
        # zero-pad to a chunk multiple: dt=0 at pads ⇒ decay 1, update 0 —
        # the state is provably unaffected by padding positions
        pad = chunk - sl % chunk
        x, dt, b, c = (L.pad_seq(t, 0, pad) for t in (x, dt, b, c))
        sl = sl + pad
    nc = sl // chunk

    xr = x.reshape(bs, nc, chunk, h, p)
    dtr = dt.reshape(bs, nc, chunk, h)
    br = b.reshape(bs, nc, chunk, n)
    cr = c.reshape(bs, nc, chunk, n)
    if chunk_fn is not None:
        xr, dtr, a, br, cr = (t.float().contiguous()
                              for t in (xr, dtr, a, br, cr))
        y_intra, states, chunk_decay, in_decay = chunk_fn(xr, dtr, a, br, cr)
    else:
        da = (dtr * a).movedim(-1, -2)                               # [B,NC,H,Q]

        # 1) intra-chunk (quadratic within the chunk)
        lmat = torch.exp(segsum(da))                                 # [B,NC,H,Q,Q]
        scores = torch.einsum("bzin,bzjn->bzij", cr, br)             # [B,NC,Q,Q]
        xdt = xr * dtr[..., None]                                    # x * dt
        y_intra = torch.einsum("bzhij,bzjhp->bzihp",
                               scores[:, :, None] * lmat, xdt)

        # 2) chunk summaries: decay from step j to end of chunk
        cum = torch.cumsum(da, dim=-1)                               # [B,NC,H,Q]
        decay_end = torch.exp(cum[..., -1:] - cum)                   # [B,NC,H,Q]
        states = torch.einsum("bzjn,bzjhp->bzhpn", br,
                              xdt * decay_end.movedim(-1, -2)[..., None])
        chunk_decay = torch.exp(cum[..., -1])                        # [B,NC,H]
        in_decay = torch.exp(cum)                    # decay from chunk start

    # 3) inter-chunk recurrence over chunk states (f32, as the reference)
    chunk_decay = chunk_decay.float()
    s = (initial_state.float() if initial_state is not None
         else torch.zeros((bs, h, p, n), dtype=torch.float32,
                          device=x.device))
    prevs = []
    for z in range(nc):
        prevs.append(s)
        s = s * chunk_decay[:, z, :, None, None] + states[:, z].float()
    s_prevs = torch.stack(prevs, dim=1)                              # [B,NC,H,P,N]

    # 4) contribution of previous-chunk state to each position
    y_inter = torch.einsum("bzin,bzhpn->bzihp", cr, s_prevs.to(cr.dtype)) \
        * in_decay.movedim(-1, -2)[..., None]

    y = (y_intra + y_inter).reshape(bs, sl, h, p)[:, :l_orig]
    return y.to(x.dtype), s.to(x.dtype)


def ssd_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
             a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single recurrent step. state [B,H,P,N]; x [B,H,P]; dt [B,H]; b,c [B,N]."""
    da = torch.exp(dt * a)                                           # [B,H]
    upd = torch.einsum("bhp,bn->bhpn", x * dt[..., None], b)
    state = state * da[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", state, c)
    return state, y


class Mamba2LM:
    """Language model over integer tokens.

    Public API (as in the reference):
      init(gen) -> params
      loss(params, batch, rng) -> (scalar_loss, metrics)
      forward(params, tokens) -> (logits, None, aux)
      prefill(params, tokens, cache_len) -> (logits_last, cache)
      decode_step(params, cache, tokens, pos) -> (logits, cache)
    """

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

    # ------------------------------------------------------------- init ---
    def init(self, gen: Optional[torch.Generator], *, device=None) -> Params:
        """Random params drawn from ``gen`` on ``gen``'s device, or on
        ``device``, or else on the card; ``device="meta"`` gives shapes and
        dtypes only."""
        cfg = self.cfg
        if device is None:
            device = gen.device if gen is not None else "cuda"
        d_inner, h, p, n = _dims(cfg)
        dt = L._dt(cfg)
        conv_dim = d_inner + 2 * n
        w = cfg.ssm.conv_width
        lead = (cfg.num_layers,)
        proj_out = 2 * d_inner + 2 * n + h                         # z, x, B, C, dt
        f32 = dict(dtype=torch.float32, device=device)
        kw = dict(device=device, lead=lead)
        conv_w = torch.empty(lead + (w, conv_dim), dtype=dt, device=device)
        a_log = torch.log(torch.linspace(1.0, 16.0, h, **f32))
        layer = {
            "norm_attn": L.rmsnorm_init(cfg.d_model, dt, **kw),
            "in_proj": L.dense_init(gen, cfg.d_model, proj_out, dt, **kw),
            "conv_w": conv_w,
            "conv_b": torch.zeros(lead + (conv_dim,), dtype=dt, device=device),
            "A_log": a_log.expand(lead + (h,)).clone(),
            "dt_bias": torch.zeros(lead + (h,), **f32),
            "D_skip": torch.ones(lead + (h,), **f32),
            "norm_gate": L.rmsnorm_init(d_inner, dt, **kw),
            "out_proj": L.dense_init(gen, d_inner, cfg.d_model, dt,
                                     scale=1.0 / math.sqrt(
                                         d_inner * cfg.num_layers), **kw),
        }
        if conv_w.device.type != "meta":
            for i in range(cfg.num_layers):
                conv_w[i] = (L.normal(gen, (w, conv_dim), device)
                             / math.sqrt(w)).to(dt)
        return {
            "embedding": L.embedding_init(gen, cfg, device=device),
            "final_norm": L.rmsnorm_init(cfg.d_model, dt, device=device),
            "layers": layer,
        }

    # -------------------------------------------------------- internals ---
    def _split_proj(self, zxbcdt: torch.Tensor):
        d_inner, h, p, n = _dims(self.cfg)
        z = zxbcdt[..., :d_inner]
        xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * n]
        dt_raw = zxbcdt[..., 2 * d_inner + 2 * n:]
        return z, xbc, dt_raw

    def ssd_inputs(self, pl: Params, x: torch.Tensor):
        """One layer's input to the scan: x [B, L, d] → (z, xbc before the
        conv, xs [B,L,H,P], dt [B,L,H] f32, a [H] f32, b [B,L,N], c
        [B,L,N]); xs, b and c in the model's dtype."""
        cfg = self.cfg
        d_inner, h, p, n = _dims(cfg)
        bsz, lq = x.shape[:2]
        xn = L.rmsnorm(pl["norm_attn"], x)
        z, xbc, dt_raw = self._split_proj(xn @ pl["in_proj"])
        # causal depthwise conv (width W): pad left
        w = cfg.ssm.conv_width
        pad = L.pad_seq(xbc, w - 1)
        conv = sum(pad[:, i:i + lq, :] * pl["conv_w"][i][None, None, :]
                   for i in range(w)) + pl["conv_b"]
        u = F.silu(conv)
        xs = u[..., :d_inner].reshape(bsz, lq, h, p)
        b = u[..., d_inner:d_inner + n]
        c = u[..., d_inner + n:]
        dt = L.softplus(dt_raw.float() + pl["dt_bias"])
        a = -torch.exp(pl["A_log"])
        return z, pad, xs, dt, a, b, c

    def layer(self, pl: Params, x: torch.Tensor, scan
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Full-sequence SSD mixing for one layer through ``scan`` (a
        chunked scan with ``ssd_chunked``'s signature) → (out, conv tail,
        final state)."""
        cfg = self.cfg
        d_inner = _dims(cfg)[0]
        bsz, lq = x.shape[:2]
        z, pad, xs, dt, a, b, c = self.ssd_inputs(pl, x)
        w = cfg.ssm.conv_width
        conv_tail = pad[:, pad.shape[1] - (w - 1):, :]
        xf = xs.float()
        if isinstance(xf, DTensor):
            scan = functools.partial(_scan_shards, scan)
        y, s_final = scan(xf, dt, a, b.float(), c.float(),
                          cfg.ssm.chunk_size)
        y = y + pl["D_skip"][None, None, :, None] * xf
        y = y.reshape(bsz, lq, d_inner).to(x.dtype)
        y = L.rmsnorm(pl["norm_gate"], y * F.silu(z))
        return x + y @ pl["out_proj"], conv_tail, s_final

    def _scan(self):
        if self.cfg.attn_impl == "pallas":
            from repro_torch.kernels import ssd_scan
            return ssd_scan.ssd_chunked
        return ssd_chunked

    # --------------------------------------------------------- forward ----
    def forward(self, params: Params, tokens: torch.Tensor, **_kw):
        cfg = self.cfg
        scan = self._scan()
        x = sharding.constrain(L.embed(params["embedding"], tokens), "batch",
                               None, None)
        layer = L.remat(lambda lp, xi: self.layer(lp, xi, scan)[0],
                        cfg.remat)
        for i in range(cfg.num_layers):
            lp = tree_map(lambda t: t[i], params["layers"])
            x = layer(lp, x)
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
    def init_cache(self, batch: int, cache_len: int = 0, *, device="cuda"
                   ) -> Params:
        """Recurrent cache: conv tail + SSM state per layer (cache_len unused
        — state is O(1) in sequence length)."""
        cfg = self.cfg
        d_inner, h, p, n = _dims(cfg)
        conv_dim = d_inner + 2 * n
        dt = L._dt(cfg)
        return {
            "conv": torch.zeros((cfg.num_layers, batch,
                                 cfg.ssm.conv_width - 1, conv_dim),
                                dtype=dt, device=device),
            "state": torch.zeros((cfg.num_layers, batch, h, p, n), dtype=dt,
                                 device=device),
        }

    def _layer_step(self, pl: Params, lc: Params, x: torch.Tensor
                    ) -> Tuple[torch.Tensor, Params]:
        cfg = self.cfg
        d_inner, h, p, n = _dims(cfg)
        resid = x
        xn = L.rmsnorm(pl["norm_attn"], x)                           # [B,1,d]
        z, xbc, dt_raw = self._split_proj(xn @ pl["in_proj"])
        xbc1 = xbc[:, 0, :]                                          # [B,convdim]
        hist = torch.cat([lc["conv"], xbc1[:, None, :]], dim=1)
        conv = torch.einsum("bwc,wc->bc", hist, pl["conv_w"]) + pl["conv_b"]
        new_conv = hist[:, 1:, :]
        u = F.silu(conv)
        xs = u[:, :d_inner].reshape(-1, h, p)
        b = u[:, d_inner:d_inner + n]
        c = u[:, d_inner + n:]
        dt = L.softplus(dt_raw[:, 0, :].float() + pl["dt_bias"])
        a = -torch.exp(pl["A_log"])
        state, y = ssd_step(lc["state"].float(), xs.float(), dt, a,
                            b.float(), c.float())
        y = y + pl["D_skip"][None, :, None] * xs.float()
        y = y.reshape(-1, 1, d_inner).to(x.dtype)
        y = L.rmsnorm(pl["norm_gate"], y * F.silu(z))
        out = resid + y @ pl["out_proj"]
        return out, {"conv": new_conv.to(lc["conv"].dtype),
                     "state": state.to(lc["state"].dtype)}

    def prefill(self, params: Params, tokens: torch.Tensor,
                cache_len: int = 0, **_kw) -> Tuple[torch.Tensor, Params]:
        """Prefill = full SSD pass (the model's own scan) that also
        materialises the recurrent cache, in the model's dtype."""
        cfg = self.cfg
        x = L.embed(params["embedding"], tokens)
        convs, states = [], []
        for i in range(cfg.num_layers):
            lp = tree_map(lambda t: t[i], params["layers"])
            x, tail, s_final = self.layer(lp, x, ssd_chunked)
            convs.append(tail.to(x.dtype))
            states.append(s_final.to(x.dtype))
        x = L.rmsnorm(params["final_norm"], x)
        logits = L.unembed(params["embedding"], x[:, -1:])
        return logits, {"conv": torch.stack(convs),
                        "state": torch.stack(states)}

    def decode_step(self, params: Params, cache: Params, tokens: torch.Tensor,
                    pos=None, **_kw) -> Tuple[torch.Tensor, Params]:
        """tokens [B, 1]; ``pos`` is unused (the state carries position)."""
        cfg = self.cfg
        x = L.embed(params["embedding"], tokens)                     # [B,1,d]
        convs, states = [], []
        for i in range(cfg.num_layers):
            lp = tree_map(lambda t: t[i], params["layers"])
            lc = {"conv": cache["conv"][i], "state": cache["state"][i]}
            x, new_lc = self._layer_step(lp, lc, x)
            convs.append(new_lc["conv"])
            states.append(new_lc["state"])
        x = L.rmsnorm(params["final_norm"], x)
        logits = L.unembed(params["embedding"], x)
        return logits, {"conv": torch.stack(convs),
                        "state": torch.stack(states)}
