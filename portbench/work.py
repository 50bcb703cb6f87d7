"""The yardstick's arithmetic: the H100's published peaks and the work a
cell's shapes need, counted from the configuration alone.

Counting rules (whatever implements the work, the count is the same):

* operations are counted once, as the mathematics needs them: a 3xTF32
  product is one product, and a layer recomputed for memory (remat) is
  not counted again;
* bytes count each input as the caller holds it, read once, and each
  output written once;
* both are priced at the published dense peaks of one H100 SXM (bf16
  989 TFLOP/s, TF32 495 TFLOP/s for f32 work on the tensor cores, HBM3
  3.35 TB/s), and the least time is the larger of the two.

The peaks and the flash, SSD and roofline formulas are a frozen copy of
``chip_smoke.py``'s (``H100_*``, ``_bound``, ``_flash_pairs``,
``ssd_work``), changed where that file priced a kernel's own route
(three TF32 products for one f32 product) rather than the mathematics.
"""
from __future__ import annotations

from typing import Dict, Tuple

H100_BYTES_PER_S = 3.35e12          # HBM3
H100_TF32_FLOPS = 495e12            # f32 work on the tensor cores (TF32)
H100_BF16_FLOPS = 989e12            # bf16 tensor cores, dense


def least_seconds(nbytes: float, ops: float, peak_flops: float) -> float:
    """The least time the card could take: bytes over bandwidth or
    operations over the peak, the larger."""
    return max(nbytes / H100_BYTES_PER_S, ops / peak_flops)


def kept_pairs(sl: int, causal: bool = True, window: int = 0) -> int:
    """(q, k) pairs an [sl, sl] attention mask keeps."""
    total = 0
    for q in range(sl):
        lo = max(0, q - window + 1) if window else 0
        hi = q if causal else sl - 1
        total += hi - lo + 1
    return total


def _dtype_bytes(name: str) -> int:
    return {"bfloat16": 2, "float16": 2, "float32": 4}[name]


# ---------------------------------------------------------------------------
# transformer (the audio family: K codebook embeddings and heads)
# ---------------------------------------------------------------------------

def transformer_matrix_params(cfg: Dict) -> Tuple[int, int]:
    """(matrix params a layer, matrix params of the output heads): the
    weights a forward multiplies by; embeddings are looked up, not
    multiplied."""
    d, hd = cfg["d_model"], cfg["d_model"] // cfg["num_heads"]
    hq, hkv, f = cfg["num_heads"], cfg["num_kv_heads"], cfg["d_ff"]
    gated = cfg["activation"] in ("silu", "gelu")
    layer = d * hq * hd + 2 * d * hkv * hd + hq * hd * d \
        + (3 if gated else 2) * d * f
    heads = max(cfg.get("num_audio_codebooks", 0), 1) * d \
        * cfg["vocab_size"]
    return layer, heads


def transformer_forward_flops(cfg: Dict, batch: int, seq: int) -> int:
    """One forward over [batch, seq] positions: 2 x matrix params x
    positions, plus attention's 4 x D for each kept (b, h, q, k)."""
    layer, heads = transformer_matrix_params(cfg)
    hd = cfg["d_model"] // cfg["num_heads"]
    pos = batch * seq
    attn = 4 * hd * batch * cfg["num_heads"] * kept_pairs(seq)
    return 2 * (cfg["num_layers"] * layer + heads) * pos \
        + cfg["num_layers"] * attn


def flash_launch_bound_s(cfg: Dict, batch: int, seq: int) -> float:
    """One flash launch (one layer): kept pairs x 4 x D at the bf16 peak,
    against q, k, v read and o written in the model's dtype."""
    hd = cfg["d_model"] // cfg["num_heads"]
    hq, hkv = cfg["num_heads"], cfg["num_kv_heads"]
    ops = 4 * hd * batch * hq * kept_pairs(seq)
    nbytes = _dtype_bytes(cfg["dtype"]) * batch * seq * (2 * hq + 2 * hkv) \
        * hd
    return least_seconds(nbytes, ops, H100_BF16_FLOPS)


# ---------------------------------------------------------------------------
# Mamba-2
# ---------------------------------------------------------------------------

def _ssm_dims(cfg: Dict) -> Tuple[int, int, int, int]:
    s = cfg["ssm"]
    d_inner = s["expand"] * cfg["d_model"]
    heads = s.get("num_heads") or d_inner // s["head_dim"]
    return d_inner, heads, s["head_dim"], s["state_dim"]


def ssd_chunk_work(batch: int, n_chunks: int, q: int, h: int, p: int,
                   n: int) -> Tuple[int, int, int]:
    """(bytes, operations over the (i, j <= i) pairs, of them the
    products) of one SSD chunk call, its inputs and outputs in f32 as the
    scan holds them."""
    bz = batch * n_chunks
    nbytes = 4 * (2 * bz * q * h * p + bz * q * h + h + 2 * bz * q * n
                  + bz * h * p * n + bz * h + bz * h * q)
    pairs = q * (q + 1) // 2
    products = 2 * n * pairs + 2 * h * p * pairs + 2 * h * p * n * q
    weights = 3 * h * pairs
    return nbytes, bz * (products + weights), bz * products


def mamba2_matrix_params(cfg: Dict) -> Tuple[int, int]:
    d = cfg["d_model"]
    d_inner, h, _, n = _ssm_dims(cfg)
    layer = d * (2 * d_inner + 2 * n + h) + d_inner * d
    return layer, d * cfg["vocab_size"]


def mamba2_forward_flops(cfg: Dict, batch: int, seq: int) -> int:
    """One forward: 2 x matrix params x positions, plus each layer's scan:
    the chunk-local work over (i, j <= i) and each position's read of
    the carried state (2 x H x P x N)."""
    layer, head = mamba2_matrix_params(cfg)
    _, h, p, n = _ssm_dims(cfg)
    q = cfg["ssm"]["chunk_size"]
    chunks = -(-seq // q)
    _, ops, _ = ssd_chunk_work(batch, chunks, q, h, p, n)
    scan = ops + 2 * h * p * n * batch * seq
    return 2 * (cfg["num_layers"] * layer + head) * batch * seq \
        + cfg["num_layers"] * scan


def ssd_launch_bound_s(cfg: Dict, batch: int, seq: int) -> float:
    """One SSD chunk launch (one layer): its j <= i products once at the
    TF32 peak, against its bytes."""
    _, h, p, n = _ssm_dims(cfg)
    q = cfg["ssm"]["chunk_size"]
    nbytes, _, products = ssd_chunk_work(batch, -(-seq // q), q, h, p, n)
    return least_seconds(nbytes, products, H100_TF32_FLOPS)


# ---------------------------------------------------------------------------
# the families behind one name
# ---------------------------------------------------------------------------

def forward_flops(cfg: Dict, batch: int, seq: int) -> int:
    if cfg["family"] == "ssm":
        return mamba2_forward_flops(cfg, batch, seq)
    return transformer_forward_flops(cfg, batch, seq)
