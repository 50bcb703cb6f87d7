"""Plain torch oracles for every kernel (the ground truth in tests).

The port of the JAX package's ``kernels/ref.py``: the same five functions
with the same signatures, on tensors.  Where a kernel module's plain
version computes the same function it is called; each kernel's plain
version keeps its own kernel's layout and order of operations, so only
these two are one and the same:

* ``attention_ref`` is ``flash_attention.attention_plain``;
* ``decode_attention_ref`` is ``decode_attention.decode_attention_plain``.

The other three keep the reference's own math, which the kernels' plain
versions do not share: ``ssd_chunk_ref`` is the naive recurrence over one
chunk (``ssd_scan.ssd_chunk_plain`` is the chunked quadratic form over
[B, NC, Q, ...]); ``adam_ref`` takes ``t`` as an int and rounds nothing
(``fused_adam.fused_adam_plain`` takes a device tensor of [lr, bc1, bc2]);
``stale_aggregate_ref`` works on one tensor of any shape
(``stale_aggregate.stale_aggregate_plain`` on flat [N] and [C, N]).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import attention_plain

__all__ = ["adam_ref", "attention_ref", "decode_attention_ref",
           "ssd_chunk_ref", "stale_aggregate_ref"]

attention_ref = attention_plain
decode_attention_ref = decode_attention_plain


def ssd_chunk_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor, c: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-chunk SSD reference (naive recurrence).

    x [B,Q,H,P], dt [B,Q,H], a [H], b/c [B,Q,N] →
      (y_intra [B,Q,H,P]  — zero initial state,
       state   [B,H,P,N]  — end-of-chunk state,
       decay   [B,H]      — total chunk decay)
    """
    bs, qlen, h, p = x.shape
    n = b.shape[-1]
    da = dt * a[None, None, :]                                  # [B,Q,H]
    s = torch.zeros((bs, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(qlen):
        upd = torch.einsum("bhp,bn->bhpn", x[:, t] * dt[:, t][..., None],
                           b[:, t])
        s = s * torch.exp(da[:, t])[..., None, None] + upd
        ys.append(torch.einsum("bhpn,bn->bhp", s, c[:, t]))
    return torch.stack(ys, dim=1), s, torch.exp(da.sum(dim=1))


def adam_ref(p, m, v, g, *, lr: float, b1: float, b2: float, eps: float,
             t: int):
    """Single-tensor Adam reference."""
    m2 = b1 * m + (1 - b1) * g
    v2 = b2 * v + (1 - b2) * g * g
    mh = m2 / (1 - b1 ** t)
    vh = v2 / (1 - b2 ** t)
    return p - lr * mh / (torch.sqrt(vh) + eps), m2, v2


def stale_aggregate_ref(params, buffers, mask, *, beta: float):
    """Eq. (8): w − (β/A)·Σ_c mask_c · buf_c for one tensor.

    params [D...], buffers [C, D...], mask [C]."""
    a = torch.clamp(mask.sum(), min=1.0)
    agg = torch.einsum("c...,c->...", buffers.to(torch.float32), mask)
    return (params.to(torch.float32) - (beta / a) * agg).to(params.dtype)
