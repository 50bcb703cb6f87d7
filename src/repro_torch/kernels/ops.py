"""Public wrappers around the kernels.

The port of the JAX package's ``kernels/ops.py``, with its ``__all__``.
Each wrapper's route follows its tensors' device: a CUDA tensor launches
the hand-written kernel (or raises), a CPU tensor takes the kernel's plain
version.  Tests compare each against the oracles in ``ref.py``.

``ref``, ``stale_aggregate_flat``, ``stale_aggregate_tree`` and
``masked_aggregate_tree`` are passthroughs, as in the reference.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import fused_adam, ref, ssd_scan
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.stale_aggregate import (masked_aggregate_tree,
                                                 stale_aggregate_flat,
                                                 stale_aggregate_tree)
from repro_torch.utils.tree import tree_map

__all__ = [
    "INTERPRET",
    "flash_attention",
    "fused_adam_tree",
    "masked_aggregate_tree",
    "ref",
    "ssd_chunked",
    "stale_aggregate_flat",
    "stale_aggregate_tree",
]

# The reference's Pallas interpret switch, kept for its name.  It means
# nothing here: the route follows the tensor's device (kernel on CUDA,
# plain version on the CPU), and the ``interpret`` arguments below are
# accepted and ignored.
INTERPRET = True


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor, chunk: int, *,
                interpret: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel-backed drop-in for ``models.ssm.ssd_chunked``.

    x [B,L,H,P], dt [B,L,H], a [H], b/c [B,L,N] → (y [B,L,H,P],
    final_state [B,H,P,N]), both in x's dtype.  L must be a multiple of
    ``chunk``, as in the reference."""
    if x.shape[1] % chunk:
        raise ValueError(f"ssd_chunked: L {x.shape[1]} is not a multiple of "
                         f"the chunk {chunk}")
    return ssd_scan.ssd_chunked(x, dt, a, b, c, chunk)


def fused_adam_tree(params, m, v, grads, *, lr, t, b1=0.9, b2=0.95,
                    eps=1e-8, interpret: bool = True):
    """Tree fused Adam, the kernel leaf by leaf, with g cast to f32 first
    as the reference does (``kernels.fused_adam.fused_adam_tree`` reads g
    in its own dtype)."""
    return fused_adam.fused_adam_tree(
        params, m, v, tree_map(lambda g: g.to(torch.float32), grads),
        lr=lr, t=t, b1=b1, b2=b2, eps=eps)
