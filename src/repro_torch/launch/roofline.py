"""Roofline from one dry-run record, priced on NVIDIA H100 SXM5 80GB.

The port of the JAX package's ``launch/roofline.py`` (which prices a TPU).
Three terms per rank, each the least time one card could take for what the
dry run counted for it:

  compute    = flops          / 989e12 FLOP/s  (dense bf16 tensor cores)
  memory     = bytes_accessed / 3.35e12 B/s    (HBM3)
  collective = Σ_axis bytes_on_axis / rate(axis)

A mesh axis whose ranks all sit in one node of 8 GPUs (ranks laid out
row-major, 8 to a node) is priced at NVLink's rate; an axis that spans
more than one node at the inter-node rate.  On the production meshes every
axis spans nodes: ``model`` (16) is contiguous but twice a node, ``data``
and ``pod`` stride 16 and 256 ranks.  Collective bytes are result bytes
(the data a collective delivers per rank, up to the algorithm's factor),
as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

# NVIDIA H100 Tensor Core GPU datasheet, H100 SXM5: dense BF16 (without
# sparsity) tensor-core peak
PEAK_FLOPS = 989e12
# the same datasheet: HBM3 bandwidth of the 80 GB part
HBM_BW = 3.35e12
# the same datasheet: NVLink 4, 900 GB/s per GPU, bidirectional
NVLINK_BW = 900e9
# DGX H100 user guide: one 400 Gb/s NDR ConnectX-7 port per GPU between
# nodes, 50 GB/s
INTER_NODE_BW = 50e9
GPUS_PER_NODE = 8


def axis_rates(shape: Sequence[int], names: Sequence[str]
               ) -> Dict[str, float]:
    """{axis: bytes/s} for a row-major mesh of ``shape`` over nodes of
    ``GPUS_PER_NODE``: NVLink where an axis's group stays inside a node."""
    out, stride = {}, 1
    for n, name in reversed(list(zip(shape, names))):
        span = stride * n                      # ranks one group reaches
        inside = span <= GPUS_PER_NODE and GPUS_PER_NODE % span == 0
        out[name] = NVLINK_BW if inside or n == 1 else INTER_NODE_BW
        stride = span
    return out


def roofline_report(rec: Dict[str, Any]) -> Dict[str, Any]:
    """The three terms (seconds, one rank) of a dry-run record."""
    mesh = rec["mesh_shape"]
    rates = axis_rates(list(mesh.values()), list(mesh))
    coll = rec.get("collectives", {}).get("bytes_by_axis", {})
    slowest = min(rates.values()) if rates else INTER_NODE_BW
    t_coll = sum(b / rates.get(axis, slowest) for axis, b in coll.items())
    terms = {"compute_s": rec.get("flops", 0.0) / PEAK_FLOPS,
             "memory_s": rec.get("bytes_accessed", 0.0) / HBM_BW,
             "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    return {**terms, "dominant": dominant,
            "bound_fraction": terms[dominant] / max(sum(terms.values()),
                                                    1e-30),
            "axis_rate": rates}


def model_flops(arch_params: float, tokens: float, *, moe_active: float = 0.0
                ) -> float:
    """MODEL_FLOPS = 6·N·D (dense) or 6·N_active·D (MoE)."""
    n = moe_active if moe_active > 0 else arch_params
    return 6.0 * n * tokens
