"""Weights drawn from a seed on the device, one call a leaf (the port
stacks its layers, so a model is a dozen leaves), in the dtype they are
served in.

The distribution follows the port's own ``init`` by leaf name (matrices
N(0, 1/fan_in), output projections scaled down by depth, embeddings
0.02, norms 1, biases 0, Mamba-2's decay rates from 1 to 16), but for
Mamba-2's ``dt_bias``, drawn as the published Mamba-2 initialisation
draws it (the inverse softplus of dt, log-uniform on [1e-3, 1e-1]): with
the port's 0 (dt ~ 0.7) the bfloat16 model at random weights is chaotic
end to end, and no comparison of its scores can tell the program from a
reference in a lower precision.  The values are the benchmark's, so the
program and the reference are handed the same tensors.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

# leaves that are not drawn: name -> constant
_ONES = ("scale", "D_skip")
_ZEROS = ("bias_ln", "conv_b", "gate_cross")
DT_RANGE = (1e-3, 1e-1)


def _scale(name: str, shape, cfg: Dict) -> float:
    fan_in = shape[-2]
    layers = cfg["num_layers"]
    if name == "tok_embed":
        return 0.02
    if name in ("w_o", "w_down"):
        return 1.0 / math.sqrt(fan_in * 2 * layers)
    if name == "out_proj":
        return 1.0 / math.sqrt(fan_in * layers)
    return 1.0 / math.sqrt(fan_in)


def make_params(layout: Any, cfg: Dict, seed: int, device) -> Any:
    """A params tree shaped like ``layout`` (a tree of tensors on the meta
    device, as the program's ``init(None, device="meta")`` gives them),
    its draws from one generator seeded by ``seed``, leaves in sorted-key
    order."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def fill(tree, name=""):
        if isinstance(tree, dict):
            out = {k: None for k in tree}
            for k in sorted(tree):
                out[k] = fill(tree[k], k)
            return out
        shape, dtype = tuple(tree.shape), tree.dtype
        if name in _ONES:
            return torch.ones(shape, dtype=dtype, device=device)
        if name in _ZEROS:
            return torch.zeros(shape, dtype=dtype, device=device)
        if name == "dt_bias":
            lo, hi = math.log(DT_RANGE[0]), math.log(DT_RANGE[1])
            dt = torch.exp(torch.rand(shape, generator=gen, device=device)
                           * (hi - lo) + lo)
            return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
        if name == "A_log":
            h = shape[-1]
            row = torch.log(torch.linspace(1.0, 16.0, h, device=device))
            return row.expand(shape).to(dtype).clone()
        x = torch.randn(shape, generator=gen, dtype=dtype, device=device)
        return x.mul_(_scale(name, shape, cfg))

    return fill(layout)
