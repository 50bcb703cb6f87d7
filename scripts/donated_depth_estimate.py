#!/usr/bin/env python3
"""How deep each family of ``chip_smoke.ZOO_TRAIN`` would train on one
card with donated rounds, by arithmetic from the peaks a ``chip_smoke.py``
run printed.  Nothing here runs a round: the depths it prints are
estimates, not measurements.

    PYTHONPATH=src python3 scripts/donated_depth_estimate.py SMOKE_LOG \\
        [--limit-gib 70]

For each ``[train zoo]`` line of the log (a family at its cut L0: params,
cohorts C, the server route, the phase's peak M(L0) in GiB, undonated
rounds) it takes

* S(L), the state an undonated round holds twice (the caller's and the
  new one): the params' bytes times (1 + C) (params and the C buffer
  rows, in the params' dtypes), plus 8 B a param of Adam moments where
  the phase runs the server Adam;
* M_d(L0) = M(L0) - S(L0), the phase's peak with the second state gone.
  It is a lower bound on the saving: mamba2's server-Adam round saved
  more than its state (the undonated refresh also holds the stacked
  buffer rows), and a phase whose peak is a temporary that donation does
  not touch (the f32 flatten of the buffers, the activations) saves
  less, which the log's ``[donate]`` lines show for the family they ran;
* M_d(L) = M_d(L0) · B(L) / B(L0), B the params' bytes at depth L (the
  model built on ``meta``): the peak taken to scale with the params,
  embedding included, as the state and the remat'd layer inputs do.

It prints, for each family, M(L0), S(L0), M_d(L0) and the deepest L whose
M_d(L) stays under ``--limit-gib`` (70 GiB by default: 69.7 GiB ran alone
in one phase on the card and 74.5 GiB allocated ran out of memory in the
whole script, PR 23), with that depth's params.  No card is needed.
"""
from __future__ import annotations

import argparse
import dataclasses
import re
import sys

LINE = re.compile(
    r"\[train zoo\] (?P<name>\S+), (?P<layers>\d+) layers \(full width\), "
    r"(?P<params>[\d,]+) params .*?, (?P<c>\d+) cohorts, .*?: "
    r"(?P<route>server Adam|clipped β-SGD) rounds .*?; peak memory "
    r"(?P<peak>[\d.]+) GiB")
ARCH = {"recurrentgemma-2b": "recurrentgemma_2b",
        "llama-3.2-vision-11b": "llama32_vision_11b",
        "musicgen-large": "musicgen_large",
        "mixtral-8x22b": "mixtral_8x22b"}
GIB = 2.0 ** 30


def params_bytes(arch, layers):
    """(params, bytes) of ``arch`` at ``layers`` layers, built on meta."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.utils.tree import tree_leaves
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    leaves = tree_leaves(build_model(cfg).init(None, device="meta"))
    return (sum(x.numel() for x in leaves),
            sum(x.numel() * x.element_size() for x in leaves))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("log")
    ap.add_argument("--limit-gib", type=float, default=70.0)
    ap.add_argument("--max-layers", type=int, default=64)
    args = ap.parse_args(argv)
    with open(args.log, errors="replace") as f:
        rows = [m.groupdict() for m in map(LINE.search, f) if m]
    if not rows:
        sys.exit(f"no [train zoo] lines in {args.log}")
    for r in rows:
        arch = ARCH[r["name"]]
        l0, c, peak = int(r["layers"]), int(r["c"]), float(r["peak"])
        n0, b0 = params_bytes(arch, l0)
        adam = r["route"] == "server Adam"
        state = (b0 * (1 + c) + (8 * n0 if adam else 0)) / GIB
        base = peak - state
        deepest, n_deep = l0, n0
        for layers in range(l0 + 1, args.max_layers + 1):
            try:
                n, b = params_bytes(arch, layers)
            except ValueError:          # a depth the family cannot take
                continue                # (llama-vision: groups of 5)
            if base * b / b0 > args.limit_gib:
                break
            deepest, n_deep = layers, n
        print(f"{arch}: cut {l0} layers ({n0:,} params, C {c}, "
              f"{r['route']}): phase peak {peak:.2f} GiB, state held twice "
              f"{state:.2f} GiB, donated estimate {base:.2f} GiB; deepest "
              f"cut under {args.limit_gib:g} GiB by this arithmetic: "
              f"{deepest} layers ({n_deep:,} params; not run)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
