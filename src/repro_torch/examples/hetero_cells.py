"""Heterogeneous per-cell radio resources: macro/micro budgets, Theorem-2
allocation in the mobile loop, and load-aware association.

One macro BS (2 MHz) plus two micro BSs (0.5 MHz each) serve vehicular
random-waypoint UEs.  Four regimes compare the knobs:

  nearest/equal      — legacy: nearest-BS association, even per-cell split
  nearest/theorem2   — per-cell equal-finish bisection (paper Thm. 2),
                       warm-started from each cell's previous t*
  load_aware/equal   — hot (or skinny-budget) cells shed UEs to neighbours
  load_aware/theorem2— both: the full heterogeneous-resource stack

    PYTHONPATH=src python -m repro_torch.examples.hetero_cells \
        [--device cpu] [a.b=c overrides ...]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional

from repro_torch.config import (ExperimentConfig, FLConfig, MobilityConfig,
                                apply_overrides, parse_cli_overrides)
from repro_torch.configs import get_config
from repro_torch.data import partition_noniid, synthetic_mnist
from repro_torch.fl.engine import resolve_device
from repro_torch.fl.simulation import run_simulation
from repro_torch.models import build_model

N_UES, ROUNDS = 24, 12
BUDGETS = (2e6, 5e5, 5e5)            # macro + two micros [Hz]


def main(argv=None, *, max_rounds: Optional[int] = None):
    """Returns {"association/policy": SimResult}."""
    ap = argparse.ArgumentParser(description="heterogeneous cells")
    ap.add_argument("--device", default="cuda")
    args, rest = ap.parse_known_args(argv)
    device = resolve_device(args.device)
    cfg = ExperimentConfig(
        model=get_config("mnist_dnn"),
        fl=FLConfig(n_ues=N_UES, participants_per_round=6,
                    staleness_bound=4, alpha=0.03, beta=0.07,
                    inner_batch=8, outer_batch=8, hessian_batch=8,
                    first_order=True, eta_mode="distance"))
    cfg = apply_overrides(cfg, parse_cli_overrides(rest))
    model = build_model(cfg.model)
    data = synthetic_mnist(n=2500, seed=0)

    results = {}
    for assoc in ("nearest", "load_aware"):
        for policy in ("equal", "theorem2"):
            c = dataclasses.replace(cfg, mobility=MobilityConfig(
                enabled=True, model="random_waypoint", speed_mps=30.0,
                n_cells=3, hierarchy=True, cloud_sync_every=4,
                cell_bandwidth_hz=BUDGETS, association=assoc))
            clients = partition_noniid(data, N_UES, n_labels=4, seed=0)
            res = run_simulation(c, model, clients, algorithm="perfed",
                                 mode="semi", bandwidth_policy=policy,
                                 max_rounds=min(ROUNDS, max_rounds or ROUNDS),
                                 eval_every=4, seed=0,
                                 name=f"{assoc}/{policy}", device=device)
            results[f"{assoc}/{policy}"] = res
            rounds = max(int(res.pi.shape[0]), 1)
            print(f"[{assoc:10s}/{policy:8s}] "
                  f"rounds={rounds:3d} "
                  f"sim_round={res.total_time / rounds:6.3f}s "
                  f"handovers={res.handovers:3d} "
                  f"final_ploss={res.losses[-1]:.4f} "
                  f"wait={res.wait_fraction:.2f}")
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
