"""Mobile multi-cell PerFedS²: mobility, handovers, cell→cloud hierarchy.

Runs the same non-iid MNIST workload as ``quickstart.py`` in three regimes:

  static    — the paper's single frozen cell (mobility disabled)
  mobile    — one cell, vehicular random-waypoint UEs (time-varying
              path loss ⇒ mobility-induced stragglers)
  hierarchy — 3 cells with nearest-BS handover, per-cell semi-sync edge
              servers, and a cloud merge every 3 edge rounds

    PYTHONPATH=src python -m repro_torch.examples.mobile_edge \
        [--device cpu] [a.b=c overrides ...]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional

import numpy as np

from repro_torch.config import (ExperimentConfig, FLConfig, MobilityConfig,
                                apply_overrides, parse_cli_overrides)
from repro_torch.configs import get_config
from repro_torch.data import partition_noniid, synthetic_mnist
from repro_torch.fl.engine import resolve_device
from repro_torch.fl.simulation import run_simulation
from repro_torch.models import build_model

N_UES, ROUNDS = 24, 12


def main(argv=None, *, max_rounds: Optional[int] = None):
    """Returns {regime: SimResult}."""
    ap = argparse.ArgumentParser(description="mobile multi-cell PerFedS²")
    ap.add_argument("--device", default="cuda")
    args, rest = ap.parse_known_args(argv)
    device = resolve_device(args.device)
    cfg = ExperimentConfig(
        model=get_config("mnist_dnn"),
        fl=FLConfig(n_ues=N_UES, participants_per_round=6,
                    staleness_bound=4, alpha=0.03, beta=0.07,
                    inner_batch=8, outer_batch=8, hessian_batch=8,
                    first_order=True))
    cfg = apply_overrides(cfg, parse_cli_overrides(rest))
    model = build_model(cfg.model)
    data = synthetic_mnist(n=2500, seed=0)

    # these demo runs last only a few simulated seconds; mobility
    # integrates on the step_s grid, so a sub-second tick keeps the UEs
    # visibly moving (and handing over) within the run
    regimes = {
        "static": cfg,
        "mobile": dataclasses.replace(cfg, mobility=MobilityConfig(
            enabled=True, model="random_waypoint", speed_mps=20.0,
            n_cells=1, step_s=0.1)),
        "hierarchy": dataclasses.replace(cfg, mobility=MobilityConfig(
            enabled=True, model="random_waypoint", speed_mps=40.0,
            n_cells=3, hierarchy=True, cloud_sync_every=3, step_s=0.1)),
    }

    results = {}
    for label, c in regimes.items():
        clients = partition_noniid(data, N_UES, n_labels=4, seed=0)
        res = run_simulation(c, model, clients, algorithm="perfed",
                             mode="semi", bandwidth_policy="equal",
                             max_rounds=min(ROUNDS, max_rounds or ROUNDS),
                             eval_every=4, seed=0, name=label,
                             device=device)
        results[label] = res
        print(f"[{label:9s}] cells={res.n_cells} "
              f"rounds={int(res.rounds[-1]) if len(res.rounds) else 0:3d} "
              f"sim_t={res.total_time:7.2f}s "
              f"handovers={res.handovers:3d} "
              f"cloud_merges={res.cloud_rounds} "
              f"final_ploss={res.losses[-1]:.4f} "
              f"wait={res.wait_fraction:.2f}")
        print(f"            realised η spread: "
              f"{np.ptp(res.eta_realised):.4f}")
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
