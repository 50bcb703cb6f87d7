"""Fig. 3-style comparison: the paper's algorithm grid on one synthetic
non-iid task, reporting time-to-loss for each.

    PYTHONPATH=src python -m repro_torch.examples.compare_algorithms \
        [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

from repro_torch.config import ExperimentConfig, FLConfig
from repro_torch.configs import get_config
from repro_torch.data import partition_noniid, synthetic_mnist
from repro_torch.fl.algorithms import ALGORITHMS
from repro_torch.fl.engine import resolve_device
from repro_torch.fl.simulation import run_simulation
from repro_torch.models import build_model


def main(argv=None, *, max_rounds: Optional[int] = None):
    """Returns {algorithm name: SimResult}."""
    ap = argparse.ArgumentParser(description="the paper's algorithm grid")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = ExperimentConfig(
        model=get_config("mnist_dnn"),
        fl=FLConfig(n_ues=10, participants_per_round=3, staleness_bound=3,
                    alpha=0.03, beta=0.07, inner_batch=16, outer_batch=16,
                    hessian_batch=16))
    model = build_model(cfg.model)
    clients = partition_noniid(synthetic_mnist(n=3000), 10, n_labels=4)

    print(f"{'algorithm':14s} {'rounds':>6s} {'sim time':>9s} "
          f"{'personalized':>12s} {'global':>8s}")
    results = {}
    for name, (algo, mode) in ALGORITHMS.items():
        rounds = 20 if mode != "sync" else 6       # equalise gradient budget
        rounds = min(rounds, max_rounds or rounds)
        res = run_simulation(cfg, model, clients, algorithm=algo, mode=mode,
                             max_rounds=rounds, eval_every=rounds, seed=0,
                             device=device)
        results[name] = res
        print(f"{name:14s} {res.rounds[-1]:6d} {res.total_time:8.2f}s "
              f"{res.losses[-1]:12.4f} {res.global_losses[-1]:8.4f}")

    print("\nPerFedS2 should dominate the time-to-personalized-loss "
          "frontier;")
    print("*-SYN rows pay straggler wall-clock, *-ASY rows pay gradient "
          "staleness.")
    return results


if __name__ == "__main__":
    main()
    sys.exit(0)
