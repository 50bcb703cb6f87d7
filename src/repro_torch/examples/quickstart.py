"""Quickstart: train a personalized model with PerFedS² in ~30 lines.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

from repro_torch.config import ExperimentConfig, FLConfig
from repro_torch.configs import get_config
from repro_torch.data import partition_noniid, synthetic_mnist
from repro_torch.fl.engine import resolve_device
from repro_torch.fl.simulation import run_simulation
from repro_torch.models import build_model

ROUNDS = 40


def main(argv=None, *, max_rounds: Optional[int] = None):
    ap = argparse.ArgumentParser(description="PerFedS² quickstart")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # 1) experiment config: 20 UEs, A=5 arrivals per round, staleness bound
    #    S=5 (the paper's Table I hyperparameters for MNIST)
    cfg = ExperimentConfig(
        model=get_config("mnist_dnn"),
        fl=FLConfig(n_ues=20, participants_per_round=5, staleness_bound=5,
                    alpha=0.03, beta=0.07,
                    inner_batch=16, outer_batch=16, hessian_batch=16),
    )

    # 2) non-iid federated data: every UE holds l=4 of the 10 classes
    model = build_model(cfg.model)
    clients = partition_noniid(synthetic_mnist(n=4000), cfg.fl.n_ues,
                               n_labels=4)

    # 3) run the full system: wireless channels, Theorem-4 bandwidth, Alg.1
    #    semi-synchronous server, Eq.-7 meta-gradients
    result = run_simulation(cfg, model, clients, algorithm="perfed",
                            mode="semi",
                            max_rounds=min(ROUNDS, max_rounds or ROUNDS),
                            eval_every=10, verbose=True, device=device)

    print(f"\nPerFedS² finished {result.rounds[-1]} rounds in "
          f"{result.total_time:.1f} simulated seconds")
    print(f"personalized loss {result.losses[0]:.3f} → "
          f"{result.losses[-1]:.3f}")
    print(f"per-round participants (Π row sums): {set(result.pi.sum(1))}")
    print(f"realised η: {result.eta_realised.round(3)}")
    return result


if __name__ == "__main__":
    main()
    sys.exit(0)
