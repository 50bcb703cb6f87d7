#!/usr/bin/env python3
"""What do the gated norm's derivative rules cost a training round?

    python3 scripts/mamba2_norm_cost.py [--rounds 3] [--order A B ...]
        [--device cuda] [--reduce] [--out FILE]

Times ``train_e2e``'s round loop as ``chip_smoke.phase_train_mamba`` runs
it (mamba2-370m at full width, bf16, 4 cohorts, A 2, S 2, batch 4, seq
256, server Adam, the params from ``torch.Generator(device).manual_seed
(0)``) with ``layers.rmsnorm`` two ways, each from a fresh state, in the
order ``--order`` gives (default: torch-rsqrt, port, port, torch-rsqrt):

* ``port``: the port's ``rmsnorm`` (``layers._RMSUnit``: the JAX
  package's derivative rules in an autograd Function);
* ``torch-rsqrt``: the same expression with torch's own derivatives
  (``mamba2_hvp_bisect.rmsnorm_torch_rsqrt``), which is the port's norm
  before it took the JAX package's rules, bitwise the same value.

It prints each run's seconds a round (round 0 carries the first call's
warm-up) and the card's name and power limit.  ``--reduce --device cpu``
rehearses it at the reduced config.
"""
import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

COHORTS, PART, STALENESS, BATCH, SEQ = 4, 2, 2, 4, 256


def smi():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"


def run(args):
    import torch

    from mamba2_hvp_bisect import rmsnorm_torch_rsqrt
    from repro_torch.configs import get_config
    from repro_torch.core import semi_sync
    from repro_torch.core.scheduler import (greedy_schedule,
                                            relative_frequencies)
    from repro_torch.launch import train_e2e
    from repro_torch.models import build_model, layers
    from repro_torch.optim import make_optimizer
    dev = args.device
    norms = {"port": layers.rmsnorm, "torch-rsqrt": rmsnorm_torch_rsqrt(torch)}
    cfg = get_config("mamba2_370m")
    bsz, seq = BATCH, SEQ
    if args.reduce:
        cfg, bsz, seq = cfg.reduced(), 2, 64
    model = build_model(cfg)
    exp = train_e2e.experiment_cfg(cfg, staleness=STALENESS, fused_agg=False)
    opt = make_optimizer("adam")
    pi = greedy_schedule(relative_frequencies(COHORTS, "equal"), PART,
                         args.rounds)
    kw = dict(pi=pi, corpora=train_e2e.cohort_corpora(COHORTS,
                                                      cfg.vocab_size),
              batch=bsz, seq=seq, device=dev)
    out = {"card": smi(), "config": {"layers": cfg.num_layers,
                                     "dtype": cfg.dtype, "remat": cfg.remat,
                                     "batch": bsz, "seq": seq},
           "runs": []}
    for name in args.order:
        layers.rmsnorm = norms[name]
        try:
            state = semi_sync.init_state(
                model, torch.Generator(device=dev).manual_seed(0), opt,
                COHORTS)
            t0 = time.perf_counter()
            state, rec = train_e2e.train_rounds(
                model, exp, opt, state, rounds=range(args.rounds), **kw)
            wall = time.perf_counter() - t0
        finally:
            layers.rmsnorm = norms["port"]
        secs = [r["seconds"] for r in rec]
        out["runs"].append({"norm": name, "seconds": secs, "wall": wall})
        print(f"[norm cost] {name}: s/round "
              f"{', '.join(f'{s:.3f}' for s in secs)} [{out['card']}]",
              flush=True)
        del state, rec
        if dev == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--order", nargs="+", choices=("port", "torch-rsqrt"),
                    default=["torch-rsqrt", "port", "port", "torch-rsqrt"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reduce", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    out = run(args)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
