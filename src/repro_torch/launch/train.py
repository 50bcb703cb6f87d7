"""End-to-end training launcher, on the card unless ``--device cpu``.

The port of the JAX package's ``launch/train.py``, with the same CLI plus
``--device``.  Two modes:

* ``--mode fl``     (default) — the paper: event-driven PerFedS² simulation
  over a mobile edge network with the paper's small models and synthetic
  federated datasets (``fl/simulation.run_simulation``).
* ``--mode scale``  — the PerFed train step (``core/semi_sync``) on an LM
  architecture, SGD with the Eq.-7 meta-gradient, on batches drawn from the
  synthetic LM corpus (``--reduce`` for a tiny same-family model).

``--metrics-dir`` writes the fl mode's eval points to
``<dir>/metrics.jsonl`` through ``utils.metrics.MetricsLogger``, as the
reference does.  ``--ckpt-dir DIR`` saves the scale mode's final params to
``DIR/ckpt_<steps>.npz`` (``checkpoint.save_checkpoint``, the reference's
file format).

Examples:
  PYTHONPATH=src python -m repro_torch.launch.train --mode fl \
      --arch mnist_dnn --algo perfed --sync-mode semi fl.rounds=50
  PYTHONPATH=src python -m repro_torch.launch.train --mode scale \
      --arch mamba2_370m --reduce --steps 20 --device cpu
"""
from __future__ import annotations

import argparse
import sys
import time
from dataclasses import replace

import numpy as np
import torch


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="PerFedS² training launcher")
    ap.add_argument("--mode", default="fl", choices=["fl", "scale"])
    ap.add_argument("--arch", default="mnist_dnn")
    ap.add_argument("--algo", default="perfed",
                    choices=["perfed", "fedavg", "fedprox"])
    ap.add_argument("--sync-mode", default="semi",
                    choices=["sync", "semi", "async"])
    ap.add_argument("--bandwidth", default="optimal",
                    choices=["optimal", "equal"])
    ap.add_argument("--noniid-l", type=int, default=4)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--reduce", action="store_true",
                    help="scale mode: reduced model")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--metrics-dir", default="",
                    help="write metrics.jsonl under this directory")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", help="dotted config overrides")
    return ap


def run(argv=None):
    """Train once and print what ``main`` prints; return the fl mode's
    ``SimResult``, or the scale mode's (final state, last metrics), for
    callers that check them."""
    args = _parser().parse_args(argv)
    from repro_torch.config import (ExperimentConfig, apply_overrides,
                                    parse_cli_overrides)
    from repro_torch.configs import get_config
    from repro_torch.fl.engine import resolve_device

    device = resolve_device(args.device)
    cfg = ExperimentConfig(model=get_config(args.arch))
    cfg = apply_overrides(cfg, parse_cli_overrides(args.overrides))
    if args.mode == "fl":
        return run_fl(cfg, args, device)
    return run_scale(cfg, args, device)


def main(argv=None) -> int:
    run(argv)
    return 0


def run_fl(cfg, args, device):
    from repro_torch.data import partition_noniid, synthetic_mnist
    from repro_torch.data.partition import sequence_clients
    from repro_torch.data.synthetic import (synthetic_cifar,
                                            synthetic_shakespeare)
    from repro_torch.fl.simulation import run_simulation
    from repro_torch.models import build_model

    model = build_model(cfg.model)
    name = cfg.model.name
    if name.startswith("char_lstm"):
        role_data = synthetic_shakespeare(n_roles=cfg.fl.n_ues)
        clients = sequence_clients(role_data, cfg.fl.n_ues, seed=args.seed)
    elif name.startswith("lenet5"):
        clients = partition_noniid(synthetic_cifar(n=4000), cfg.fl.n_ues,
                                   n_labels=args.noniid_l, seed=args.seed)
    else:
        clients = partition_noniid(synthetic_mnist(n=4000), cfg.fl.n_ues,
                                   n_labels=args.noniid_l, seed=args.seed)

    res = run_simulation(cfg, model, clients, algorithm=args.algo,
                         mode=args.sync_mode, bandwidth_policy=args.bandwidth,
                         seed=args.seed, verbose=True, device=device)
    if args.metrics_dir:
        from repro_torch.utils.metrics import MetricsLogger
        with MetricsLogger(args.metrics_dir,
                           meta={"arch": args.arch, "algo": args.algo,
                                 "mode": args.sync_mode}) as log:
            for i in range(len(res.times)):
                log.log(step=int(res.rounds[i]), sim_t=float(res.times[i]),
                        ploss=float(res.losses[i]),
                        gloss=float(res.global_losses[i]))
    print(f"\nfinal: t={res.total_time:.2f}s rounds={res.rounds[-1]} "
          f"personalized_loss={res.losses[-1]:.4f} "
          f"global_loss={res.global_losses[-1]:.4f} "
          f"wait_frac={res.wait_fraction:.3f}")
    return res


def lm_batch(corpus: np.ndarray, rng: np.random.Generator, bsz: int,
             seq: int, device, codebooks: int = 0) -> dict:
    """``bsz`` random windows of the corpus → {"tokens", "targets"} [bsz,
    seq] int32 on ``device`` (targets = tokens shifted by one); with
    ``codebooks`` K > 0 (the audio family) each token is tiled over the K
    codebooks, [bsz, seq, K], as the reference does."""
    starts = rng.integers(0, len(corpus) - seq - 1, size=bsz)
    win = np.stack([corpus[s:s + seq + 1] for s in starts])
    if codebooks:
        win = np.repeat(win[..., None], codebooks, axis=-1)
    win = torch.from_numpy(win).to(device)
    return {"tokens": win[:, :-1], "targets": win[:, 1:]}


def run_scale(cfg, args, device):
    from repro_torch.core import semi_sync
    from repro_torch.data.synthetic import synthetic_lm_corpus
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer

    mcfg = cfg.model.reduced() if args.reduce else cfg.model
    model = build_model(mcfg)
    optimizer = make_optimizer("sgd")
    step_fn = semi_sync.make_train_step(model, replace(cfg, model=mcfg),
                                        optimizer, perfed_step=True)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = semi_sync.init_train_state(model, gen, optimizer)

    corpus = synthetic_lm_corpus(n_tokens=1 << 15, vocab=mcfg.vocab_size)
    rng = np.random.default_rng(args.seed)
    seq, bsz = 64, 8
    t0 = time.time()
    for step in range(args.steps):
        batches = {k: lm_batch(corpus, rng, bsz, seq, device,
                               mcfg.num_audio_codebooks)
                   for k in ("inner", "outer", "hessian")}
        state, metrics = step_fn(state, batches)
        if step % max(1, args.steps // 10) == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss={float(metrics['loss']):.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({time.time() - t0:.1f}s)", flush=True)
    if args.ckpt_dir:
        from repro_torch.checkpoint import save_checkpoint
        print("saved", save_checkpoint(args.ckpt_dir, state.params,
                                       step=args.steps))
    return state, metrics


if __name__ == "__main__":
    sys.exit(main())
