"""End-to-end driver: PerFed semi-synchronous training of an LM across
simulated client cohorts — the datacenter-scale mapping of Alg. 1.

The port of the JAX package's ``examples/train_e2e.py``, with the same CLI
plus ``--device`` (the card unless ``--device cpu``).  Default runs a ~8M-
param Yi-family model; ``--model-scale 100m`` a ~100M-param variant.  The
round loop is ``train_rounds``, which takes any model and config, so other
callers drive other models (full-width mamba2-370m and the rest of the zoo
in ``chip_smoke.py``) through the same loop.  Batches are drawn with numpy
from a seed per round.
``--ckpt-dir DIR`` saves the final params to ``DIR/ckpt_<rounds>.npz``
(``checkpoint.save_checkpoint``, the reference's file format).

    PYTHONPATH=src python -m repro_torch.launch.train_e2e --rounds 60
    PYTHONPATH=src python -m repro_torch.launch.train_e2e --rounds 2 \
        --server-opt adam --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.config import ExperimentConfig, FLConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.core import semi_sync
from repro_torch.core.scheduler import greedy_schedule, relative_frequencies
from repro_torch.data.synthetic import synthetic_lm_corpus
from repro_torch.fl.engine import resolve_device
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.utils.tree import tree_leaves, tree_map


def model_cfg(scale: str):
    base = get_config("yi_6b")
    if scale == "100m":
        return dataclasses.replace(
            base, name="yi-100m", num_layers=12, d_model=768, num_heads=12,
            num_kv_heads=4, d_ff=2048, vocab_size=8192, remat=False)
    return dataclasses.replace(
        base, name="yi-8m", num_layers=4, d_model=256, num_heads=4,
        num_kv_heads=2, d_ff=1024, vocab_size=2048, remat=False)


def experiment_cfg(mcfg, *, staleness: int, fused_agg: bool
                   ) -> ExperimentConfig:
    """The example's FL settings: α 0.02, β 0.5, PerFed; clipping at 1.0
    unless the fused Eq.-8 path is asked for."""
    return ExperimentConfig(
        model=mcfg,
        fl=FLConfig(alpha=0.02, beta=0.5, staleness_bound=staleness,
                    algorithm="perfed"),
        train=TrainConfig(grad_clip=0.0 if fused_agg else 1.0))


def cohort_corpora(n: int, vocab: int) -> List[np.ndarray]:
    """Per-cohort non-iid corpora (one synthetic seed per cohort)."""
    return [synthetic_lm_corpus(1 << 15, vocab=vocab, seed=i)
            for i in range(n)]


def round_batches(corpora, k: int, *, batch: int, seq: int, device,
                  codebooks: int = 0):
    """Round k's {"inner", "outer", "hessian"} batches, each leaf [n_cohorts,
    batch, seq], drawn from k alone; with ``codebooks`` K > 0 (the audio
    family) each token is tiled over the K codebooks, [n_cohorts, batch,
    seq, K], as ``launch.train.lm_batch`` does."""
    rng = np.random.default_rng([0, k])

    def one():
        wins = []
        for c in corpora:
            starts = rng.integers(0, len(c) - seq - 1, size=batch)
            wins.append(np.stack([c[s:s + seq + 1] for s in starts]))
        w = np.stack(wins)
        if codebooks:
            w = np.repeat(w[..., None], codebooks, axis=-1)
        w = torch.from_numpy(w).to(device)
        return {"tokens": w[:, :, :-1], "targets": w[:, :, 1:]}

    return {"inner": one(), "outer": one(), "hessian": one()}


def train_rounds(model, cfg: ExperimentConfig, opt, state, *, pi: np.ndarray,
                 corpora, rounds: range, batch: int, seq: int, device,
                 log_every: Optional[int] = None):
    """Run the semi-synchronous rounds ``rounds`` (indices into the Alg.-2
    schedule ``pi``) from ``state``.  Returns (state, one record per round:
    mask, seconds, metrics).  An audio model's batches carry its K
    codebooks."""
    step_fn = semi_sync.make_semi_sync_step(model, cfg, opt, len(corpora))
    codebooks = model.cfg.num_audio_codebooks
    sync = (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))
    records = []
    t0 = time.time()
    for k in rounds:
        batches = round_batches(corpora, k, batch=batch, seq=seq,
                                device=device, codebooks=codebooks)
        mask = torch.as_tensor(pi[k], dtype=torch.float32, device=device)
        sync()
        t_round = time.perf_counter()
        state, metrics = step_fn(state, batches, mask)
        sync()
        records.append({"round": k, "mask": pi[k].tolist(),
                        "seconds": time.perf_counter() - t_round,
                        "metrics": metrics})
        if log_every and (k % log_every == 0 or k == rounds[-1]):
            eb = tree_map(lambda x: x[0], batches["outer"])
            with torch.no_grad():
                loss = float(model.loss(state.params, eb)[0])
            print(f"round {k:4d} mask={pi[k]} loss={loss:.4f} "
                  f"max_stale={int(metrics['max_staleness'])} "
                  f"({time.time() - t0:.1f}s)", flush=True)
    return state, records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--cohorts", type=int, default=4)
    ap.add_argument("--participants", type=int, default=2)   # A
    ap.add_argument("--staleness", type=int, default=2)      # S
    ap.add_argument("--model-scale", default="8m", choices=["8m", "100m"])
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--server-opt", default="sgd",
                    choices=["sgd", "momentum", "adam"])
    ap.add_argument("--fused-agg", action="store_true",
                    help="disable grad clipping so the round update takes "
                         "the fused Eq.-(8) stale_aggregate path (β-SGD)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.fused_agg and args.server_opt != "sgd":
        ap.error("--fused-agg requires --server-opt sgd (the fused Eq.-8 "
                 "path is the plain β-SGD update)")
    device = resolve_device(args.device)

    mcfg = model_cfg(args.model_scale)
    cfg = experiment_cfg(mcfg, staleness=args.staleness,
                         fused_agg=args.fused_agg)
    model = build_model(mcfg)
    opt = make_optimizer(args.server_opt)
    n = args.cohorts
    state = semi_sync.init_state(
        model, torch.Generator(device=device).manual_seed(0), opt, n)
    nparams = sum(x.numel() for x in tree_leaves(state.params))
    agg_path = ("fused stale_aggregate (Eq. 8)"
                if semi_sync.uses_fused_eq8(opt, cfg)
                else f"masked mean + {opt.name}")
    print(f"model {mcfg.name}: {nparams / 1e6:.1f}M params, "
          f"{n} cohorts, A={args.participants}, S={args.staleness}, "
          f"aggregation: {agg_path}")

    pi = greedy_schedule(relative_frequencies(n, "equal"), args.participants,
                         args.rounds)
    state, _ = train_rounds(model, cfg, opt, state, pi=pi,
                            corpora=cohort_corpora(n, mcfg.vocab_size),
                            rounds=range(args.rounds), batch=args.batch,
                            seq=args.seq, device=device,
                            log_every=max(1, args.rounds // 10))
    if args.ckpt_dir:
        print("saved", save_checkpoint(args.ckpt_dir, state.params,
                                       step=args.rounds))
    return 0


if __name__ == "__main__":
    sys.exit(main())
