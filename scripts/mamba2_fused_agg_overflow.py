#!/usr/bin/env python3
"""Does mamba2's ``--fused-agg`` step overflow in the JAX package too?

    PYTHONPATH=src python scripts/mamba2_fused_agg_overflow.py \
        [--layers 2 4] [--dtypes bfloat16 float32] [--out FILE]

On the card, two rounds of mamba2-370m's semi-synchronous step at
``train_e2e``'s ``--fused-agg`` settings (alpha 0.02, beta 0.5, no
clipping: beta-SGD through the fused Eq.-8 update; 4 cohorts, A 2, S 2,
batch 4, seq 256, the masks ``chip_smoke.SPMD_MASKS``) leave non-finite
elements in the second round's buffers.  This script runs both packages
on the CPU at full width (d_model 1,024, the full vocabulary) and a cut
depth: the reference's ``init_state`` under
``jax.threefry_partitionable(False)``, its state carried across to the
port as numpy, the same numpy batches (``train_e2e.round_batches``) and
masks into both, each package then stepping on its own state.  After
each round it prints, for each package, the non-finite elements of each
params and buffer leaf, the largest finite magnitude of the buffers, and
the port's largest error against the reference on the finite elements
(relative to 1 + max|p|).  ``--out`` writes the same as JSON.

In bf16 the two packages' states part after the first round (mamba2 in
bf16 is chaotic: the round-0 meta-gradients differ by bf16 roundings,
and the unclipped beta-0.5 step carries that into the params), so
``--carry`` gives the port the reference's state anew before every round:
then each round's non-finite counts compare the two packages on the same
inputs.  ``--logaddexp-softplus`` runs the port with ``torch.logaddexp``'s
softplus, whose second derivative reads 0 · inf = NaN below x ≈ -88
(``models/layers.softplus`` keeps the value and takes the derivatives of
max(x, 0) + log1p(e^-|x|)).

A one-off experiment: it imports both packages (as the parity tests do)
and is not part of the port.
"""
import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

MASKS = ([1.0, 1.0, 0.0, 0.0], [1.0, 1.0, 0.0, 0.0])   # SPMD_MASKS
COHORTS, STALENESS, BATCH, SEQ = 4, 2, 4, 256


def _configs(layers, dtype):
    from repro.config import ExperimentConfig as RefExp
    from repro.config import FLConfig as RefFL
    from repro.config import TrainConfig as RefTrain
    from repro.configs import get_config as ref_get_config
    from repro_torch.config import ExperimentConfig, FLConfig, TrainConfig
    from repro_torch.configs import get_config
    fl = dict(alpha=0.02, beta=0.5, staleness_bound=STALENESS,
              algorithm="perfed")
    ref_m = dataclasses.replace(ref_get_config("mamba2_370m"),
                                num_layers=layers, dtype=dtype, remat=False)
    port_m = dataclasses.replace(get_config("mamba2_370m"),
                                 num_layers=layers, dtype=dtype, remat=False)
    return (RefExp(model=ref_m, fl=RefFL(**fl),
                   train=RefTrain(grad_clip=0.0)),
            ExperimentConfig(model=port_m, fl=FLConfig(**fl),
                             train=TrainConfig(grad_clip=0.0)))


def _count(paths, leaves):
    """{path: non-finite elements} and the largest finite magnitude."""
    bad, top = {}, 0.0
    for path, x in zip(paths, leaves):
        x = np.asarray(x, np.float32)
        fin = np.isfinite(x)
        if not fin.all():
            bad[path] = int((~fin).sum())
        if fin.any():
            top = max(top, float(np.abs(x[fin]).max()))
    return bad, top


def _err(port_leaves, ref_leaves):
    """The port's largest error on the elements finite in both, relative
    to 1 + max|p| of the reference's leaf."""
    worst = 0.0
    for got, want in zip(port_leaves, ref_leaves):
        got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
        fin = np.isfinite(got) & np.isfinite(want)
        if fin.any():
            scale = 1.0 + float(np.abs(want[fin]).max())
            worst = max(worst, float(np.abs(got[fin] - want[fin]).max())
                        / scale)
    return worst


def run_case(layers, dtype, carry=False, logaddexp=False):
    import jax
    import jax.numpy as jnp
    import torch

    from repro.core import semi_sync as ref_semi_sync
    from repro.models import build_model as ref_build_model
    from repro.optim import make_optimizer as ref_make_optimizer
    from repro_torch.core import semi_sync
    from repro_torch.launch import train_e2e
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.utils.tree import (from_numpy_tree, tree_leaves,
                                        tree_map, tree_paths)

    if logaddexp:
        from repro_torch.models import layers
        layers.softplus = lambda x: torch.logaddexp(x, torch.zeros_like(x))
    ref_cfg, cfg = _configs(layers, dtype)
    ref, port = ref_build_model(ref_cfg.model), build_model(cfg.model)
    ref_opt, opt = ref_make_optimizer("sgd"), make_optimizer("sgd")
    assert semi_sync.uses_fused_eq8(opt, cfg)
    assert ref_semi_sync.uses_fused_eq8(ref_opt, ref_cfg)
    ref_step = jax.jit(ref_semi_sync.make_semi_sync_step(ref, ref_cfg,
                                                         ref_opt, COHORTS))
    step = semi_sync.make_semi_sync_step(port, cfg, opt, COHORTS)
    with jax.threefry_partitionable(False):
        ref_state = ref_semi_sync.init_state(ref, jax.random.PRNGKey(0),
                                             ref_opt, COHORTS)

    def carried(ref_state):
        params = from_numpy_tree(jax.tree.map(np.asarray, ref_state.params),
                                 "cpu")
        return semi_sync.SemiSyncState(
            params=params, opt_state=opt.init(params),
            buffers=from_numpy_tree(jax.tree.map(np.asarray,
                                                 ref_state.buffers), "cpu"),
            staleness=torch.from_numpy(np.array(ref_state.staleness)),
            step=torch.tensor(int(ref_state.step), dtype=torch.int32))

    state = carried(ref_state)
    params = state.params
    n_params = sum(x.numel() for x in tree_leaves(params))
    corpora = train_e2e.cohort_corpora(COHORTS, cfg.model.vocab_size)
    paths = tree_paths(state.params)
    rounds = []
    for k, m in enumerate(MASKS):
        batches = train_e2e.round_batches(corpora, k, batch=BATCH, seq=SEQ,
                                          device="cpu")
        np_batches = tree_map(lambda x: x.numpy(), batches)
        if carry and k:
            state = carried(ref_state)
        t0 = time.perf_counter()
        ref_state, _ = ref_step(ref_state, np_batches, jnp.asarray(m),
                                jax.random.PRNGKey(k))
        jax.block_until_ready(ref_state.params)
        t_ref = time.perf_counter() - t0
        t0 = time.perf_counter()
        state, _ = step(state, batches, torch.tensor(m))
        t_port = time.perf_counter() - t0
        rec = {"round": k, "mask": m, "seconds": {"reference": t_ref,
                                                  "port": t_port}}
        for name, tree_ref, tree_port in (
                ("params", ref_state.params, state.params),
                ("buffers", ref_state.buffers, state.buffers)):
            ref_leaves = [np.asarray(x, np.float32)
                          for x in jax.tree.leaves(tree_ref)]
            port_leaves = [x.float().numpy() for x in tree_leaves(tree_port)]
            bad_ref, top_ref = _count(paths, ref_leaves)
            bad_port, top_port = _count(paths, port_leaves)
            rec[name] = {
                "reference": {"nonfinite": bad_ref, "max_abs": top_ref},
                "port": {"nonfinite": bad_port, "max_abs": top_port},
                "port_err_rel": _err(port_leaves, ref_leaves)}
        rounds.append(rec)
        b = rec["buffers"]
        print(f"[{layers} layers, {dtype}{', carried' if carry else ''}"
              f"{', logaddexp softplus' if logaddexp else ''}] "
              f"round {k} mask {m}: reference "
              f"{t_ref:.1f} s, port {t_port:.1f} s; non-finite buffer "
              f"elements: reference {sum(b['reference']['nonfinite'].values())}"
              f" in {len(b['reference']['nonfinite'])} leaves, port "
              f"{sum(b['port']['nonfinite'].values())} in "
              f"{len(b['port']['nonfinite'])} leaves; largest finite |buf| "
              f"{b['reference']['max_abs']:.3e} / {b['port']['max_abs']:.3e}; "
              f"port vs reference on the finite elements: params "
              f"{rec['params']['port_err_rel']:.3e}, buffers "
              f"{b['port_err_rel']:.3e}; non-finite params: reference "
              f"{sum(rec['params']['reference']['nonfinite'].values())}, port "
              f"{sum(rec['params']['port']['nonfinite'].values())}",
              flush=True)
        for who in ("reference", "port"):
            if b[who]["nonfinite"]:
                print(f"    {who}: " + ", ".join(
                    f"{p} {n}" for p, n in b[who]["nonfinite"].items()),
                    flush=True)
    return {"layers": layers, "dtype": dtype, "carry": carry,
            "logaddexp_softplus": logaddexp,
            "params": n_params, "rounds": rounds}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[2, 4])
    ap.add_argument("--dtypes", nargs="+", default=["bfloat16", "float32"])
    ap.add_argument("--carry", action="store_true",
                    help="the reference's state carried into the port "
                         "before every round, not only the first")
    ap.add_argument("--logaddexp-softplus", action="store_true",
                    help="the port's softplus as torch.logaddexp(x, 0)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    out = []
    for layers in args.layers:
        for dtype in args.dtypes:
            t0 = time.perf_counter()
            case = run_case(layers, dtype, carry=args.carry,
                            logaddexp=args.logaddexp_softplus)
            case["seconds"] = time.perf_counter() - t0
            print(f"[{layers} layers, {dtype}] {case['params']:,} params, "
                  f"{case['seconds']:.1f} s", flush=True)
            out.append(case)
            if args.out:
                with open(args.out, "w") as f:
                    json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
