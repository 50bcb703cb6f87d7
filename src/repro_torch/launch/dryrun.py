"""Dry run: one step of every (arch × shape × mesh) case, counted per rank.

The port of the JAX package's ``launch/dryrun.py``.  Torch has no XLA
lowering, so a case runs ``specs.build_case``'s step once, eagerly, on
DTensors whose local shards are ``meta`` tensors (shapes only, nothing
allocated), over a ``"fake"`` process group of the mesh's world size (256
or 512 ranks in one process: collectives move no data).  ``op_analysis``
counts what rank 0 runs.  A record keeps the reference's keys where the
meaning is the same:

  * ``memory.argument_bytes`` / ``output_bytes``: the local shards of the
    step's arguments (params, state, batch, cache) and outputs;
    ``memory.param_bytes`` the params' part;
  * ``memory.peak_bytes``: the most local bytes live at once during the
    step, arguments included (``op_analysis``'s storage liveness), and
    ``memory.temp_bytes``: the peak less the argument and output bytes,
    floored at 0 — where XLA reports its buffer assignment's;
  * ``flops``, ``bytes_accessed`` and ``collectives`` (bytes and counts by
    kind, bytes by mesh axis) from ``op_analysis``;
  * ``roofline``: ``roofline.roofline_report`` on H100 rates.

Compile times are absent, not 0: eager torch compiles nothing.  The step
runs on ``meta`` tensors, not under ``FakeTensorMode``: DTensor's sharding
propagation reads a tensor value for some strided shards, which a fake
tensor refuses.  ``--opt no_remat`` sets ``cfg.remat=False`` (no
activation checkpointing per layer), which raises the peak.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi_6b \\
        --shape train_4k --mesh both --out artifacts/dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from repro_torch import sharding
from repro_torch.config import FLConfig
from repro_torch.configs import CONFIGS, SHAPES, get_config, get_shape
from repro_torch.core import semi_sync
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.op_analysis import analyze, local_bytes
from repro_torch.launch.roofline import roofline_report
from repro_torch.launch.specs import arch_rules, build_case

DEFAULT_OUT = "artifacts/dryrun"

ASSIGNED = [a for a in CONFIGS if a not in ("mnist_dnn", "lenet5",
                                            "char_lstm")]

OPT_LEVERS = ("attn_bf16", "moe_ep", "first_order", "no_remat", "cache_rep",
              "tp_only", "dp_only", "donate")
# the reference's levers that mean nothing for an eager torch step
NO_MEANING = {
    "donate": "eager torch has no buffer donation: a step's outputs are "
              "new tensors",
}

# every param logical axis — blanked out by the dp_only lever
_PARAM_AXES = ("embed", "heads", "kv_heads", "ffn", "experts", "vocab",
               "ssm_inner", "lru", "mla_rank")


def _place(out, pl, mesh):
    """A step's outputs redistributed to their out placements (counted, as
    XLA's out_shardings are part of the compiled step); plain tensors are
    taken as replicated."""
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(out, torch.Tensor):
        if not isinstance(out, DTensor):
            out = DTensor.from_local(out, mesh, (Replicate(),) * mesh.ndim,
                                     run_check=False)
        return out if tuple(out.placements) == tuple(pl) \
            else out.redistribute(mesh, pl)
    leaf = sharding._is_placements(pl)
    if isinstance(out, dict):
        return {k: _place(v, pl if leaf else pl[k], mesh)
                for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        items = [_place(v, pl if leaf else pl[i], mesh)
                 for i, v in enumerate(out)]
        return type(out)(*items) if hasattr(out, "_fields") \
            else type(out)(items)
    return out


def lower(cfg, shape, mesh, *, rules: sharding.AxisRules,
          moe_impl: str = "gather", fl: Optional[FLConfig] = None,
          semi_sync_cohorts: Optional[int] = None, perfed_step: bool = True,
          cache_policy: str = "auto") -> Dict[str, Any]:
    """One case on ``mesh`` (its process group already initialised):
    the record's counted fields."""
    with sharding.use_mesh(mesh, rules):
        case = build_case(cfg, shape, mesh, moe_impl=moe_impl, fl=fl,
                          semi_sync_cohorts=semi_sync_cohorts,
                          perfed_step=perfed_step, rules=rules,
                          cache_policy=cache_policy)
        args = sharding.distribute(case.args, case.in_shardings, mesh)

        def step(*a):
            return _place(case.fn(*a), case.out_shardings, mesh)

        out, counted = analyze(step, args, mesh)
    params = args[0].params if isinstance(
        args[0], (semi_sync.SemiSyncState, semi_sync.TrainState)) else args[0]
    n_devices = 1
    for v in mesh.shape:
        n_devices *= v
    arg_b, out_b = local_bytes(args), local_bytes(out)
    peak = counted.pop("peak_bytes")
    rec = {"name": case.name, "n_devices": n_devices,
           "mesh_shape": sharding.mesh_shape(mesh),
           "memory": {"argument_bytes": arg_b, "output_bytes": out_b,
                      "param_bytes": local_bytes(params),
                      "temp_bytes": max(peak - arg_b - out_b, 0),
                      "peak_bytes": peak},
           **counted}
    rec["roofline"] = roofline_report(rec)
    return rec


def apply_levers(cfg, fl: FLConfig, moe_impl: str, opts: tuple):
    """(cfg, fl, moe_impl) with the levers of ``opts`` that change the
    model or the step (the rule levers apply in ``run_case``)."""
    if "attn_bf16" in opts:
        cfg = dataclasses.replace(cfg, attn_cast_f32=False)
    if "no_remat" in opts:
        cfg = dataclasses.replace(cfg, remat=False)
    if "moe_ep" in opts:
        moe_impl = "ep"
    if "first_order" in opts:
        fl = dataclasses.replace(fl, first_order=True)
    return cfg, fl, moe_impl


def run_case(arch: str, shape_name: str, *, multi_pod: bool,
             moe_impl: str = "gather", perfed_step: bool = True,
             rule_overrides: Optional[Dict[str, Any]] = None,
             opts: tuple = ()) -> Dict[str, Any]:
    cfg, fl, moe_impl = apply_levers(get_config(arch), FLConfig(), moe_impl,
                                     opts)
    shape = get_shape(shape_name)
    t0 = time.time()
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": "multi_pod" if multi_pod else "single_pod",
                           "status": "ok"}
    world = 512 if multi_pod else 256
    try:
        with fake_world(world):
            mesh = make_production_mesh(multi_pod=multi_pod)
            rules = arch_rules(cfg, mesh)
            if "tp_only" in opts:
                # pure tensor parallelism: params replicated over data
                rules = rules.with_overrides(embed=())
            if "dp_only" in opts:
                # pure data parallelism: params fully replicated, batch over
                # every axis
                rules = rules.with_overrides(
                    batch=("pod", "data", "model"),
                    **{a: () for a in _PARAM_AXES})
            if rule_overrides:
                rules = rules.with_overrides(**rule_overrides)
            cohorts = sharding.mesh_shape(mesh).get("pod", 0) \
                if (multi_pod and shape.kind == "train") else None
            rec.update(lower(
                cfg, shape, mesh, rules=rules, moe_impl=moe_impl, fl=fl,
                semi_sync_cohorts=cohorts, perfed_step=perfed_step,
                cache_policy="replicate" if "cache_rep" in opts
                else "auto"))
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 2)
    return rec


def summary(rec: Dict[str, Any]) -> str:
    """One line: per-rank argument bytes, FLOPs, collective bytes by kind
    and the roofline terms."""
    if rec["status"] != "ok":
        return rec.get("error", "")
    coll = rec["collectives"]["bytes_by_kind"]
    kinds = ", ".join(f"{k}: {v:.3e}" for k, v in sorted(coll.items()))
    rf = rec["roofline"]
    mem = rec["memory"]
    return (f"args={mem['argument_bytes'] / 2**30:.2f}GiB "
            f"peak={mem['peak_bytes'] / 2**30:.2f}GiB "
            f"flops={rec['flops']:.3e} "
            f"coll={{{kinds}}} "
            f"compute={rf['compute_s']:.3e}s memory={rf['memory_s']:.3e}s "
            f"collective={rf['collective_s']:.3e}s ({rf['dominant']})")


def main(argv=None):
    ap = argparse.ArgumentParser(description="dry run on fake meshes")
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all' (the 10 of the zoo)")
    ap.add_argument("--shape", default="all",
                    help="shape name or 'all' (4 shapes)")
    ap.add_argument("--mesh", default="single_pod",
                    choices=["single_pod", "multi_pod", "both"])
    ap.add_argument("--moe-impl", default="gather", choices=["gather", "ep"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--opt", action="append", default=[],
                    choices=list(OPT_LEVERS),
                    help="perf levers (repeatable): attn_bf16 moe_ep "
                         "first_order no_remat cache_rep tp_only dp_only")
    args = ap.parse_args(argv)
    for lever in args.opt:
        if lever in NO_MEANING:
            ap.error(f"--opt {lever} has no meaning here: "
                     f"{NO_MEANING[lever]}")

    archs = ASSIGNED if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single_pod": [False], "multi_pod": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    results = []
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                rec = run_case(arch, shape_name, multi_pod=mp,
                               moe_impl=args.moe_impl,
                               opts=tuple(args.opt))
                rec["tag"] = args.tag
                results.append(rec)
                print(f"[{rec['status']:4s}] {arch:22s} {shape_name:12s} "
                      f"{'multi' if mp else 'single':6s} "
                      f"({rec['total_s']:6.1f}s) {summary(rec)}", flush=True)
                fname = os.path.join(
                    args.out,
                    f"{args.tag}_{arch}_{shape_name}_"
                    f"{'multi' if mp else 'single'}.json")
                with open(fname, "w") as f:
                    json.dump(rec, f, indent=1)
    n_ok = sum(r["status"] == "ok" for r in results)
    print(f"\n{n_ok}/{len(results)} cases ran OK")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    sys.exit(main())
