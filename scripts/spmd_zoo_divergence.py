#!/usr/bin/env python3
"""Where do a family's mesh-route meta-gradients part from the plain step's?

    PYTHONPATH=src python scripts/spmd_zoo_divergence.py \
        [mixtral_8x22b musicgen_large ...] [--events 12]

``chip_smoke.phase_spmd_zoo`` holds each LM family's reduced f32 step with
DTensor state on a world-1 mesh against the plain step, bitwise except for
``chip_smoke.SPMD_ZOO_REORDERED``.  This script shows why, on the CPU (a
world-1 gloo mesh, one thread, deterministic algorithms), from the phase's
own state (``init_state`` from ``torch.Generator().manual_seed(0)``, the
cross gates drawn as ``chip_smoke._gate_draw`` draws them) and its first
round's batches: it takes cohort 0's meta-gradient pieces (inner gradient,
outer gradient, HVP, meta-gradient: ``mamba2_hvp_bisect.pieces``, the
step's ``autograd`` route) on the mesh and plain, and prints the leaves of
each piece whose bits differ.  Then it records, from the HVP's start, every
op of both runs under a dispatch mode (its autograd node and the bytes of
its floating inputs and outputs) and prints the first mesh-route ops whose
outputs hold bytes the plain run never made while all their inputs hold
bytes it did: the ops that sum the same values in another order, with the
layout of their inputs in both runs.  (A forward op can show here too
where the mesh route computes a value by other ops than the plain step:
``moe_apply_ep`` against ``moe_apply_gather``.)

Imports no JAX.
"""
import argparse
import contextlib
import hashlib
import os
import socket
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _bytes(torch, t):
    if hasattr(t, "to_local"):
        t = t.to_local()
    return hashlib.sha1(t.detach().contiguous().cpu().numpy().tobytes()
                        ).hexdigest()[:16]


def _layout(torch, a):
    if not isinstance(a, torch.Tensor):
        return a
    if hasattr(a, "to_local"):
        return ("DTensor", tuple(a.shape), tuple(a.to_local().stride()),
                str(a.placements))
    return ("Tensor", tuple(a.shape), tuple(a.stride()))


def recorder(torch):
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    def floats(tree):
        return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)
                and t.is_floating_point()]

    class Rec(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.events, self.on = [], False

        def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if self.on:
                node = torch._C._current_autograd_node()
                self.events.append({
                    "op": str(func),
                    "node": node.name() if node else "forward",
                    "next": ([f[0].name() if f[0] else None
                              for f in node.next_functions] if node else []),
                    "ins": [_bytes(torch, t) for t in floats((args, kwargs))],
                    "outs": [_bytes(torch, t) for t in floats(out)],
                    "args": [_layout(torch, a) for a in args]})
            return out
    return Rec()


def run(arch, n_events):
    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    import mamba2_hvp_bisect as hb
    from repro_torch.core import perfed

    mods = cs.import_port()
    mesh = mods.mesh.make_host_mesh(1, 1, pods=1)
    cfg, exp = cs._hold_cfgs(mods, arch, 0.0)
    model = mods.build_model(cfg, moe_impl="ep" if cfg.moe else "gather")
    sgd = mods.make_optimizer("sgd")
    rules = mods.specs.arch_rules(cfg, mesh)
    cohorts = len(cs.ZOO_HOLD_MASKS[0])
    plain = mods.semi_sync.init_state(
        model, torch.Generator().manual_seed(0), sgd, cohorts)
    cs._gate_draw(torch, plain.params, "cpu")
    with mods.sharding.use_mesh(mesh, rules):
        st_mesh = mods.sharding.distribute(
            plain._replace(params=mods.tree_map(torch.clone, plain.params)),
            mods.specs.state_shardings(plain, mods.sharding.param_placements(
                plain.params, mesh, rules), mesh), mesh)
    batch = mods.tree_map(lambda x: x[0], cs._zoo_hold_batches(
        torch, cfg, cohorts, np.random.default_rng(0)))
    hm = types.SimpleNamespace(torch=torch, tree_leaves=mods.tree_leaves,
                               tree_map=mods.tree_map,
                               tree_paths=mods.tree_paths,
                               tree_unflatten=mods.tree_unflatten)

    def loss(p, b):
        return model.loss(p, b)[0]

    def pieces(params, ctx):
        rec = recorder(torch)
        with ctx():
            with rec:
                got = hb.pieces(hm, perfed, loss, params, batch,
                                exp.fl.alpha, True,
                                lambda p: setattr(rec, "on", rec.on
                                                  or p == "hvp"))
        return got, rec.events

    got_p, ev_p = pieces(plain.params, contextlib.nullcontext)
    got_m, ev_m = pieces(st_mesh.params,
                         lambda: mods.sharding.use_mesh(mesh, rules))
    print(f"[{arch}] cohort 0, round 0: leaves whose bits differ, mesh "
          f"route against the plain step:", flush=True)
    for k in hb.PIECES:
        diff = [(path, float((a.to_local() - b).abs().max()))
                for path, a, b in zip(mods.tree_paths(got_p[k]),
                                      mods.tree_leaves(got_m[k]),
                                      mods.tree_leaves(got_p[k]))
                if not cs.same_bits(torch, a.to_local(), b)]
        print(f"    {k}: {len(diff)} {diff}", flush=True)
    seen = set()
    for e in ev_p:
        seen.update(e["ins"])
        seen.update(e["outs"])
    print(f"[{arch}] from the HVP on ({len(ev_p)} ops plain, {len(ev_m)} "
          f"mesh), the first mesh-route ops with new output bytes from "
          f"inputs the plain run also had:", flush=True)
    shown = 0
    for i, e in enumerate(ev_m):
        if not (any(o not in seen for o in e["outs"])
                and all(x in seen for x in e["ins"])):
            continue
        twins = [p for p in ev_p if p["ins"] == e["ins"]
                 and p["op"] == e["op"]]
        print(f"    #{i} {e['op']} node {e['node']} (next {e['next']}) "
              f"args {e['args']}", flush=True)
        for p in twins[:2]:
            print(f"        plain: node {p['node']} args {p['args']}",
                  flush=True)
        shown += 1
        if shown >= n_events:
            break
    dist.barrier()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("archs", nargs="*",
                    default=["mixtral_8x22b", "deepseek_v2_236b",
                             "musicgen_large"])
    ap.add_argument("--events", type=int, default=8)
    args = ap.parse_args(argv)
    import torch
    import torch.distributed as dist
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.set_num_threads(1)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        for arch in args.archs:
            run(arch, args.events)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
