"""The ranks of ``tests/test_torch_spmd.py``'s 8-rank gloo run.

Imports torch and the port only (never JAX): the parent process writes the
reference's params, states and inputs to a directory as ``.npz``, each
rank reads them, runs the port on its mesh, and rank 0 writes the results
back for the parent to hold against the reference.  The parent computes
the reference while the ranks run: each case's inputs are complete once
``<case>.ready`` exists, and the ranks wait for it.  Nothing here is a
test.
"""
import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

WORLD = 8
# the order the ranks take the cases in; the parent writes them in it
FAMILIES = ("mamba2_370m", "recurrentgemma_2b", "mixtral_8x22b",
            "deepseek_v2_236b", "llama32_vision_11b", "musicgen_large")
# mamba2 again with the planted fault
FAULT = "mamba2_370m_fault"
WAIT_S = 900


def _load(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def wait_for(out_dir, case):
    """Block until the parent has written ``case``'s inputs."""
    path = os.path.join(out_dir, f"{case}.ready")
    t0 = time.monotonic()
    while not os.path.exists(path):
        if os.path.exists(os.path.join(out_dir, "abort.ready")):
            raise RuntimeError(f"the parent gave up before writing {case}")
        if time.monotonic() - t0 > WAIT_S:
            raise TimeoutError(f"no inputs for {case} in {WAIT_S} s")
        time.sleep(0.05)


def top_gap(router, xf, k):
    """Smallest gap between a token's k-th and (k+1)-th router probability
    (float64, from the same f32 inputs).  Here, where no JAX is imported,
    for ``test_torch_moe`` too."""
    logits = np.asarray(xf, np.float64) @ np.asarray(router, np.float64)
    full = np.exp(logits - logits.max(-1, keepdims=True))
    full /= full.sum(-1, keepdims=True)
    srt = -np.sort(-full, axis=-1)
    return float((srt[:, k - 1] - srt[:, k]).min())


class _RouteGaps:
    """Within the block, records ``top_gap`` of every routing the port
    runs (on DTensors: of the whole routed batch, gathered)."""

    def __init__(self):
        self.gaps = []

    def __enter__(self):
        from repro_torch.models import layers as L
        self._route = route = L._route

        def recording(params, xf, e):
            r, x = (t.detach() for t in (params["router"], xf))
            r, x = (t.full_tensor() if hasattr(t, "full_tensor") else t
                    for t in (r, x))
            self.gaps.append(top_gap(r.numpy(), x.numpy(),
                                     e.experts_per_token))
            return route(params, xf, e)

        L._route = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.models import layers as L
        L._route = self._route


class _UnsummedScanGrads:
    """The planted fault: within the block, the gradients ``_scan_shards``
    takes over ``model`` stay unsummed (each rank keeps the b and c
    gradients of its own heads only)."""

    def __enter__(self):
        from repro_torch import sharding
        self._summed = summed = sharding.summed
        sharding.summed = lambda pl, axes, mesh: summed(
            pl, tuple(a for a in axes if a != "model"), mesh)
        return self

    def __exit__(self, *exc):
        from repro_torch import sharding
        sharding.summed = self._summed


def _placed_batches(batches, mesh):
    """Each leaf [C, B, ...] with the cohorts on pod and the batch rows on
    data, as ``specs.train_batch_specs`` places them."""
    from repro_torch import sharding
    from repro_torch.utils.tree import tree_map
    return tree_map(lambda x: sharding.distribute(
        x, sharding.placements_for(("clients", "batch")
                                   + (None,) * (x.ndim - 2), mesh), mesh),
        batches)


def _round_batches(out_dir, case, k):
    b = _load(os.path.join(out_dir, f"{case}_batch{k}.npz"))
    return {n: {f: torch.from_numpy(b[f"{n}_{f}"])
                for f in ("tokens", "targets")}
            for n in ("inner", "outer", "hessian")}


def _semi_sync(out_dir, rank, case):
    """``case``'s fused Eq.-8 rounds on (pod 2, data 2, model 2) from the
    state the parent wrote, placed by ``state_shardings``; rank 0 writes
    the state after them, each rank's buffer bytes, the buffers'
    placements and (MoE) every routing's top-k gap."""
    from repro_torch import sharding
    from repro_torch.config import ExperimentConfig, FLConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.core import semi_sync
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.utils.tree import from_numpy_tree, tree_leaves, \
        tree_paths

    wait_for(out_dir, case)
    meta = json.load(open(os.path.join(out_dir, f"{case}.json")))
    cfg = dataclasses.replace(get_config(meta["arch"]).reduced(
        **meta["reduced"]), dtype="float32")
    exp = ExperimentConfig(model=cfg, fl=FLConfig(**meta["fl"]),
                           train=TrainConfig(grad_clip=0.0))
    model = build_model(cfg, moe_impl=meta["moe_impl"])
    opt = make_optimizer("sgd")
    c = meta["cohorts"]
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    rules = specs.arch_rules(cfg, mesh)
    saved = _load(os.path.join(out_dir, f"{meta['inputs']}_state.npz"))
    tree = from_numpy_tree({k: v for k, v in saved.items() if "/" in k},
                           "cpu")
    plain = semi_sync.SemiSyncState(
        params=tree["params"], opt_state=opt.init(tree["params"]),
        buffers=tree["buffers"],
        staleness=torch.from_numpy(saved["staleness"]),
        step=torch.from_numpy(saved["step"]))
    gaps = _RouteGaps()
    with sharding.use_mesh(mesh, rules), gaps:
        state = sharding.distribute(plain, specs.state_shardings(
            plain, sharding.param_placements(plain.params, mesh, rules),
            mesh), mesh)
        step = semi_sync.make_semi_sync_step(model, exp, opt, c)
        for k, mask in zip(meta["rounds"], meta["masks"]):
            state, _ = step(state, _placed_batches(
                _round_batches(out_dir, meta["inputs"], k), mesh),
                torch.tensor(mask, dtype=torch.float32))
    local_bytes = sum(x.to_local().numel() * x.to_local().element_size()
                      for x in tree_leaves(state.buffers))
    all_bytes = [None] * WORLD
    dist.all_gather_object(all_bytes, local_bytes)
    all_gaps = [None] * WORLD
    dist.all_gather_object(all_gaps, gaps.gaps)
    full = {f"{name}/{p}": x.full_tensor().numpy()
            for name, t in (("params", state.params),
                            ("buffers", state.buffers))
            for p, x in zip(tree_paths(t), tree_leaves(t))}
    placed = {path: [repr(p) for p in x.placements] for path, x in zip(
        tree_paths(state.buffers), tree_leaves(state.buffers))}
    if rank == 0:
        np.savez(os.path.join(out_dir, f"{case}_got.npz"), **full)
        json.dump({"buffer_bytes": all_bytes,
                   "staleness": state.staleness.full_tensor().tolist(),
                   "step": int(state.step.full_tensor()),
                   "placements": placed,
                   "route_gaps": [g for r in all_gaps for g in r]},
                  open(os.path.join(out_dir, f"{case}_out.json"), "w"))


def _server_adam(out_dir, rank):
    """One server-Adam round with clipping on (pod 2, data 2, model 2) from
    the reference's state after round 0; each rank also notes the norm of
    its own local shards of the aggregate."""
    from repro_torch import sharding
    from repro_torch.config import ExperimentConfig, FLConfig, TrainConfig
    from repro_torch.configs import get_config
    from repro_torch.core import semi_sync
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.utils.tree import (from_numpy_tree, tree_leaves,
                                        tree_map, tree_norm, tree_paths)

    wait_for(out_dir, "adam")
    meta = json.load(open(os.path.join(out_dir, "adam.json")))
    cfg = dataclasses.replace(get_config(meta["arch"]).reduced(
        **meta["reduced"]), dtype="float32")
    exp = ExperimentConfig(model=cfg, fl=FLConfig(**meta["fl"]),
                           train=TrainConfig(grad_clip=meta["adam_clip"]))
    model, opt = build_model(cfg), make_optimizer("adam")
    c = meta["cohorts"]
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    rules = specs.arch_rules(cfg, mesh)
    saved = _load(os.path.join(out_dir, "adam_state.npz"))
    tree = from_numpy_tree({k: v for k, v in saved.items()
                            if "/" in k}, "cpu")
    plain = semi_sync.SemiSyncState(
        params=tree["params"], opt_state=opt.init(tree["params"]),
        buffers=tree["buffers"],
        staleness=torch.from_numpy(saved["staleness"]),
        step=torch.from_numpy(saved["step"]))
    with sharding.use_mesh(mesh, rules):
        pl = specs.state_shardings(plain, sharding.param_placements(
            plain.params, mesh, rules), mesh)
        state = sharding.distribute(plain, pl, mesh)
        mask = torch.tensor(meta["mask"], dtype=torch.float32)
        agg = semi_sync._masked_aggregate_mesh(state.params, state.buffers,
                                               mask)
        local_norm = float(tree_norm(tree_map(lambda x: x.to_local(),
                                              agg)))
        batches = _placed_batches(_round_batches(out_dir, meta["inputs"],
                                                 1), mesh)
        step = semi_sync.make_semi_sync_step(model, exp, opt, c)
        state, metrics = step(state, batches, mask)
    norms = [None] * WORLD
    dist.all_gather_object(norms, local_norm)
    full = {f"{name}/{p}": x.full_tensor().numpy()
            for name, t in (("params", state.params),
                            ("m", state.opt_state["m"]),
                            ("v", state.opt_state["v"]))
            for p, x in zip(tree_paths(t), tree_leaves(t))}
    if rank == 0:
        np.savez(os.path.join(out_dir, "got_adam.npz"), **full)
        json.dump({"grad_norm": float(metrics["grad_norm"].full_tensor()),
                   "local_norms": norms,
                   "t": int(state.opt_state["t"].full_tensor()),
                   "staleness": state.staleness.full_tensor().tolist()},
                  open(os.path.join(out_dir, "adam_out.json"), "w"))


def _moe_ep(out_dir, rank):
    """``moe_apply_ep`` on (data 2, model 4) with 8 experts (2 a shard)
    and with 2 (each split into 2 virtual experts)."""
    from repro_torch import sharding
    from repro_torch.config import ModelConfig, MoEConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.utils.tree import from_numpy_tree

    wait_for(out_dir, "moe")
    mesh = make_mesh((2, 4), ("data", "model"))
    res = {}
    for n_experts in (8, 2):
        cfg = ModelConfig(name="moe-ep-test", family="moe", num_layers=2,
                          d_model=32, num_heads=4, num_kv_heads=4, d_ff=64,
                          vocab_size=128, dtype="float32",
                          moe=MoEConfig(num_experts=n_experts,
                                        experts_per_token=2, expert_d_ff=64,
                                        capacity_factor=8.0))
        inp = _load(os.path.join(out_dir, f"moe{n_experts}.npz"))
        params = from_numpy_tree({k: v for k, v in inp.items() if k != "x"},
                                 "cpu")
        rules = sharding.AxisRules()
        if n_experts % 4:
            rules = rules.with_overrides(experts=())   # as arch_rules does
        with sharding.use_mesh(mesh, rules):
            ps = sharding.param_shardings(params, mesh, rules)
            xs = sharding.distribute(torch.from_numpy(inp["x"]),
                                     sharding.placements_for(
                                         ("batch", None, None), mesh), mesh)
            out, aux = L.moe_apply_ep(ps, xs, cfg)
            res[n_experts] = (out.full_tensor().numpy(),
                              float(aux.full_tensor()))
    if rank == 0:
        np.savez(os.path.join(out_dir, "got_moe.npz"),
                 **{f"out{n}": o for n, (o, _) in res.items()},
                 **{f"aux{n}": np.float64(a) for n, (_, a) in res.items()})


def run(rank, out_dir):
    """One rank: join the group through a file store, run every case."""
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out_dir, "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    try:
        _semi_sync(out_dir, rank, "yi_6b")
        _moe_ep(out_dir, rank)
        _server_adam(out_dir, rank)
        for arch in FAMILIES:
            _semi_sync(out_dir, rank, arch)
        with _UnsummedScanGrads():
            _semi_sync(out_dir, rank, FAULT)
        dist.barrier()
    finally:
        dist.destroy_process_group()
