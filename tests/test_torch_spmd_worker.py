"""The ranks of ``tests/test_torch_spmd.py``'s 8-rank gloo run.

Imports torch and the port only (never JAX): the parent process writes the
reference's params and inputs to a directory as ``.npz``, each rank reads
them, runs the port on its mesh, and rank 0 writes the results back for the
parent to hold against the reference.  Nothing here is a test.
"""
import json
import os

import numpy as np
import torch
import torch.distributed as dist

WORLD = 8


def _load(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _semi_sync(out_dir, rank):
    """Two rounds of the fused Eq.-8 semi-sync step on (pod 2, data 2,
    model 2), the state placed by ``state_shardings``."""
    import dataclasses

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

    meta = json.load(open(os.path.join(out_dir, "semi_sync.json")))
    cfg = dataclasses.replace(get_config(meta["arch"]).reduced(
        **meta["reduced"]), dtype="float32")
    exp = ExperimentConfig(model=cfg, fl=FLConfig(**meta["fl"]),
                           train=TrainConfig(grad_clip=0.0))
    model, opt = build_model(cfg), make_optimizer("sgd")
    c = meta["cohorts"]
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    rules = specs.arch_rules(cfg, mesh)
    params = from_numpy_tree(_load(os.path.join(out_dir, "params.npz")),
                             "cpu")
    with sharding.use_mesh(mesh, rules):
        pl = specs.state_shardings(
            semi_sync.init_state(model, None, opt, c, device="meta"),
            sharding.param_placements(params, mesh, rules), mesh)
        state = semi_sync.SemiSyncState(
            params=sharding.distribute(params, pl.params, mesh),
            opt_state=(), buffers=_zero_buffers(params, pl.buffers, c, mesh),
            staleness=sharding.distribute(
                torch.zeros(c, dtype=torch.int32), pl.staleness, mesh),
            step=sharding.distribute(torch.zeros((), dtype=torch.int32),
                                     pl.step, mesh))
        step = semi_sync.make_semi_sync_step(model, exp, opt, c)
        for k, mask in enumerate(meta["masks"]):
            b = _load(os.path.join(out_dir, f"batch{k}.npz"))
            batches = {n: {"tokens": torch.from_numpy(b[f"{n}_tokens"]),
                           "targets": torch.from_numpy(b[f"{n}_targets"])}
                       for n in ("inner", "outer", "hessian")}
            batches = sharding.distribute(
                batches, sharding.placements_for(
                    ("clients", "batch", None), mesh), mesh)
            state, _ = step(state, batches,
                            torch.tensor(mask, dtype=torch.float32))
    local_bytes = sum(x.to_local().numel() * x.to_local().element_size()
                      for x in tree_leaves(state.buffers))
    all_bytes = [None] * WORLD
    dist.all_gather_object(all_bytes, local_bytes)
    full = {p: x.full_tensor().numpy() for p, x in zip(
        tree_paths(state.params), tree_leaves(state.params))}
    bufs = {p: x.full_tensor().numpy() for p, x in zip(
        tree_paths(state.buffers), tree_leaves(state.buffers))}
    placed = {path: [repr(p) for p in x.placements] for path, x in zip(
        tree_paths(state.buffers), tree_leaves(state.buffers))}
    if rank == 0:
        np.savez(os.path.join(out_dir, "got_params.npz"), **full)
        np.savez(os.path.join(out_dir, "got_buffers.npz"), **bufs)
        json.dump({"buffer_bytes": all_bytes,
                   "staleness": state.staleness.full_tensor().tolist(),
                   "step": int(state.step.full_tensor()),
                   "placements": placed},
                  open(os.path.join(out_dir, "semi_sync_out.json"), "w"))


def _zero_buffers(params, placements, c, mesh):
    from repro_torch import sharding
    from repro_torch.utils.tree import tree_map
    return tree_map(lambda p, pl: sharding.zeros(
        (c,) + tuple(p.shape), p.dtype, pl, mesh, "cpu"), params, placements)


def _moe_ep(out_dir, rank):
    """``moe_apply_ep`` on (data 2, model 4) with 8 experts (2 a shard)
    and with 2 (each split into 2 virtual experts)."""
    from repro_torch import sharding
    from repro_torch.config import ModelConfig, MoEConfig
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    from repro_torch.utils.tree import from_numpy_tree

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
    """One rank: join the group through a file store, run both parts."""
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(out_dir, "store"), WORLD)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=WORLD)
    try:
        _semi_sync(out_dir, rank)
        _moe_ep(out_dir, rank)
        dist.barrier()
    finally:
        dist.destroy_process_group()
