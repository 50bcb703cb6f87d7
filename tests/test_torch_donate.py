"""Donated state: the port's counterpart of the reference's
``donate_argnums``, on the CPU.

* ``make_semi_sync_step(..., donate=True)`` on reduced yi-6b and mamba2
  (float32), through the fused Eq.-8, clipped-SGD and server-Adam routes,
  for 2 rounds from the same state as the undonated step: the state and
  metrics it returns are the undonated step's bit for bit, and every
  tensor it returns is the argument's own (the same ``data_ptr``).
* The bytes the donated step returns in place equal what the reference's
  donated compile aliases (``alias_size_in_bytes`` of
  ``jax.jit(step, donate_argnums=(0,))`` on reduced yi-6b, fused Eq. 8:
  XLA aliases every leaf of the state), and its params after 2 rounds sit
  within 1e-5·(1 + max|p|) of that compiled step's.  (The other routes'
  parity with the reference follows from their bitwise identity with the
  undonated step, which ``tests/test_torch_semi_sync.py`` holds.)
* ``make_train_step(..., donate=True)``, PerFed and plain, with SGD,
  momentum and Adam: bitwise the undonated step, in place.
* On a one-rank gloo mesh, the donated step on DTensor state (fused
  Eq. 8): bitwise the undonated step, each DTensor's local shard the
  argument's, placements unchanged.
* The dry run: ``--opt donate`` reaches ``lower(donate=True)``; on the
  reduced multi-pod semi-sync case the donated step's outputs alias its
  arguments and its peak is lower by the params' bytes (the undonated
  step holds the new params beside the old through the refresh); an
  undonated decode case copies the cache, so its peak is higher than the
  donated one's by the cache's bytes.  Each case runs once undonated and
  once donated, whichever runs first in the process: ``op_analysis``
  counts no fake tensor of DTensor's sharding propagation
  (``tests/test_torch_dryrun.py`` holds a fresh process's first case to
  the same peak as its second).
* The kernel wrappers' in-place forms on the CPU (their plain versions
  written with ``copy_``): bitwise the out-of-place results, in the
  arguments' storage.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map as pytree_map

from repro.core import semi_sync as ref_semi_sync
from repro_torch.config import FLConfig, ShapeConfig, TrainConfig
from repro_torch.configs import get_config
from repro_torch.core import semi_sync
from repro_torch.kernels import fused_adam, stale_aggregate
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.launch.op_analysis import local_bytes
from repro_torch.launch.specs import arch_rules
from repro_torch.optim import make_optimizer
from repro_torch.utils.tree import tree_leaves, tree_map
from test_torch_semi_sync import (MASKS, N_COHORTS, _mnist_batches,
                                  _small_setup, assert_params_close,
                                  carry_state, lm_batches, one_thread, pair)

ROUTES = {"fused": (0.0, "sgd"), "clipped": (1.0, "sgd"),
          "adam": (1.0, "adam")}


def leaves(tree):
    """Tensor leaves of a state (named tuples, tuples, dicts in sorted key
    order, as ``tree_leaves``)."""
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def local(x):
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def copy(x):
    """A copy of ``x`` laid out as it is (a DTensor's local shard cloned)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x.clone()
    return DTensor.from_local(x.to_local().clone(), x.device_mesh,
                              x.placements, run_check=False, shape=x.shape,
                              stride=x.stride())


def assert_bitwise_in_place(got, want, donated, ptrs):
    """``got`` (a donated step's result) is ``donated`` itself, every leaf
    still at its own address, and holds ``want``'s bits."""
    assert got is donated
    assert [local(x).data_ptr() for x in leaves(got)] == ptrs
    for x, y in zip(leaves(got), leaves(want)):
        x, y = local(x), local(y)
        assert x.dtype == y.dtype and torch.equal(x, y)


def held_rounds(step, dstep, state, draw, masks=MASKS[:2]):
    """Run ``step`` from ``state`` and ``dstep`` (donated) from a copy of
    it, round by round, holding each donated round against the undonated
    one.  Returns the donated state."""
    donated = pytree_map(copy, state)
    ptrs = [local(x).data_ptr() for x in leaves(donated)]
    for mask in masks:
        batches, m = draw(), torch.tensor(mask, dtype=torch.float32)
        state, metrics = step(state, batches, m)
        out, d_metrics = dstep(donated, batches, m)
        assert_bitwise_in_place(out, state, donated, ptrs)
        for k in metrics:
            assert torch.equal(metrics[k], d_metrics[k])
    return donated


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("arch", ["yi_6b", "mamba2_370m"])
def test_donated_semi_sync_step_is_the_undonated_step_in_place(arch, route):
    grad_clip, opt_name = ROUTES[route]
    _, (model, cfg, opt) = pair(arch, grad_clip, opt_name)
    assert semi_sync.uses_fused_eq8(opt, cfg) == (route == "fused")
    step = semi_sync.make_semi_sync_step(model, cfg, opt, N_COHORTS)
    dstep = semi_sync.make_semi_sync_step(model, cfg, opt, N_COHORTS,
                                          donate=True)
    state = semi_sync.init_state(model, torch.Generator().manual_seed(0),
                                 opt, N_COHORTS, device="cpu")
    rng = np.random.default_rng(0)
    with one_thread():
        held_rounds(step, dstep, state, lambda: tree_map(
            torch.from_numpy, lm_batches(rng, model.cfg.vocab_size, b=1,
                                         seq=8)))


def test_donated_step_aliases_what_the_reference_donation_aliases():
    (ref, ref_cfg, ref_opt), (model, cfg, opt) = pair("yi_6b", 0.0, "sgd")
    with jax.threefry_partitionable(False):
        ref_state = ref_semi_sync.init_state(ref, jax.random.PRNGKey(0),
                                             ref_opt, N_COHORTS)
    state = carry_state(ref_state, opt)
    rng = np.random.default_rng(0)
    draws = [lm_batches(rng, ref.cfg.vocab_size, b=1, seq=8)
             for _ in range(2)]
    ref_step = jax.jit(ref_semi_sync.make_semi_sync_step(
        ref, ref_cfg, ref_opt, N_COHORTS), donate_argnums=(0,)).lower(
        ref_state, draws[0], jnp.asarray(MASKS[0], jnp.float32),
        jax.random.PRNGKey(0)).compile()
    aliased = ref_step.memory_analysis().alias_size_in_bytes
    assert aliased == sum(x.nbytes for x in jax.tree.leaves(ref_state))

    dstep = semi_sync.make_semi_sync_step(model, cfg, opt, N_COHORTS,
                                          donate=True)
    before = {x.data_ptr(): x.numel() * x.element_size()
              for x in leaves(state)}
    for k, batches in enumerate(draws):
        m = np.asarray(MASKS[k], np.float32)
        ref_state, _ = ref_step(ref_state, batches, jnp.asarray(m),
                                jax.random.PRNGKey(k))
        with one_thread():
            state, _ = dstep(state, tree_map(torch.from_numpy, batches),
                             torch.from_numpy(m))
    in_place = sum(before.get(x.data_ptr(), 0) for x in leaves(state))
    assert in_place == aliased
    assert_params_close(state.params, ref_state.params)


@pytest.mark.parametrize("opt_name", ["sgd", "momentum", "adam"])
@pytest.mark.parametrize("perfed_step", [True, False],
                         ids=["perfed", "plain"])
def test_donated_train_step_is_the_undonated_step_in_place(perfed_step,
                                                          opt_name):
    cfg, model, _ = _small_setup()
    cfg = dataclasses.replace(cfg, train=TrainConfig(grad_clip=1.0))
    opt = make_optimizer(opt_name)
    step = semi_sync.make_train_step(model, cfg, opt,
                                     perfed_step=perfed_step)
    dstep = semi_sync.make_train_step(model, cfg, opt,
                                      perfed_step=perfed_step, donate=True)
    state = semi_sync.init_train_state(
        model, torch.Generator().manual_seed(0), opt)
    donated = pytree_map(copy, state)
    ptrs = [x.data_ptr() for x in leaves(donated)]
    for k in range(2):
        batches = tree_map(lambda x: x[0], _mnist_batches(k, 1))
        state, metrics = step(state, batches)
        out, d_metrics = dstep(donated, batches)
        assert_bitwise_in_place(out, state, donated, ptrs)
        for key in metrics:
            assert torch.equal(metrics[key], d_metrics[key])
    assert int(donated.step) == 2


@contextlib.contextmanager
def gloo_world():
    """A one-rank gloo group and its (pod 1, data 1, model 1) mesh."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_host_mesh(1, 1, pods=1)
    finally:
        dist.destroy_process_group()


def test_donated_mesh_step_is_the_undonated_step_in_place():
    """Reduced mamba2 on DTensor state through the fused Eq.-8 route (the
    mesh's server-Adam route runs donated in ``chip_smoke.py``), one round
    from buffers drawn at random (a round on DTensors costs seconds on
    the CPU)."""
    from repro_torch import sharding
    with gloo_world() as mesh, one_thread():
        for route in ("fused",):
            grad_clip, opt_name = ROUTES[route]
            _, (model, cfg, opt) = pair("mamba2_370m", grad_clip, opt_name)
            step = semi_sync.make_semi_sync_step(model, cfg, opt, N_COHORTS)
            dstep = semi_sync.make_semi_sync_step(model, cfg, opt, N_COHORTS,
                                                  donate=True)
            rng = np.random.default_rng(0)
            rules = arch_rules(model.cfg, mesh)
            with sharding.use_mesh(mesh, rules):
                gen = torch.Generator().manual_seed(0)
                state = semi_sync.init_state(model, gen, opt, N_COHORTS,
                                             device="cpu", mesh=mesh,
                                             rules=rules)
                for b in leaves(state.buffers):
                    b.to_local().copy_(1e-2 * torch.randn(
                        b.to_local().shape, generator=gen))
                # batch 2: DTensor cannot view away a sharded batch dim of 1
                out = held_rounds(step, dstep, state, lambda: tree_map(
                    torch.from_numpy, lm_batches(rng, model.cfg.vocab_size,
                                                 b=2, seq=8)),
                    masks=MASKS[1:2])
            assert [x.placements for x in leaves(out)] == \
                [x.placements for x in leaves(state)]


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

SHAPES = {"train": ShapeConfig("t", seq_len=64, global_batch=8, kind="train"),
          "decode": ShapeConfig("d", seq_len=128, global_batch=8,
                                kind="decode")}


def dry_records(kind, dims, **kw):
    """The reduced yi-6b case run on 8 fake ranks undonated, then
    donated."""
    cfg = get_config("yi_6b").reduced()
    out = {}
    for donate in (False, True):
        with fake_world(8):
            mesh = make_mesh(*dims)
            out[donate] = dryrun.lower(cfg, SHAPES[kind], mesh,
                                       rules=arch_rules(cfg, mesh),
                                       donate=donate, **kw)["memory"]
    return out[False], out[True]


def test_dry_run_donated_train_case_holds_one_state():
    """The multi-pod semi-sync case (first-order meta-gradients, to keep
    the run short): donated, every output but the three f32 metrics
    aliases an argument, and the peak is lower by the params' bytes."""
    und, don = dry_records("train", ((2, 2, 2), ("pod", "data", "model")),
                           semi_sync_cohorts=2,
                           fl=FLConfig(first_order=True))
    assert und["alias_bytes"] == 0
    assert don["alias_bytes"] == don["output_bytes"] - 3 * 4
    assert und["peak_bytes"] - don["peak_bytes"] >= don["param_bytes"]
    for mem in (und, don):
        assert mem["temp_bytes"] == max(
            mem["peak_bytes"] - mem["argument_bytes"]
            - (mem["output_bytes"] - mem["alias_bytes"]), 0)


def test_dry_run_undonated_decode_copies_the_cache():
    cfg = get_config("yi_6b").reduced()
    with fake_world(8):
        mesh = make_mesh((2, 4), ("data", "model"))
        from repro_torch.launch.specs import build_case
        case = build_case(cfg, SHAPES["decode"], mesh,
                          rules=arch_rules(cfg, mesh))
        from repro_torch import sharding
        cache = sharding.distribute(case.args[1], case.in_shardings[1], mesh)
        cache_bytes = local_bytes(cache)
    und, don = dry_records("decode", ((2, 4), ("data", "model")))
    assert und["alias_bytes"] == 0
    assert don["alias_bytes"] == cache_bytes
    assert und["peak_bytes"] - don["peak_bytes"] == cache_bytes


def test_cli_accepts_donate_and_run_case_donates(monkeypatch, tmp_path):
    seen = []

    def stub(arch, shape, *, multi_pod, moe_impl, opts):
        seen.append(opts)
        return {"status": "fail", "error": "stub", "total_s": 0.0}

    monkeypatch.setattr(dryrun, "run_case", stub)
    dryrun.main(["--arch", "yi_6b", "--shape", "train_4k", "--opt",
                 "donate", "--out", str(tmp_path)])
    assert seen == [("donate",)]
    monkeypatch.undo()

    calls = []

    def lower(*a, **kw):
        calls.append(kw["donate"])
        return {}

    monkeypatch.setattr(dryrun, "lower", lower)
    monkeypatch.setattr(dryrun, "fake_world",
                        lambda n: contextlib.nullcontext())
    monkeypatch.setattr(dryrun, "make_production_mesh", lambda **kw: None)
    monkeypatch.setattr(dryrun, "arch_rules", lambda cfg, mesh: None)
    for opts in ((), ("donate",)):
        assert dryrun.run_case("yi_6b", "train_4k", multi_pod=False,
                               opts=opts)["status"] == "ok"
    assert calls == [False, True]


# ---------------------------------------------------------------------------
# the kernel wrappers' in-place forms, on the CPU
# ---------------------------------------------------------------------------

def _rand(rng, *shape, dtype=torch.float32):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        dtype)


def test_in_place_kernel_wrappers_are_the_out_of_place_results():
    rng = np.random.default_rng(0)
    # Eq. 8, flat and on a mixed bf16/f32 tree
    p, buf = _rand(rng, 1001), _rand(rng, 4, 1001)
    mask = torch.tensor([1.0, 0.0, 0.5, 1.0])
    want = stale_aggregate.stale_aggregate_flat(p, buf, mask, beta=0.3)
    ptr = p.data_ptr()
    got = stale_aggregate.stale_aggregate_flat(p, buf, mask, beta=0.3,
                                               inplace=True)
    assert got is p and p.data_ptr() == ptr and torch.equal(got, want)

    tree = {"w": _rand(rng, 7, 5, dtype=torch.bfloat16), "b": _rand(rng, 5),
            "n": {"g": _rand(rng, 3)}}
    bank = tree_map(lambda x: torch.stack([_rand(rng, *x.shape).to(x.dtype)
                                           for _ in range(4)]), tree)
    want = stale_aggregate.stale_aggregate_tree(tree, bank, mask, beta=0.3)
    ptrs = [x.data_ptr() for x in leaves(tree)]
    got = stale_aggregate.stale_aggregate_tree(tree, bank, mask, beta=0.3,
                                               inplace=True)
    assert got is tree and [x.data_ptr() for x in leaves(tree)] == ptrs
    for x, y in zip(leaves(got), leaves(want)):
        assert x.dtype == y.dtype and torch.equal(x, y)

    # fused Adam, a flat leaf and a tree
    def adam_state():
        g = {"w": _rand(rng, 6, 4, dtype=torch.bfloat16), "b": _rand(rng, 9)}
        return (tree_map(lambda x: x.clone(), g),
                tree_map(lambda x: _rand(rng, *x.shape) * 1e-3, g),
                tree_map(lambda x: _rand(rng, *x.shape).square() * 1e-4, g),
                tree_map(lambda x: _rand(rng, *x.shape) * 1e-2, g))

    params, m, v, grads = adam_state()
    want = fused_adam.fused_adam_tree(params, m, v, grads, lr=1e-3, t=3)
    ptrs = [x.data_ptr() for x in leaves((params, m, v))]
    got = fused_adam.fused_adam_tree(params, m, v, grads, lr=1e-3, t=3,
                                     inplace=True)
    assert got[0] is params and got[1] is m and got[2] is v
    assert [x.data_ptr() for x in leaves(got)] == ptrs
    for x, y in zip(leaves(got), leaves(want)):
        assert x.dtype == y.dtype and torch.equal(x, y)
    p, mi, vi, g = (x["b"] for x in adam_state())
    want = fused_adam.fused_adam_flat(p, mi, vi, g, lr=1e-3, t=3)
    got = fused_adam.fused_adam_flat(p, mi, vi, g, lr=1e-3, t=3,
                                     inplace=True)
    assert got[0] is p and got[1] is mi and got[2] is vi
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    # in place, a leaf's flat view must be the leaf's own storage
    params, m, v, grads = adam_state()
    with pytest.raises(ValueError, match="contiguous"):
        fused_adam.fused_adam_tree({"w": params["w"].t()}, {"w": m["w"].t()},
                                   {"w": v["w"].t()}, {"w": grads["w"].t()},
                                   lr=1e-3, t=1, inplace=True)
