"""The port's SPMD layer on 8 gloo ranks against the JAX reference's
single-device math.

One ``torch.multiprocessing.spawn`` of 8 ranks (``test_torch_spmd_worker``,
which imports no JAX), joined through a ``FileStore`` in ``tmp_path`` (no
port to race over between test workers).  The parent writes the
reference's params and the inputs, the ranks write their results back:

* two rounds of the fused Eq.-8 semi-synchronous step on a reduced yi-6b
  (f32), 2 cohorts on (pod 2, data 2, model 2), the state placed by
  ``state_shardings``, against the reference's ``make_semi_sync_step`` on
  one device.  Params and buffers within rtol 1e-4 of each leaf's scale:
  the mesh splits the sums of the forward and backward matmuls over 2–4
  ranks and the cross-entropy over the vocab, which reassociates f32 sums
  (the plain port holds 1e-5; the meta-gradient's second-order terms
  amplify the differences); staleness and step bitwise.  Each rank's
  buffer bytes equal the sharded size (C/2 cohorts, each leaf split as its
  param), and the buffers keep ``state_shardings``' placements;
* one round of the server Adam with clipping on the same mesh, from the
  reference's state after round 0 (its buffers filled) with fresh Adam
  moments, against the reference's step with ``make_optimizer("adam")``
  on one device: params within 1e-5 of each leaf's scale, m and v within
  rtol 1e-5 (the tolerance of ``tests/test_torch_semi_sync.py``'s
  server-Adam round: the masked mean is elementwise, so only the norm's
  all-reduce reassociates a sum).  The clip norm must be the reference's
  global one, though every rank's local shards of the aggregate have a
  smaller norm and the ranks' local norms differ;
* ``moe_apply_ep`` on (data 2, model 4) with 8 experts (2 a shard) and
  with 2 (4 virtual experts of half the FFN width) against the
  reference's ``moe_apply_gather``: outputs within 1e-4, aux within 1e-5
  (the reference's own EP test's limits, ``tests/test_moe_ep.py``).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch.multiprocessing as mp

import test_torch_spmd_worker as worker
from repro import sharding as ref_sharding
from repro.config import ExperimentConfig as RefExperimentConfig
from repro.config import FLConfig as RefFLConfig
from repro.config import ModelConfig as RefModelConfig
from repro.config import MoEConfig as RefMoEConfig
from repro.config import TrainConfig as RefTrainConfig
from repro.configs import get_config as ref_get_config
from repro.core import semi_sync as ref_semi_sync
from repro.models import build_model as ref_build_model
from repro.models import layers as RL
from repro.optim import make_optimizer as ref_make_optimizer

ARCH = "yi_6b"
REDUCED = dict(max_d_model=64, vocab=128)
FL = dict(alpha=0.02, beta=0.1, staleness_bound=1, algorithm="perfed")
MASKS = [[1.0, 1.0], [1.0, 0.0]]
COHORTS, BATCH, SEQ = 2, 4, 16
STATE_RTOL = 1e-4
EP_ATOL, AUX_ATOL = 1e-4, 1e-5
ADAM_CLIP = 0.05          # well under the aggregate's norm: the clip acts
ADAM_RTOL = 1e-5


def _flat(tree):
    return {ref_sharding._path_str(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _reference_semi_sync(out_dir):
    """Write the reference's initial params and each round's batches;
    return its state after the rounds."""
    cfg = dataclasses.replace(ref_get_config(ARCH).reduced(**REDUCED),
                              dtype="float32")
    model = ref_build_model(cfg)
    exp = RefExperimentConfig(model=cfg, fl=RefFLConfig(**FL),
                              train=RefTrainConfig(grad_clip=0.0))
    opt = ref_make_optimizer("sgd")
    with jax.threefry_partitionable(False):
        state = ref_semi_sync.init_state(model, jax.random.PRNGKey(0), opt,
                                         COHORTS)
    np.savez(os.path.join(out_dir, "params.npz"), **_flat(state.params))
    json.dump({"arch": ARCH, "reduced": REDUCED, "fl": FL,
               "cohorts": COHORTS, "masks": MASKS, "adam_clip": ADAM_CLIP},
              open(os.path.join(out_dir, "semi_sync.json"), "w"))
    step = jax.jit(ref_semi_sync.make_semi_sync_step(model, exp, opt,
                                                     COHORTS))
    rng = np.random.default_rng(0)
    after = []
    for k, mask in enumerate(MASKS):
        batch = {}
        for n in ("inner", "outer", "hessian"):
            t = rng.integers(0, cfg.vocab_size,
                             size=(COHORTS, BATCH, SEQ + 1)).astype(np.int32)
            batch[n] = {"tokens": t[..., :-1], "targets": t[..., 1:]}
        np.savez(os.path.join(out_dir, f"batch{k}.npz"),
                 **{f"{n}_{f}": batch[n][f] for n in batch
                    for f in ("tokens", "targets")})
        state, _ = step(state, batch, jnp.asarray(mask, jnp.float32),
                        jax.random.PRNGKey(k))
        after.append(state)
    return state, after[0]


def _reference_server_adam(out_dir, state0):
    """Write the state after round 0; return the reference's state and
    metrics after one server-Adam round (with clipping) from it, on round
    1's batch and mask."""
    cfg = dataclasses.replace(ref_get_config(ARCH).reduced(**REDUCED),
                              dtype="float32")
    model = ref_build_model(cfg)
    exp = RefExperimentConfig(model=cfg, fl=RefFLConfig(**FL),
                              train=RefTrainConfig(grad_clip=ADAM_CLIP))
    opt = ref_make_optimizer("adam")
    state = state0._replace(opt_state=opt.init(state0.params))
    np.savez(os.path.join(out_dir, "adam_state.npz"),
             **{f"params/{k}": v for k, v in _flat(state.params).items()},
             **{f"buffers/{k}": v for k, v in _flat(state.buffers).items()},
             staleness=np.asarray(state.staleness),
             step=np.asarray(state.step))
    with np.load(os.path.join(out_dir, "batch1.npz")) as f:
        batch = {n: {k: jnp.asarray(f[f"{n}_{k}"])
                     for k in ("tokens", "targets")}
                 for n in ("inner", "outer", "hessian")}
    step = jax.jit(ref_semi_sync.make_semi_sync_step(model, exp, opt,
                                                     COHORTS))
    return step(state, batch, jnp.asarray(MASKS[1], jnp.float32),
                jax.random.PRNGKey(1))


def _reference_moe(out_dir):
    """Write each MoE case's params and input; return the gather MoE's
    (output, aux) per expert count."""
    want = {}
    for n_experts in (8, 2):
        cfg = RefModelConfig(
            name="moe-ep-test", family="moe", num_layers=2, d_model=32,
            num_heads=4, num_kv_heads=4, d_ff=64, vocab_size=128,
            dtype="float32",
            moe=RefMoEConfig(num_experts=n_experts, experts_per_token=2,
                             expert_d_ff=64, capacity_factor=8.0))
        rng = jax.random.PRNGKey(0)
        p = RL.moe_init(rng, cfg)
        x = jax.random.normal(jax.random.fold_in(rng, 1), (4, 16, 32))
        np.savez(os.path.join(out_dir, f"moe{n_experts}.npz"), x=np.asarray(x),
                 **_flat(p))
        out, aux = RL.moe_apply_gather(p, x, cfg)
        want[n_experts] = (np.asarray(out), float(aux))
    return want


def _close(got, want, what):
    scale = 1.0 + float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= STATE_RTOL * scale, (what, err, scale)


def test_semi_sync_and_expert_parallel_on_eight_ranks(tmp_path):
    out_dir = str(tmp_path)
    ref_state, ref_state0 = _reference_semi_sync(out_dir)
    ref_adam, ref_adam_metrics = _reference_server_adam(out_dir, ref_state0)
    ref_moe = _reference_moe(out_dir)
    mp.spawn(worker.run, args=(out_dir,), nprocs=worker.WORLD, join=True)

    got = json.load(open(os.path.join(out_dir, "semi_sync_out.json")))
    with np.load(os.path.join(out_dir, "got_params.npz")) as f:
        got_params = {k: f[k] for k in f.files}
    with np.load(os.path.join(out_dir, "got_buffers.npz")) as f:
        got_buffers = {k: f[k] for k in f.files}
    want_params, want_buffers = (_flat(ref_state.params),
                                 _flat(ref_state.buffers))
    assert sorted(got_params) == sorted(want_params)
    for k in want_params:
        _close(got_params[k], want_params[k], k)
    moved = any(float(np.abs(v).max()) > 0 for v in want_buffers.values())
    assert moved
    for k in want_buffers:
        _close(got_buffers[k], want_buffers[k], k)
    assert got["staleness"] == np.asarray(ref_state.staleness).tolist()
    assert got["step"] == int(ref_state.step) == len(MASKS)

    # each rank holds C / pod cohorts of its own shard of every leaf: the
    # sharded size (every split here is even)
    sizes = {k: v.size * v.itemsize for k, v in want_buffers.items()}
    shard = {"pod": 2, "data": 2, "model": 2}
    want_bytes = 0
    for k, placements in got["placements"].items():
        split = 1
        for axis, pl in zip(("pod", "data", "model"), placements):
            split *= shard[axis] if pl.startswith("Shard") else 1
        want_bytes += sizes[k] // split
    assert sorted(got["placements"]) == sorted(sizes)
    assert all(pl[0] == "Shard(dim=0)"                     # cohorts on pod
               for pl in got["placements"].values())
    assert got["buffer_bytes"] == [want_bytes] * worker.WORLD
    assert want_bytes < sum(sizes.values()) // 2

    with np.load(os.path.join(out_dir, "got_moe.npz")) as f:
        got_moe = {k: f[k] for k in f.files}
    for n_experts, (out, aux) in ref_moe.items():
        err = float(np.abs(got_moe[f"out{n_experts}"] - out).max())
        assert err < EP_ATOL, (n_experts, err)
        assert abs(float(got_moe[f"aux{n_experts}"]) - aux) < AUX_ATOL

    # the server Adam round: the clip norm is the global one, as the
    # reference's, and the update matches
    adam = json.load(open(os.path.join(out_dir, "adam_out.json")))
    want_norm = float(ref_adam_metrics["grad_norm"])
    assert want_norm > ADAM_CLIP
    assert abs(adam["grad_norm"] - want_norm) <= ADAM_RTOL * want_norm
    local = adam["local_norms"]
    assert len(local) == worker.WORLD and len(set(local)) > 1
    assert max(local) < (1.0 - 1e-3) * want_norm
    assert adam["t"] == int(ref_adam.opt_state["t"]) == 1
    with np.load(os.path.join(out_dir, "got_adam.npz")) as f:
        got_adam = {k: f[k] for k in f.files}
    for k, want in _flat(ref_adam.params).items():
        scale = 1.0 + float(np.abs(want).max())
        err = float(np.abs(got_adam[f"params/{k}"] - want).max())
        assert err <= ADAM_RTOL * scale, (k, err)
    for name in ("m", "v"):
        for k, want in _flat(ref_adam.opt_state[name]).items():
            np.testing.assert_allclose(got_adam[f"{name}/{k}"], want,
                                       rtol=ADAM_RTOL, atol=1e-12)
    assert adam["staleness"] == np.asarray(ref_adam.staleness).tolist()
