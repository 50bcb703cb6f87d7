"""The port's SPMD layer on 8 gloo ranks against the JAX reference's
single-device math.

One ``torch.multiprocessing.spawn`` of 8 ranks (``test_torch_spmd_worker``,
which imports no JAX), joined through a ``FileStore`` in a temporary
directory (no port to race over between test workers), shared by every
test of the file through a module fixture.  The parent writes the
reference's params, states and inputs, the ranks write their results
back; the parent computes the reference's steps while the ranks run
(each case's inputs are written before its reference step):

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
* the other five LM families' mesh code, each at the reduced f32 config
  of its single-device semi-sync case: mamba2-370m (the head-split SSD
  scan, b and c gradients summed over ``model``), recurrentgemma-2b (the
  RG-LRU scan, MQA with one kv head under a 2-way model split),
  Mixtral-8x22B and DeepSeek-V2-236B with ``moe_impl="ep"`` (experts on
  ``model``; MLA), Llama-3.2-11B-Vision (cross layers, gates drawn
  nonzero) and MusicGen-Large (codebooks drawn apart).  Each takes one
  mesh round from the reference's state after its round 0 (both cohorts
  arriving both rounds: Eq. 8 applies both pods' buffers and both pods
  refresh theirs), held as yi-6b's is against the reference's round 1;
  every MoE routing's top-k gap above ``test_torch_moe.MIN_GAP``.  The
  planted fault (mamba2 with the scan's b and c gradients left unsummed
  over ``model``) must fail the hold;
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
from concurrent.futures import ProcessPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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
from test_torch_moe import MIN_GAP
from test_torch_vlm import _draw_gates

ARCH = "yi_6b"
REDUCED = dict(max_d_model=64, vocab=128)
FL = dict(alpha=0.02, beta=0.1, staleness_bound=1, algorithm="perfed")
MASKS = [[1.0, 1.0], [1.0, 0.0]]
COHORTS, BATCH, SEQ = 2, 4, 16
# the families: both cohorts arrive in both rounds, so the mesh round
# (round 1) refreshes both pods' buffers
FAMILY_MASKS = [[1.0, 1.0], [1.0, 1.0]]
FAMILY_SEQ = 32
STATE_RTOL = 1e-4
EP_ATOL, AUX_ATOL = 1e-4, 1e-5
ADAM_CLIP = 0.05          # well under the aggregate's norm: the clip acts
ADAM_RTOL = 1e-5
MESH = {"pod": 2, "data": 2, "model": 2}
REF_PROCESSES = 2


def _flat(tree):
    return {ref_sharding._path_str(p): np.asarray(x)
            for p, x in jax.tree_util.tree_leaves_with_path(tree)}


def _ready(out_dir, case):
    open(os.path.join(out_dir, f"{case}.ready"), "w").close()


def _write_state(out_dir, name, state):
    np.savez(os.path.join(out_dir, f"{name}_state.npz"),
             **{f"params/{k}": v for k, v in _flat(state.params).items()},
             **{f"buffers/{k}": v for k, v in _flat(state.buffers).items()},
             staleness=np.asarray(state.staleness),
             step=np.asarray(state.step))


def _write_case(out_dir, case, arch, reduced, inputs, rounds, masks,
                moe_impl="gather"):
    json.dump({"arch": arch, "reduced": reduced, "fl": FL,
               "cohorts": COHORTS, "moe_impl": moe_impl, "inputs": inputs,
               "rounds": rounds, "masks": masks},
              open(os.path.join(out_dir, f"{case}.json"), "w"))
    _ready(out_dir, case)


def _draw_batches(out_dir, case, cfg, rng, n_rounds, seq):
    """Each round's {"inner", "outer", "hessian"} token batches [C, B,
    seq] (or [C, B, seq, K], each codebook drawn on its own), written as
    ``<case>_batch<k>.npz``."""
    tail = (cfg.num_audio_codebooks,) if cfg.num_audio_codebooks else ()
    out = []
    for k in range(n_rounds):
        batch = {}
        for n in ("inner", "outer", "hessian"):
            t = rng.integers(0, cfg.vocab_size,
                             size=(COHORTS, BATCH, seq + 1) + tail) \
                .astype(np.int32)
            batch[n] = {"tokens": t[:, :, :-1], "targets": t[:, :, 1:]}
        np.savez(os.path.join(out_dir, f"{case}_batch{k}.npz"),
                 **{f"{n}_{f}": batch[n][f] for n in batch
                    for f in ("tokens", "targets")})
        out.append(batch)
    return out


def _ref_setup(arch, reduced, grad_clip=0.0, opt_name="sgd"):
    cfg = dataclasses.replace(ref_get_config(arch).reduced(**reduced),
                              dtype="float32")
    model = ref_build_model(cfg)
    exp = RefExperimentConfig(model=cfg, fl=RefFLConfig(**FL),
                              train=RefTrainConfig(grad_clip=grad_clip))
    opt = ref_make_optimizer(opt_name)
    return cfg, model, opt, jax.jit(ref_semi_sync.make_semi_sync_step(
        model, exp, opt, COHORTS))


def _ref_init(model, opt):
    with jax.threefry_partitionable(False):
        return ref_semi_sync.init_state(model, jax.random.PRNGKey(0), opt,
                                        COHORTS)


def _ref_rounds(step, state, batches, masks, first=0):
    out = []
    for k, (batch, mask) in enumerate(zip(batches, masks), start=first):
        state, _ = step(state, batch, jnp.asarray(mask, jnp.float32),
                        jax.random.PRNGKey(k))
        out.append(state)
    return out


class _YiReference:
    """yi-6b's inputs, written at once; its rounds run later, while the
    ranks run."""

    def __init__(self, out_dir):
        self.cfg, model, opt, self.step = _ref_setup(ARCH, REDUCED)
        self.state = _ref_init(model, opt)
        _write_state(out_dir, ARCH, self.state)
        self.batches = _draw_batches(out_dir, ARCH, self.cfg,
                                     np.random.default_rng(0), len(MASKS),
                                     SEQ)
        _write_case(out_dir, ARCH, ARCH, REDUCED, ARCH, [0, 1], MASKS)

    def run(self):
        """The reference's state after round 0 and after both."""
        s0, s1 = _ref_rounds(self.step, self.state, self.batches, MASKS)
        return s0, s1


def _reference_server_adam(out_dir, state0):
    """Write the state after round 0; return the reference's state and
    metrics after one server-Adam round (with clipping) from it, on round
    1's batch and mask."""
    _, model, opt, step = _ref_setup(ARCH, REDUCED, ADAM_CLIP, "adam")
    state = state0._replace(opt_state=opt.init(state0.params))
    _write_state(out_dir, "adam", state)
    json.dump({"arch": ARCH, "reduced": REDUCED, "fl": FL,
               "cohorts": COHORTS, "mask": MASKS[1], "inputs": ARCH,
               "adam_clip": ADAM_CLIP},
              open(os.path.join(out_dir, "adam.json"), "w"))
    _ready(out_dir, "adam")
    with np.load(os.path.join(out_dir, f"{ARCH}_batch1.npz")) as f:
        batch = {n: {k: jnp.asarray(f[f"{n}_{k}"])
                     for k in ("tokens", "targets")}
                 for n in ("inner", "outer", "hessian")}
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
    _ready(out_dir, "moe")
    return want


def _reference_family(out_dir, arch):
    """Write ``arch``'s batches and its state after round 0 (the cross
    gates drawn nonzero first); return the reference's state after round
    1 and the round batches."""
    cfg, model, opt, step = _ref_setup(arch, {})
    state = _ref_init(model, opt)
    if cfg.family == "vlm":
        state = state._replace(params=jax.tree.map(
            jnp.asarray, _draw_gates(jax.tree.map(np.array, state.params))))
    batches = _draw_batches(out_dir, arch, cfg, np.random.default_rng(0),
                            len(FAMILY_MASKS), FAMILY_SEQ)
    (state0,) = _ref_rounds(step, state, batches[:1], FAMILY_MASKS[:1])
    _write_state(out_dir, arch, state0)
    _write_case(out_dir, arch, arch, {}, arch, [1], FAMILY_MASKS[1:],
                "ep" if cfg.moe is not None else "gather")
    if arch == "mamba2_370m":
        _write_case(out_dir, worker.FAULT, arch, {}, arch, [1],
                    FAMILY_MASKS[1:])
    (state1,) = _ref_rounds(step, state0, batches[1:], FAMILY_MASKS[1:],
                            first=1)
    return jax.tree.map(np.asarray, state1), batches


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Run the spawn; return the reference's results and the directory
    the ranks wrote theirs to."""
    out_dir = str(tmp_path_factory.mktemp("spmd"))
    # the families' references in processes of their own, started first
    # (the ranks reach mamba2's a minute in) and taken in the ranks' order
    pool = ProcessPoolExecutor(REF_PROCESSES,
                               mp_context=mp.get_context("spawn"))
    ctx = None
    try:
        pending = {arch: pool.submit(_reference_family, out_dir, arch)
                   for arch in worker.FAMILIES}
        yi = _YiReference(out_dir)
        ctx = mp.spawn(worker.run, args=(out_dir,), nprocs=worker.WORLD,
                       join=False)
        ref_moe = _reference_moe(out_dir)
        state0, yi_state = yi.run()
        ref_adam = _reference_server_adam(out_dir, state0)
        families = {arch: f.result() for arch, f in pending.items()}
        while not ctx.join():
            pass
    except BaseException:
        _ready(out_dir, "abort")
        for p in ctx.processes if ctx is not None else ():
            if p.is_alive():
                p.terminate()
        raise
    finally:
        pool.shutdown(cancel_futures=True)
    return dict(out_dir=out_dir, yi=yi_state, adam=ref_adam, moe=ref_moe,
                families=families)


def _within(got, want):
    return float(np.abs(got - want).max()) <= \
        STATE_RTOL * (1.0 + float(np.abs(want).max()))


def _close(got, want, what):
    assert _within(got, want), (what, float(np.abs(got - want).max()),
                                1.0 + float(np.abs(want).max()))


def _want(state):
    return {**{f"params/{k}": v for k, v in _flat(state.params).items()},
            **{f"buffers/{k}": v for k, v in _flat(state.buffers).items()}}


def _got(out_dir, case):
    with np.load(os.path.join(out_dir, f"{case}_got.npz")) as f:
        state = {k: f[k] for k in f.files}
    return state, json.load(open(os.path.join(out_dir, f"{case}_out.json")))


def _hold_state(out_dir, case, want_state, steps):
    """The ranks' state of ``case`` against the reference's: params and
    buffers within ``STATE_RTOL`` of each leaf's scale, staleness and step
    bitwise, the buffers placed as ``state_shardings`` places them and
    each rank holding the sharded size of them.  Returns the ranks' state
    and results."""
    got, out = _got(out_dir, case)
    want = _want(want_state)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k], want[k], k)
    assert any(float(np.abs(v).max()) > 0 for k, v in want.items()
               if k.startswith("buffers/"))
    assert out["staleness"] == np.asarray(want_state.staleness).tolist()
    assert out["step"] == int(want_state.step) == steps

    # each rank holds C / pod cohorts of its own shard of every leaf: the
    # sharded size (every split here is even)
    sizes = {k[len("buffers/"):]: v.size * v.itemsize
             for k, v in want.items() if k.startswith("buffers/")}
    want_bytes = 0
    for k, placements in out["placements"].items():
        split = 1
        for axis, pl in zip(MESH, placements):
            split *= MESH[axis] if pl.startswith("Shard") else 1
        want_bytes += sizes[k] // split
    assert sorted(out["placements"]) == sorted(sizes)
    assert all(pl[0] == "Shard(dim=0)"                     # cohorts on pod
               for pl in out["placements"].values())
    assert out["buffer_bytes"] == [want_bytes] * worker.WORLD
    assert want_bytes < sum(sizes.values()) // 2
    return got, out


def test_semi_sync_and_expert_parallel_on_eight_ranks(ranks):
    out_dir = ranks["out_dir"]
    _hold_state(out_dir, ARCH, ranks["yi"], len(MASKS))

    with np.load(os.path.join(out_dir, "got_moe.npz")) as f:
        got_moe = {k: f[k] for k in f.files}
    for n_experts, (out, aux) in ranks["moe"].items():
        err = float(np.abs(got_moe[f"out{n_experts}"] - out).max())
        assert err < EP_ATOL, (n_experts, err)
        assert abs(float(got_moe[f"aux{n_experts}"]) - aux) < AUX_ATOL

    # the server Adam round: the clip norm is the global one, as the
    # reference's, and the update matches
    ref_adam, ref_adam_metrics = ranks["adam"]
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


@pytest.mark.parametrize("arch", worker.FAMILIES)
def test_family_mesh_round_matches_reference(ranks, arch):
    want, batches = ranks["families"][arch]
    got, out = _hold_state(ranks["out_dir"], arch, want, len(FAMILY_MASKS))
    # every leaf's gradient reached both pods' buffer rows
    for k, v in got.items():
        if k.startswith("buffers/"):
            assert v[0].any() and v[1].any(), k
    gaps = out["route_gaps"]
    if arch in ("mixtral_8x22b", "deepseek_v2_236b"):
        assert gaps and min(gaps) > MIN_GAP, min(gaps or [0.0])
    else:
        assert not gaps
    if arch == "llama32_vision_11b":
        assert (got["params/cross_layers/gate_cross"] != 0).all()
    if arch == "musicgen_large":
        toks = batches[1]["inner"]["tokens"]
        assert toks.shape[-1] == 4 and (toks[..., 0] != toks[..., 1]).any()


def test_planted_scan_fault_fails_the_hold(ranks):
    """mamba2 with the scan's b and c gradients left unsummed over
    ``model``: the refreshed buffers of in_proj (whose output holds b and
    c) leave the reference's."""
    want = _want(ranks["families"]["mamba2_370m"][0])
    got, _ = _got(ranks["out_dir"], worker.FAULT)
    failed = {k for k in want if not _within(got[k], want[k])}
    assert "buffers/layers/in_proj" in failed, sorted(failed)
    # Eq. 8 applied the reference's round-0 buffers: the params hold
    assert not any(k.startswith("params/") for k in failed)
