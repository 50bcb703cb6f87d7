"""The port's semi-synchronous step (core/semi_sync.py) and its launchers vs
the JAX reference.

* ``make_semi_sync_step`` on reduced yi-6b and reduced mamba2 in float32,
  from the reference's own params and state, for 3 rounds with the same
  masks and batches: staleness, participants and max staleness equal every
  round (the masks include a forced τ > S refresh), params within
  1e-5·(1 + max|p|) per leaf, with β-SGD both through the fused Eq.-8 path
  (no clipping) and through masked mean + clipping + SGD.  FL settings are
  those of ``tests/test_semi_sync_step.py`` (α 0.02, β 0.1): with
  ``train_e2e``'s β 0.5 and no clipping each round moves the params by
  tens of times their f32 rounding, and by round 3 that reads 2e-5.
* Server Adam for one round: both packages aggregate the same buffers
  (the reference's, carried across), so the update is compared on one
  aggregate.  Adam maps near-zero gradients to ±lr, so several rounds of
  summation-order noise in the gradients are not a fair parity test.
* The four properties of ``tests/test_semi_sync_step.py`` on the port.
* ``make_train_step`` (PerFed and plain) against the reference.
* ``cfg.remat`` on reduced yi-6b and mamba2: loss, gradient, HVP and
  meta-gradient bitwise with and without it, and ``torch.func.grad``
  through a ``remat=True`` model (which skips the checkpoint).
* ``launch.train --mode scale --reduce --device cpu --steps 2`` and
  ``launch.train_e2e --device cpu --rounds 2`` run (``--server-opt adam``
  and ``--fused-agg`` too).
"""
import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ExperimentConfig as RefExperimentConfig
from repro.config import FLConfig as RefFLConfig
from repro.config import ModelConfig as RefModelConfig
from repro.config import TrainConfig as RefTrainConfig
from repro.configs import get_config as ref_get_config
from repro.core import semi_sync as ref_semi_sync
from repro.models import build_model as ref_build_model
from repro.optim import make_optimizer as ref_make_optimizer
from repro_torch.config import ExperimentConfig, FLConfig, ModelConfig
from repro_torch.config import TrainConfig
from repro_torch.configs import get_config
from repro_torch.core import perfed, semi_sync
from repro_torch.kernels import fused_adam, stale_aggregate
from repro_torch.launch import train, train_e2e
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.utils.tree import (from_numpy_tree, tree_leaves, tree_map,
                                    tree_norm, tree_paths, tree_sub,
                                    tree_unflatten)

N_COHORTS = 3
FL = dict(alpha=0.02, beta=0.1, staleness_bound=1, algorithm="perfed")
# S = 1: round 2 refreshes cohort 2 because it has waited 2 > S rounds
MASKS = [[1, 1, 0], [1, 0, 0], [0, 1, 0]]
STALENESS = [[0, 0, 1], [0, 1, 2], [1, 0, 0]]


def pair(arch, grad_clip, opt_name, **cfg_kw):
    """(reference model/cfg/opt, port model/cfg/opt) at f32, reduced, with
    ``cfg_kw`` replaced in both model configs."""
    kw = {"dtype": "float32", **cfg_kw}
    ref_m = dataclasses.replace(ref_get_config(arch).reduced(), **kw)
    port_m = dataclasses.replace(get_config(arch).reduced(), **kw)
    ref_cfg = RefExperimentConfig(model=ref_m, fl=RefFLConfig(**FL),
                                  train=RefTrainConfig(grad_clip=grad_clip))
    cfg = ExperimentConfig(model=port_m, fl=FLConfig(**FL),
                           train=TrainConfig(grad_clip=grad_clip))
    return ((ref_build_model(ref_m), ref_cfg, ref_make_optimizer(opt_name)),
            (build_model(port_m), cfg, make_optimizer(opt_name)))


def carry_state(ref_state, opt):
    """The reference's state as numpy, carried into the port's."""
    params = from_numpy_tree(jax.tree.map(np.asarray, ref_state.params),
                             "cpu")
    buffers = from_numpy_tree(jax.tree.map(np.asarray, ref_state.buffers),
                              "cpu")
    return semi_sync.SemiSyncState(
        params=params, opt_state=opt.init(params), buffers=buffers,
        staleness=torch.from_numpy(np.array(ref_state.staleness)),
        step=torch.tensor(int(ref_state.step), dtype=torch.int32))


def lm_batches(rng, vocab, n=N_COHORTS, b=2, seq=32, codebooks=0):
    """Each cohort's {"inner", "outer", "hessian"} token batches, [n, b,
    seq] (or [n, b, seq, K] with ``codebooks`` K: each codebook drawn on
    its own)."""
    tail = (codebooks,) if codebooks else ()

    def one():
        t = rng.integers(0, vocab, size=(n, b, seq + 1) + tail) \
            .astype(np.int32)
        return {"tokens": t[:, :, :-1], "targets": t[:, :, 1:]}
    return {"inner": one(), "outer": one(), "hessian": one()}


def assert_params_close(port_params, ref_params, rel=1e-5, what="params"):
    for path, got, want in zip(tree_paths(port_params),
                               tree_leaves(port_params),
                               jax.tree.leaves(ref_params)):
        want = np.asarray(want)
        err = float(np.abs(got.detach().numpy() - want).max())
        limit = rel * (1.0 + float(np.abs(want).max()))
        assert err <= limit, f"{what} leaf {path}: error {err} > {limit}"


@contextlib.contextmanager
def one_thread():
    """The port's CPU ops on one thread within the block: under the
    suite's parallel workers, each with a thread per core, these small
    ops spend most of their time contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _ref_step(arch, grad_clip, cfg_items):
    """The reference's jitted step, built once per case and reused."""
    (ref, ref_cfg, ref_opt), _ = pair(arch, grad_clip, "sgd",
                                      **dict(cfg_items))
    return ref, ref_opt, jax.jit(ref_semi_sync.make_semi_sync_step(
        ref, ref_cfg, ref_opt, N_COHORTS))


def hold_semi_sync_rounds(arch, grad_clip, *, rounds=len(MASKS),
                          draw=None, edit_params=None, on_round=None,
                          **cfg_kw):
    """β-SGD semi-sync rounds of ``arch`` (reduced, f32) in both packages
    from the reference's state, with ``MASKS`` and the same batches:
    staleness, participants and max staleness bitwise every round, params
    within 1e-5·(1 + max|p|) a leaf, ``grad_norm`` rtol 1e-5.

    ``draw(rng, cfg)`` gives a round's numpy batches (``lm_batches`` by
    default); ``edit_params(params)`` edits the reference's initial params
    (numpy) before both packages take them; ``on_round(k, ref, port,
    ref_state, state, batches)`` runs after each round's checks.  Returns
    (reference state, port state)."""
    ref, ref_opt, ref_step = _ref_step(arch, grad_clip,
                                       tuple(sorted(cfg_kw.items())))
    (_, ref_cfg, _), (port, cfg, opt) = pair(arch, grad_clip, "sgd",
                                             **cfg_kw)
    assert semi_sync.uses_fused_eq8(opt, cfg) == (grad_clip == 0.0) == \
        ref_semi_sync.uses_fused_eq8(ref_opt, ref_cfg)
    step = semi_sync.make_semi_sync_step(port, cfg, opt, N_COHORTS)
    with jax.threefry_partitionable(False):
        ref_state = ref_semi_sync.init_state(ref, jax.random.PRNGKey(0),
                                             ref_opt, N_COHORTS)
    if edit_params is not None:
        ref_state = ref_state._replace(params=jax.tree.map(
            jnp.asarray, edit_params(jax.tree.map(np.array,
                                                  ref_state.params))))
    state = carry_state(ref_state, opt)
    rng = np.random.default_rng(0)
    draw = draw or (lambda rng, c: lm_batches(rng, c.vocab_size))
    before = stale_aggregate.LAUNCHES
    for k, mask in enumerate(MASKS[:rounds]):
        batches = draw(rng, ref.cfg)
        m = np.asarray(mask, np.float32)
        ref_state, ref_metrics = ref_step(ref_state, batches, jnp.asarray(m),
                                          jax.random.PRNGKey(k))
        with one_thread():
            state, metrics = step(state, tree_map(torch.from_numpy, batches),
                                  torch.from_numpy(m))
        np.testing.assert_array_equal(state.staleness.numpy(), STALENESS[k])
        np.testing.assert_array_equal(state.staleness.numpy(),
                                      np.asarray(ref_state.staleness))
        assert int(state.step) == int(ref_state.step) == k + 1
        assert float(metrics["participants"]) == \
            float(ref_metrics["participants"]) == sum(mask)
        assert int(metrics["max_staleness"]) == \
            int(ref_metrics["max_staleness"])
        np.testing.assert_allclose(float(metrics["grad_norm"]),
                                   float(ref_metrics["grad_norm"]),
                                   rtol=1e-5)
        assert_params_close(state.params, ref_state.params)
        if on_round is not None:
            on_round(k, ref, port, ref_state, state, batches)
    assert stale_aggregate.LAUNCHES == before   # the CPU takes the plain one
    return ref_state, state


@pytest.mark.parametrize("grad_clip", [0.0, 1.0], ids=["fused", "clipped"])
@pytest.mark.parametrize("arch", ["yi_6b", "mamba2_370m"])
def test_sgd_rounds_match_reference(arch, grad_clip):
    hold_semi_sync_rounds(arch, grad_clip)


def test_server_adam_round_matches_reference():
    (ref, ref_cfg, ref_opt), (port, cfg, opt) = pair("mamba2_370m", 1.0,
                                                       "adam")
    ref_step = jax.jit(ref_semi_sync.make_semi_sync_step(ref, ref_cfg,
                                                         ref_opt, N_COHORTS))
    step = semi_sync.make_semi_sync_step(port, cfg, opt, N_COHORTS)
    with jax.threefry_partitionable(False):
        ref_state = ref_semi_sync.init_state(ref, jax.random.PRNGKey(0),
                                             ref_opt, N_COHORTS)
    rng = np.random.default_rng(1)
    # round 0 (reference only) fills the buffers the Adam round aggregates
    ref_state, _ = ref_step(ref_state, lm_batches(rng, ref.cfg.vocab_size),
                            jnp.asarray(MASKS[0], jnp.float32),
                            jax.random.PRNGKey(0))
    state = carry_state(ref_state, opt)
    state = state._replace(opt_state=from_numpy_tree(
        jax.tree.map(np.asarray, ref_state.opt_state), "cpu"))
    batches = lm_batches(rng, ref.cfg.vocab_size)
    m = np.asarray(MASKS[1], np.float32)
    ref_state, ref_metrics = ref_step(ref_state, batches, jnp.asarray(m),
                                      jax.random.PRNGKey(1))
    before = fused_adam.LAUNCHES
    state, metrics = step(state, tree_map(torch.from_numpy, batches),
                          torch.from_numpy(m))
    assert fused_adam.LAUNCHES == before        # the CPU takes the plain one
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(ref_metrics["grad_norm"]), rtol=1e-5)
    assert_params_close(state.params, ref_state.params)
    assert int(state.opt_state["t"]) == int(ref_state.opt_state["t"]) == 2
    for name in ("m", "v"):
        for got, want in zip(tree_leaves(state.opt_state[name]),
                             jax.tree.leaves(ref_state.opt_state[name])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-12)
    np.testing.assert_array_equal(state.staleness.numpy(),
                                  np.asarray(ref_state.staleness))


# ---------------------------------------------------------------------------
# the four properties of tests/test_semi_sync_step.py, on the port
# ---------------------------------------------------------------------------

def _small_setup():
    cfg = ExperimentConfig(
        model=ModelConfig(name="mnist_dnn", family="small", d_model=16,
                          vocab_size=10, dtype="float32"),
        fl=FLConfig(alpha=0.02, beta=0.1, staleness_bound=2),
        train=TrainConfig(grad_clip=0.0))
    return cfg, build_model(cfg.model), make_optimizer("sgd")


def _mnist_batches(seed, n_cohorts, b=8):
    rng = np.random.default_rng(seed)

    def one():
        return {"x": torch.from_numpy(rng.normal(size=(n_cohorts, b, 28, 28))
                                      .astype(np.float32)),
                "y": torch.from_numpy(rng.integers(0, 10, size=(n_cohorts, b))
                                      .astype(np.int32))}
    return {"inner": one(), "outer": one(), "hessian": one()}


def _gen():
    return torch.Generator().manual_seed(0)


def test_masked_aggregation_matches_manual():
    cfg, model, opt = _small_setup()
    n = 3
    step = semi_sync.make_semi_sync_step(model, cfg, opt, n)
    state = semi_sync.init_state(model, _gen(), opt, n)
    bufs = tree_map(lambda b: torch.stack([torch.full(b.shape[1:], float(i + 1))
                                           for i in range(n)]),
                    state.buffers)
    state = state._replace(buffers=bufs)
    new_state, _ = step(state, _mnist_batches(0, n),
                        torch.tensor([1.0, 0.0, 1.0]))
    # Eq. (8): w ← w − β/2 · (buf_0 + buf_2) = w − 0.1/2·(1+3)
    for leaf in tree_leaves(tree_sub(new_state.params, state.params)):
        np.testing.assert_allclose(leaf.numpy(), -0.1 / 2 * 4.0, atol=1e-5)


def test_refresh_only_scheduled_cohorts():
    cfg, model, opt = _small_setup()
    n = 3
    step = semi_sync.make_semi_sync_step(model, cfg, opt, n)
    state = semi_sync.init_state(model, _gen(), opt, n)
    new_state, _ = step(state, _mnist_batches(0, n),
                        torch.tensor([1.0, 0.0, 1.0]))
    b0 = tree_leaves(new_state.buffers)[0]
    assert float(b0[1].abs().max()) == 0.0
    assert float(b0[0].abs().max()) > 0.0
    assert float(b0[2].abs().max()) > 0.0
    np.testing.assert_array_equal(new_state.staleness.numpy(), [0, 1, 0])


def test_stale_cohort_forced_refresh():
    cfg, model, opt = _small_setup()
    n = 2
    step = semi_sync.make_semi_sync_step(model, cfg, opt, n)
    state = semi_sync.init_state(model, _gen(), opt, n)
    batches = _mnist_batches(0, n)
    mask = torch.tensor([1.0, 0.0])
    # S = 2: after 3 rounds of never being scheduled, cohort 1 must refresh
    for _ in range(3):
        state, _ = step(state, batches, mask)
    assert int(state.staleness[1]) == 3
    state, _ = step(state, batches, mask)
    assert int(state.staleness[1]) == 0        # τ > S triggered the refresh


def test_single_cohort_is_synchronous_perfedavg():
    """n_cohorts=1, mask=[1] ≡ make_train_step(perfed) after one warm-up
    round (the first semi-sync round applies the zero-initialised buffer)."""
    cfg, model, opt = _small_setup()
    semi = semi_sync.make_semi_sync_step(model, cfg, opt, 1)
    plain = semi_sync.make_train_step(model, cfg, opt, perfed_step=True)
    s_state = semi_sync.init_state(model, _gen(), opt, 1)
    p_state = semi_sync.init_train_state(model, _gen(), opt)
    batches = _mnist_batches(0, 1)
    flat = tree_map(lambda x: x[0], batches)
    mask = torch.ones(1)
    s_state, _ = semi(s_state, batches, mask)
    assert float(tree_norm(tree_sub(s_state.params, p_state.params))) < 1e-7
    s_state, _ = semi(s_state, batches, mask)
    p_state, _ = plain(p_state, flat)
    err = float(tree_norm(tree_sub(s_state.params, p_state.params)))
    assert err < 1e-5, err


@pytest.mark.parametrize("perfed_step", [True, False],
                         ids=["perfed", "plain"])
def test_train_step_matches_reference(perfed_step):
    ref_m = RefModelConfig(name="mnist_dnn", family="small", d_model=16,
                           vocab_size=10, dtype="float32")
    ref_cfg = RefExperimentConfig(model=ref_m,
                                  fl=RefFLConfig(alpha=0.02, beta=0.1),
                                  train=RefTrainConfig(grad_clip=1.0))
    ref, ref_opt = ref_build_model(ref_m), ref_make_optimizer("sgd")
    cfg, model, opt = _small_setup()
    cfg = dataclasses.replace(cfg, train=TrainConfig(grad_clip=1.0))
    ref_step = jax.jit(ref_semi_sync.make_train_step(
        ref, ref_cfg, ref_opt, perfed_step=perfed_step))
    step = semi_sync.make_train_step(model, cfg, opt,
                                     perfed_step=perfed_step)
    with jax.threefry_partitionable(False):
        ref_state = ref_semi_sync.init_train_state(
            ref, jax.random.PRNGKey(0), ref_opt)
    params = from_numpy_tree(jax.tree.map(np.asarray, ref_state.params),
                             "cpu")
    state = semi_sync.TrainState(params, opt.init(params),
                                 torch.zeros((), dtype=torch.int32))
    for k in range(2):
        batches = tree_map(lambda x: x[0], _mnist_batches(k, 1))
        ref_state, ref_metrics = ref_step(
            ref_state, tree_map(lambda x: x.numpy(), batches),
            jax.random.PRNGKey(k))
        state, metrics = step(state, batches)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(metrics[key]),
                                       float(ref_metrics[key]), rtol=1e-5)
        assert_params_close(state.params, ref_state.params)
    assert int(state.step) == int(ref_state.step) == 2


@pytest.mark.parametrize("arch", ["yi_6b", "mamba2_370m"])
def test_remat_is_bitwise_and_steps_aside_under_torch_func(arch,
                                                           monkeypatch):
    """``cfg.remat`` checkpoints each layer (the checkpoint is called) and
    changes no bit of the loss, the gradient, the reverse-over-reverse HVP
    or the step's meta-gradient; ``torch.func.grad`` runs through a
    ``remat=True`` model without a checkpoint and equals ``remat=False``."""
    base = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    calls = []
    checkpoint = torch.utils.checkpoint.checkpoint

    def counting(*args, **kw):
        calls.append(kw.get("use_reentrant"))
        return checkpoint(*args, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counting)
    batches = tree_map(lambda x: torch.from_numpy(x[0]), lm_batches(
        np.random.default_rng(3), base.vocab_size, n=1))
    out = {}
    for remat in (True, False):
        model = build_model(dataclasses.replace(base, remat=remat))
        params = model.init(torch.Generator().manual_seed(0), device="cpu")

        def loss_fn(p, b):
            return model.loss(p, b)[0]

        leaves = [x.detach().requires_grad_(True)
                  for x in tree_leaves(params)]
        loss = loss_fn(tree_unflatten(params, leaves), batches["outer"])
        grads = torch.autograd.grad(loss, leaves)
        hvp = perfed.hvp_autograd(loss_fn, params, batches["hessian"],
                                  tree_unflatten(params, grads))
        meta = perfed.perfed_grad(loss_fn, params, batches, 0.02,
                                  autograd=True)
        n = len(calls)
        func = torch.func.grad(lambda p: loss_fn(p, batches["outer"]))(
            params)
        assert len(calls) == n          # no checkpoint inside torch.func
        out[remat] = [loss.detach(), *grads, *tree_leaves(hvp),
                      *tree_leaves(meta), *tree_leaves(func)]
        if remat:
            assert calls and set(calls) == {False}
            n_remat = len(calls)
        else:
            assert len(calls) == n_remat
    for a, b in zip(out[True], out[False]):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the launchers, on the CPU
# ---------------------------------------------------------------------------

def test_train_scale_mode_runs_reduced_on_cpu(tmp_path):
    state, metrics = train.run(["--mode", "scale", "--arch", "mamba2_370m",
                                "--reduce", "--device", "cpu",
                                "--steps", "2",
                                "--ckpt-dir", str(tmp_path / "ckpt")])
    assert int(state.step) == 2
    assert np.isfinite(float(metrics["loss"]))
    # --ckpt-dir saves the final params, as the reference does
    from repro_torch.checkpoint import latest_checkpoint, load_checkpoint
    fname = latest_checkpoint(str(tmp_path / "ckpt"))
    assert fname.endswith("ckpt_00000002.npz")
    back = load_checkpoint(fname, like=state.params)
    for got, want in zip(tree_leaves(back), tree_leaves(state.params)):
        assert torch.equal(got, want)
    # --metrics-dir writes the fl mode's eval points as JSONL
    res = train.run(["--metrics-dir", str(tmp_path), "--device", "cpu",
                     "fl.n_ues=4", "fl.participants_per_round=2",
                     "fl.rounds=2", "fl.inner_batch=8", "fl.outer_batch=8",
                     "fl.hessian_batch=8"])
    from repro_torch.utils.metrics import read_metrics
    rows = read_metrics(str(tmp_path / "metrics.jsonl"))
    assert rows[0]["_meta"] == {"arch": "mnist_dnn", "algo": "perfed",
                                "mode": "semi"}
    assert [r["step"] for r in rows[1:]] == res.rounds.tolist() == [0, 2]
    np.testing.assert_allclose([r["ploss"] for r in rows[1:]], res.losses)


@pytest.mark.parametrize("extra", [[], ["--server-opt", "adam"],
                                   ["--fused-agg"]],
                         ids=["sgd", "adam", "fused"])
def test_train_e2e_runs_on_cpu(extra):
    assert train_e2e.main(["--device", "cpu", "--rounds", "2"] + extra) == 0
