"""The port's slice end to end vs the JAX reference.

* ``SemiSyncServer`` closes (per-arrival, segment feed, λ^τ discount);
* ``compute_payloads_stacked`` and ``round_update`` of the engine;
* ``run_simulation(..., device="cpu")`` on the two static golden configs
  of ``tests/test_driver.py``, from the reference's own init: host event
  math (times, Π, wait fraction, dispatch counts) bitwise, losses within
  rtol 1e-5 of the committed goldens and of a JAX run on this tree;
* the seed-0 ``mnist_dnn`` init the card-side golden of ``chip_smoke.py``
  reads (``src/repro_torch/testdata``) equals the JAX init bitwise;
* ``repro_torch`` imports neither ``jax`` nor ``repro``, and a CUDA run
  without a card raises instead of falling back.

The JAX reference runs under ``jax.threefry_partitionable(False)``, the
setting its goldens were recorded under.  Regenerate the init file with
``PYTHONPATH=src python tests/test_torch_slice.py``.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ExperimentConfig as RefExperimentConfig
from repro.config import FLConfig as RefFLConfig
from repro.configs import get_config as ref_get_config
from repro.core.server import SemiSyncServer as RefServer
from repro.core.server import ServerConfig as RefServerConfig
from repro.data import partition_noniid as ref_partition_noniid
from repro.data import synthetic_mnist as ref_synthetic_mnist
from repro.fl.engine import SimulationEngine as RefEngine
from repro.fl.simulation import run_simulation as ref_run_simulation
from repro.models import build_model as ref_build_model
from repro_torch.config import ExperimentConfig, FLConfig
from repro_torch.configs import get_config
from repro_torch.core.server import SemiSyncServer, ServerConfig
from repro_torch.data import partition_noniid, synthetic_mnist
from repro_torch.data.partition import sample_triplet_many
from repro_torch.fl.engine import SimulationEngine
from repro_torch.fl.simulation import run_simulation
from repro_torch.models import build_model
from repro_torch.obs.trace import Tracer
from repro_torch.utils.tree import (from_numpy_tree, to_numpy_tree,
                                    tree_leaves, tree_paths)

ROOT = Path(__file__).resolve().parents[1]
INIT_NPZ = ROOT / "src" / "repro_torch" / "testdata" / \
    "mnist_dnn_init_seed0.npz"
TOL = dict(rtol=1e-5, atol=1e-7)

_REF_MODEL = ref_build_model(ref_get_config("mnist_dnn"))
_PORT_MODEL = build_model(get_config("mnist_dnn"))


def _ref_init(seed):
    """The JAX driver's init for ``seed``: ``model.init`` on the first of
    three keys split from ``PRNGKey(seed)``, as numpy."""
    with jax.threefry_partitionable(False):
        init_key = jax.random.split(jax.random.PRNGKey(seed), 3)[0]
        return jax.tree.map(np.asarray, jax.jit(_REF_MODEL.init)(init_key))


def _port_model_from(init):
    model = build_model(get_config("mnist_dnn"))
    model.init = lambda gen: from_numpy_tree(init, "cpu")
    return model


def _close(got, want, **tol):
    for g, w in zip(tree_leaves(got), tree_leaves(
            jax.tree.map(np.asarray, want))):
        np.testing.assert_allclose(g.detach().numpy(), w, **(tol or TOL))


# ---------------------------------------------------------------------------
# server closes
# ---------------------------------------------------------------------------

def _server_pair(discount, n=5, a=3):
    params = to_numpy_tree(_PORT_MODEL.init(torch.Generator().manual_seed(1)))
    kw = dict(n_ues=n, participants_per_round=a, staleness_bound=1,
              beta=0.07, staleness_discount=discount)
    return (RefServer(jax.tree.map(jnp.asarray, params),
                      RefServerConfig(**kw)),
            SemiSyncServer(from_numpy_tree(params, "cpu"), ServerConfig(**kw)),
            params)


def _payload(params, rng):
    return jax.tree.map(
        lambda x: (0.1 * rng.normal(size=x.shape)).astype(np.float32), params)


@pytest.mark.parametrize("discount", [1.0, 0.6])
def test_server_per_arrival_closes_match_reference(discount):
    ref, port, params = _server_pair(discount)
    rng = np.random.default_rng(2)
    for ue in [0, 1, 2, 3, 0, 4, 1, 2, 3]:      # staleness builds up
        g = _payload(params, rng)
        want = ref.on_arrival(ue, jax.tree.map(jnp.asarray, g))
        got = port.on_arrival(ue, from_numpy_tree(g, "cpu"))
        assert (got is None) == (want is None)
        if got is not None:
            assert got["round"] == want["round"]
            assert got["distribute"] == want["distribute"]
            _close(got["params"], want["params"])
    np.testing.assert_array_equal(port.pi_matrix(), ref.pi_matrix())


@pytest.mark.parametrize("discount", [1.0, 0.6])
def test_server_segment_closes_match_reference(discount):
    ref, port, params = _server_pair(discount, n=6, a=4)
    rng = np.random.default_rng(3)
    for ues in ([0, 1], [2, 3], [4], [5, 0, 1], [2], [3, 4]):
        gs = [_payload(params, rng) for _ in ues]
        stacked = jax.tree.map(lambda *xs: np.stack(xs), *gs)
        want = ref.on_arrival_batch(np.array(ues),
                                    jax.tree.map(jnp.asarray, stacked))
        got = port.on_arrival_batch(np.array(ues),
                                    from_numpy_tree(stacked, "cpu"))
        assert (got is None) == (want is None)
        if got is not None:
            assert got["distribute"] == want["distribute"]
            _close(got["params"], want["params"])
    np.testing.assert_array_equal(port.pi_matrix(), ref.pi_matrix())


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def _clients_pair(n, seed, sizes=None):
    """Same shards and sampler seeds in both packages; ``sizes`` truncates
    chosen clients to give them another batch-shape signature."""
    ref = ref_partition_noniid(ref_synthetic_mnist(n=600, seed=21), n,
                               n_labels=4, seed=seed)
    port = partition_noniid(synthetic_mnist(n=600, seed=21), n, n_labels=4,
                            seed=seed)
    for ci, size in (sizes or {}).items():
        for c in (ref[ci], port[ci]):
            c.data = {k: v[:size] for k, v in c.data.items()}
    return ref, port


def _fl_pair(**kw):
    base = dict(alpha=0.03, beta=0.07, inner_batch=8, outer_batch=8,
                hessian_batch=8, **kw)
    return RefFLConfig(**base), FLConfig(**base)


def test_compute_payloads_stacked_matches_reference():
    ref_clients, port_clients = _clients_pair(6, seed=1, sizes={4: 5})
    ref_fl, fl = _fl_pair()
    v0 = _ref_init(0)
    v1 = jax.tree.map(lambda x: x * np.float32(0.9), v0)
    lane_version = [0, 1, 0, 0, 1, 1]
    alphas = [0.03, 0.02, 0.03, 0.04, 0.03, 0.05]
    groups = [[0, 1, 2, 3, 5], [4]]         # client 4 has its own signature
    ref_groups = [(g, jax.tree.map(jnp.asarray, sample_triplet_many(
        [ref_clients[i] for i in g], 8, 8, 8))) for g in groups]
    port_groups = [(g, sample_triplet_many([port_clients[i] for i in g],
                                           8, 8, 8)) for g in groups]
    ref_v = [jax.tree.map(jnp.asarray, v) for v in (v0, v1)]
    port_v = [from_numpy_tree(v, "cpu") for v in (v0, v1)]
    ref_eng = RefEngine(_REF_MODEL, ref_fl, "perfed")
    eng = SimulationEngine(_PORT_MODEL, fl, "perfed", device="cpu")
    want = ref_eng.compute_payloads_stacked(
        [ref_v[j] for j in lane_version], ref_groups, list(range(6)), alphas,
        jax.random.PRNGKey(0))
    got = eng.compute_payloads_stacked(
        [port_v[j] for j in lane_version], port_groups, alphas)
    assert tree_paths(got) == tree_paths(want)
    _close(got, want, rtol=1e-4, atol=1e-6)
    assert (eng.dispatches, eng.payloads_computed) == \
        (ref_eng.dispatches, ref_eng.payloads_computed)


@pytest.mark.parametrize("versions", [[0, 1, 2, 1], [0, 0, 0, 1]],
                         ids=["all_lanes", "grouped"])
def test_round_update_matches_reference(versions):
    ref_clients, port_clients = _clients_pair(4, seed=2)
    ref_fl, fl = _fl_pair()
    v = [_ref_init(0)]
    for _ in range(2):
        v.append(jax.tree.map(lambda x: x * np.float32(0.95), v[-1]))
    ref_trip = [c.sample_triplet(8, 8, 8) for c in ref_clients]
    port_trip = [c.sample_triplet(8, 8, 8) for c in port_clients]
    for a, b in zip(tree_leaves(ref_trip[0]), tree_leaves(port_trip[0])):
        np.testing.assert_array_equal(a, b)
    alphas = [0.03] * 4
    weights = np.array([1.0, 0.5, 1.0, 0.25])
    ref_v = [jax.tree.map(jnp.asarray, x) for x in v]
    port_v = [from_numpy_tree(x, "cpu") for x in v]
    ref_eng = RefEngine(_REF_MODEL, ref_fl, "perfed")
    eng = SimulationEngine(_PORT_MODEL, fl, "perfed", device="cpu")
    want = ref_eng.round_update(ref_v[2], [ref_v[j] for j in versions],
                                ref_trip, list(range(4)), alphas, weights,
                                beta=0.07, base_key=jax.random.PRNGKey(0))
    got = eng.round_update(port_v[2], [port_v[j] for j in versions],
                           port_trip, alphas, weights, beta=0.07)
    _close(got, want, rtol=1e-5, atol=1e-6)
    assert eng.dispatches == ref_eng.dispatches


# ---------------------------------------------------------------------------
# the static goldens, end to end
# ---------------------------------------------------------------------------

GOLDEN_1 = dict(
    times=["0x0.0p+0", "0x1.b877293c2d615p-1", "0x1.ae97a23acc733p+0",
           "0x1.4066315c4298cp+1"],
    total="0x1.4066315c4298cp+1", wait="0x1.f2da4241021f8p-3",
    pi=[[1, 0, 0, 1, 0, 0, 0, 1], [0, 0, 1, 0, 0, 1, 1, 0],
        [0, 1, 0, 0, 1, 0, 0, 1], [1, 0, 1, 1, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 1, 1, 1], [0, 1, 1, 0, 1, 0, 0, 0]],
    rounds=[0, 2, 4, 6], dispatches=(8, 18),
    losses=[2.3583488166332245, 1.8240666687488556, 1.4705257415771484,
            1.1463348343968391],
    global_losses=[2.7490968108177185, 2.1383248418569565,
                   1.7266773730516434, 1.365978181362152])
GOLDEN_2 = dict(
    times=["0x0.0p+0", "0x1.82c4cb3f67704p-1", "0x1.6ccf9ab27fc2cp+0"],
    pi=[[0, 1, 0, 1, 0, 0], [0, 0, 1, 0, 0, 1], [1, 0, 0, 0, 1, 0],
        [0, 0, 0, 1, 0, 1]],
    dispatches=(8, 8),
    losses=[2.046475092569987, 1.5647791028022766, 1.0200251936912537])

CASES = {
    "perfed_batched": dict(
        n=8, a=3, s=3, fl_kw={}, client_seed=0, golden=GOLDEN_1,
        run=dict(algorithm="perfed", mode="semi", max_rounds=6,
                 eval_every=2, seed=0)),
    "fedavg_sequential_distance": dict(
        n=6, a=2, s=2, fl_kw=dict(eta_mode="distance"), client_seed=4,
        golden=GOLDEN_2,
        run=dict(algorithm="fedavg", mode="semi", max_rounds=4,
                 eval_every=2, seed=4, bandwidth_policy="equal",
                 payload_mode="sequential")),
}


def _exp_cfg(cls_exp, cls_fl, get_cfg, n, a, s, fl_kw):
    return cls_exp(model=get_cfg("mnist_dnn"), fl=cls_fl(
        n_ues=n, participants_per_round=a, staleness_bound=s, alpha=0.03,
        beta=0.07, inner_batch=8, outer_batch=8, hessian_batch=8, **fl_kw))


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_simulation_reproduces_static_golden(case):
    c = CASES[case]
    gold = c["golden"]
    cfg = _exp_cfg(ExperimentConfig, FLConfig, get_config, c["n"], c["a"],
                   c["s"], c["fl_kw"])
    ref_clients, port_clients = _clients_pair(c["n"], c["client_seed"])
    res = run_simulation(cfg, _port_model_from(_ref_init(c["run"]["seed"])),
                         port_clients, device="cpu", **c["run"])
    assert [float(t).hex() for t in res.times] == gold["times"]
    assert res.pi.tolist() == gold["pi"]
    assert (res.payload_dispatches, res.payloads_computed) == \
        gold["dispatches"]
    np.testing.assert_allclose(res.losses, gold["losses"], rtol=1e-5)
    if "total" in gold:
        assert float(res.total_time).hex() == gold["total"]
        assert float(res.wait_fraction).hex() == gold["wait"]
        assert res.rounds.tolist() == gold["rounds"]
        np.testing.assert_allclose(res.global_losses, gold["global_losses"],
                                   rtol=1e-5)
    # and against the JAX package on this tree, same init
    ref_cfg = _exp_cfg(RefExperimentConfig, RefFLConfig, ref_get_config,
                       c["n"], c["a"], c["s"], c["fl_kw"])
    with jax.threefry_partitionable(False):
        ref = ref_run_simulation(ref_cfg, _REF_MODEL, ref_clients,
                                 **c["run"])
    np.testing.assert_array_equal(res.times, ref.times)
    assert float(res.total_time).hex() == float(ref.total_time).hex()
    assert float(res.wait_fraction).hex() == float(ref.wait_fraction).hex()
    np.testing.assert_array_equal(res.pi, ref.pi)
    np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-5)
    np.testing.assert_allclose(res.global_losses, ref.global_losses,
                               rtol=1e-5)
    assert (res.payload_dispatches, res.payloads_computed) == \
        (ref.payload_dispatches, ref.payloads_computed)


def test_mixed_signature_run_takes_batchwise_feed_like_reference():
    """A client with a short shard breaks the fused path's single-signature
    condition, so rounds go through the batch-wise segment feed."""
    cfg = _exp_cfg(ExperimentConfig, FLConfig, get_config, 6, 3, 2, {})
    ref_cfg = _exp_cfg(RefExperimentConfig, RefFLConfig, ref_get_config,
                       6, 3, 2, {})
    ref_clients, port_clients = _clients_pair(6, seed=3, sizes={1: 6})
    run = dict(algorithm="perfed", mode="semi", max_rounds=4, eval_every=2,
               seed=5)
    tracer = Tracer()
    res = run_simulation(cfg, _port_model_from(_ref_init(5)), port_clients,
                         device="cpu", tracer=tracer, **run)
    assert tracer.counts.get("driver.rounds_batchwise", 0) > 0
    with jax.threefry_partitionable(False):
        ref = ref_run_simulation(ref_cfg, _REF_MODEL, ref_clients, **run)
    np.testing.assert_array_equal(res.times, ref.times)
    np.testing.assert_array_equal(res.pi, ref.pi)
    np.testing.assert_allclose(res.losses, ref.losses, rtol=1e-5)
    assert (res.payload_dispatches, res.payloads_computed) == \
        (ref.payload_dispatches, ref.payloads_computed)


# ---------------------------------------------------------------------------
# packaging contracts
# ---------------------------------------------------------------------------

def test_committed_init_equals_jax_init():
    saved = dict(np.load(INIT_NPZ))
    want = _ref_init(0)
    assert sorted(saved) == tree_paths(want)
    for path, leaf in zip(tree_paths(want), tree_leaves(want)):
        np.testing.assert_array_equal(saved[path], leaf)


_IMPORT_CHECK = """
import sys
import repro_torch
import repro_torch.config, repro_torch.configs, repro_torch.core.bandwidth
import repro_torch.core.perfed, repro_torch.core.scheduler
import repro_torch.core.server, repro_torch.data.partition
import repro_torch.data.synthetic, repro_torch.fl.algorithms
import repro_torch.fl.client, repro_torch.fl.driver, repro_torch.fl.engine
import repro_torch.fl.simulation, repro_torch.kernels.stale_aggregate
import repro_torch.models.registry, repro_torch.models.small
import repro_torch.obs.trace, repro_torch.utils.tree
import repro_torch.wireless.channel, repro_torch.wireless.timing
bad = [m for m in sys.modules
       if m == "jax" or m.startswith("jax.") or m == "repro"
       or m.startswith("repro.")]
assert not bad, bad
print("clean")
"""


def test_port_imports_neither_jax_nor_repro():
    out = subprocess.run([sys.executable, "-c", _IMPORT_CHECK],
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                        "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card contract is moot")
    cfg = _exp_cfg(ExperimentConfig, FLConfig, get_config, 4, 2, 2, {})
    _, port_clients = _clients_pair(4, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_simulation(cfg, _PORT_MODEL, port_clients, max_rounds=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SimulationEngine(_PORT_MODEL, cfg.fl, "perfed")


if __name__ == "__main__":
    init = _ref_init(0)
    INIT_NPZ.parent.mkdir(parents=True, exist_ok=True)
    np.savez(INIT_NPZ, **dict(zip(tree_paths(init), tree_leaves(init))))
    print(f"wrote {INIT_NPZ}")
