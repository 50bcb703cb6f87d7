"""The port's mobile multi-cell path vs the JAX reference.

* ``mobility/models.py``: every model's trajectory, ``step_many(T)`` ≡ T ×
  ``step``, bitwise against the reference's on one seed;
* ``mobility/multicell.py``: drops, ``advance_to`` positions, association,
  distances and handover events (nearest, load-aware, full re-scoring),
  flash-crowd retargeting, bitwise;
* ``core/hierarchy.py``: per-arrival and segment feeds with handovers,
  departed arrivals, joins, leaves, live caps, flushes and cloud merges —
  protocol decisions exact, params within float32 tolerance;
* ``run_simulation(..., device="cpu")`` with ``cfg.mobility.enabled``: one
  moving cell, the 3-cell hierarchy (nearest), load-aware association with
  per-cell budgets and Theorem-2 bandwidth; host event math bitwise, losses
  and final params within rtol 1e-5, atol 1e-6;
* the degenerate mobile run equals the static golden bitwise, in the legacy
  and the counter fading modes, and the batch-wise feed equals the
  per-arrival feed on a static and a moving hierarchy.

The shared parity runner (``run_pair`` / ``hold_pair``) is imported by the
port's scenario and telemetry tests.  The JAX reference runs under
``jax.threefry_partitionable(False)``, the setting its goldens were recorded
under; its init reaches the port through numpy.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ExperimentConfig as RefExperimentConfig
from repro.config import FLConfig as RefFLConfig
from repro.config import MobilityConfig as RefMobilityConfig
from repro.config import ScenarioConfig as RefScenarioConfig
from repro.config import WirelessConfig as RefWirelessConfig
from repro.configs import get_config as ref_get_config
from repro.core.hierarchy import HierarchicalServer as RefHierarchy
from repro.core.hierarchy import HierarchyConfig as RefHierarchyConfig
from repro.core.server import ServerConfig as RefServerConfig
from repro.data import partition_noniid as ref_partition_noniid
from repro.data import synthetic_mnist as ref_synthetic_mnist
from repro.fl.driver import run_event_loop as ref_run_event_loop
from repro.fl.engine import SimulationEngine as RefEngine
from repro.fl.mobile import MobileAdapter as RefMobileAdapter
from repro.fl.simulation import StaticAdapter as RefStaticAdapter
from repro.mobility import models as ref_models
from repro.mobility import multicell as ref_multicell
from repro.models import build_model as ref_build_model
from repro_torch.config import (ExperimentConfig, FLConfig, MobilityConfig,
                                ScenarioConfig, WirelessConfig)
from repro_torch.configs import get_config
from repro_torch.core.hierarchy import (NON_MEMBER, HierarchicalServer,
                                        HierarchyConfig)
from repro_torch.core.server import ServerConfig
from repro_torch.data import partition_noniid, synthetic_mnist
from repro_torch.fl.simulation import run_simulation
from repro_torch.mobility import models, multicell
from repro_torch.models import build_model
from repro_torch.utils.tree import from_numpy_tree, tree_leaves

TOL = dict(rtol=1e-5, atol=1e-6)
_REF_MODEL = ref_build_model(ref_get_config("mnist_dnn"))


# ---------------------------------------------------------------------------
# parity runner shared with the scenario and telemetry tests
# ---------------------------------------------------------------------------

def ref_init(seed):
    """The JAX driver's init for ``seed``, as numpy."""
    with jax.threefry_partitionable(False):
        init_key = jax.random.split(jax.random.PRNGKey(seed), 3)[0]
        return jax.tree.map(np.asarray, jax.jit(_REF_MODEL.init)(init_key))


def port_model(init):
    model = build_model(get_config("mnist_dnn"))
    model.init = lambda gen: from_numpy_tree(init, "cpu")
    return model


def cfg_pair(n, a, s, *, mob=None, scen=None, rng="legacy", batch=8,
             **fl_kw):
    """The same experiment in both packages' config classes."""
    out = []
    for exp, fl, mc, sc, wl, get in (
            (RefExperimentConfig, RefFLConfig, RefMobilityConfig,
             RefScenarioConfig, RefWirelessConfig, ref_get_config),
            (ExperimentConfig, FLConfig, MobilityConfig, ScenarioConfig,
             WirelessConfig, get_config)):
        out.append(exp(
            model=get("mnist_dnn"), wireless=wl(rng=rng),
            fl=fl(n_ues=n, participants_per_round=a, staleness_bound=s,
                  alpha=0.03, beta=0.07, inner_batch=batch,
                  outer_batch=batch, hessian_batch=batch, **fl_kw),
            mobility=mc(**(mob or {})), scenario=sc(**(scen or {}))))
    return out


def clients_pair(n, seed=0, data_n=1200, data_seed=21):
    return (ref_partition_noniid(ref_synthetic_mnist(n=data_n, seed=data_seed),
                                 n, n_labels=4, seed=seed),
            partition_noniid(synthetic_mnist(n=data_n, seed=data_seed), n,
                             n_labels=4, seed=seed))


_REF_ENGINES = {}


def run_ref(cfg, clients, *, bandwidth_policy="optimal", **run):
    """The reference run through its own adapter (so its final params can be
    read), as ``run_simulation`` builds it.  Runs of one FL config share one
    reference engine, so JAX compiles its payload functions once."""
    adapter_cls = RefMobileAdapter if cfg.mobility.enabled \
        else RefStaticAdapter
    adapter = adapter_cls(cfg, len(clients), seed=run.get("seed", 0),
                          bandwidth_policy=bandwidth_policy,
                          mode=run.get("mode", "semi"))
    key = (cfg.fl, run.get("algorithm", "perfed"),
           run.pop("payload_mode", None) or "batched")
    if key not in _REF_ENGINES:
        _REF_ENGINES[key] = RefEngine(_REF_MODEL, cfg.fl, key[1],
                                      payload_mode=key[2])
    with jax.threefry_partitionable(False):
        res = ref_run_event_loop(cfg, _REF_MODEL, clients, adapter,
                                 engine=_REF_ENGINES[key], **run)
    return res, jax.tree.map(np.asarray, adapter.protocol().params)


def run_pair(n, a, s, *, client_seed=0, data_n=1200, data_seed=21,
             cfg_kw=None, **run):
    """(reference result, its final params, port result) on one config."""
    ref_cfg, port_cfg = cfg_pair(n, a, s, **(cfg_kw or {}))
    ref_clients, port_clients = clients_pair(n, client_seed, data_n,
                                             data_seed)
    ref, ref_params = run_ref(ref_cfg, ref_clients, **run)
    port = run_simulation(port_cfg, port_model(ref_init(run.get("seed", 0))),
                          port_clients, device="cpu", **run)
    return ref, ref_params, port


HOST_FIELDS = ("total_time", "wait_fraction", "payload_dispatches",
               "payloads_computed", "n_cells", "handovers", "cloud_rounds",
               "departed_arrivals", "ue_joins", "ue_departures",
               "label_drifts", "aborted_rounds", "pending_uploads")


def hold_pair(ref, ref_params, port):
    """Host event math bitwise; losses and params within float32 tolerance."""
    for field in ("times", "pi", "rounds", "eta_target", "eta_realised"):
        np.testing.assert_array_equal(getattr(port, field),
                                      getattr(ref, field), err_msg=field)
    for field in HOST_FIELDS:
        got, want = getattr(port, field), getattr(ref, field)
        assert float(got).hex() == float(want).hex(), (field, got, want)
    for field in ("losses", "global_losses", "accs"):
        np.testing.assert_allclose(getattr(port, field), getattr(ref, field),
                                   err_msg=field, **TOL)
    want = jax.tree.leaves(ref_params)
    got = tree_leaves(port.params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, **TOL)


# ---------------------------------------------------------------------------
# mobility models
# ---------------------------------------------------------------------------

AREA = (0.0, 0.0, 400.0, 400.0)
_MODELS = {
    "static": dict(),
    "random_waypoint": dict(speed_mps=10.0, pause_s=2.0),
    "gauss_markov": dict(speed_mps=10.0),
}


def _model_pair(name):
    kw = _MODELS[name]
    speed = kw.get("speed_mps", 0.0)
    return (ref_models.get_mobility(name, speed_mps=speed,
                                    pause_s=kw.get("pause_s", 0.0)),
            models.get_mobility(name, speed_mps=speed,
                                pause_s=kw.get("pause_s", 0.0)))


@pytest.mark.parametrize("name", sorted(_MODELS))
def test_mobility_models_match_reference_bitwise(name):
    ref_model, model = _model_pair(name)
    assert type(model).__name__ == type(ref_model).__name__
    area, ref_area = models.Area(*AREA), ref_models.Area(*AREA)
    rngs = [np.random.default_rng(5), np.random.default_rng(5)]
    out = []
    for mod, ar, rng in ((ref_model, ref_area, rngs[0]),
                         (model, area, rngs[1])):
        pos = ar.uniform(rng, 32)
        state = mod.init_state(32, ar, rng)
        traj = [pos]
        for _ in range(7):
            pos, state = mod.step(pos, state, 0.5, ar, rng)
            traj.append(pos)
        # one batched draw for 9 more ticks
        pos, state = mod.step_many(pos, state, 9, 0.5, ar, rng)
        traj.append(pos)
        out.append((np.stack(traj), state))
    np.testing.assert_array_equal(out[1][0], out[0][0])
    assert sorted(out[1][1]) == sorted(out[0][1])
    for k in out[0][1]:
        np.testing.assert_array_equal(out[1][1][k], out[0][1][k])
    assert area.contains(out[1][0].reshape(-1, 2)).all()


@pytest.mark.parametrize("name", ["random_waypoint", "gauss_markov"])
def test_step_many_is_bitwise_repeated_step(name):
    _, model = _model_pair(name)
    area = models.Area(*AREA)
    a_rng, b_rng = np.random.default_rng(1), np.random.default_rng(1)
    pos = area.uniform(a_rng, 16)
    area.uniform(b_rng, 16)
    sa = model.init_state(16, area, a_rng)
    sb = model.init_state(16, area, b_rng)
    pa, pb = pos, pos
    for _ in range(12):
        pa, sa = model.step(pa, sa, 1.0, area, a_rng)
    pb, sb = model.step_many(pb, sb, 12, 1.0, area, b_rng)
    np.testing.assert_array_equal(pa, pb)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k])


def test_get_mobility_factory_matches_reference():
    for name, speed in (("random_waypoint", 0.0), ("static", 3.0),
                        ("random_waypoint", 2.0), ("gauss-markov", 2.0)):
        assert type(models.get_mobility(name, speed_mps=speed)).__name__ == \
            type(ref_models.get_mobility(name, speed_mps=speed)).__name__
    with pytest.raises(ValueError, match="unknown mobility model"):
        models.get_mobility("teleport", speed_mps=2.0)


# ---------------------------------------------------------------------------
# multi-cell network
# ---------------------------------------------------------------------------

def test_layout_and_cell_bandwidth_match_reference():
    for k in (1, 2, 3, 4, 7):
        np.testing.assert_array_equal(multicell.cell_layout(k, 200.0),
                                      ref_multicell.cell_layout(k, 200.0))
    for spec in ((), None, (2e6,), (2e6, 5e5, 5e5)):
        np.testing.assert_array_equal(
            multicell.resolve_cell_bandwidth(spec, 3, 1e6),
            ref_multicell.resolve_cell_bandwidth(spec, 3, 1e6))
    with pytest.raises(ValueError, match="2 entries for 3 cells"):
        multicell.resolve_cell_bandwidth((1e6, 2e6), 3, 1e6)
    with pytest.raises(ValueError, match="positive"):
        multicell.resolve_cell_bandwidth((1e6, 0.0), 2, 1e6)
    with pytest.raises(ValueError, match="association"):
        multicell.MultiCellNetwork.drop(WirelessConfig(), 8, n_cells=2,
                                        association="teleport")


_NETS = {
    "one_cell_static": dict(n_cells=1),
    "one_cell_moving": dict(n_cells=1, mobility="random_waypoint",
                            speed_mps=20.0, step_s=0.5),
    "nearest_rwp": dict(n_cells=4, mobility="random_waypoint",
                        speed_mps=50.0),
    "nearest_full": dict(n_cells=4, mobility="random_waypoint",
                         speed_mps=50.0, reassoc="full"),
    "nearest_gm_ring": dict(n_cells=3, mobility="gauss_markov",
                            speed_mps=40.0, uniform_distance=True),
    "load_aware_budgets": dict(n_cells=3, mobility="random_waypoint",
                               speed_mps=40.0, association="load_aware",
                               cell_bandwidth_hz=(2e6, 5e5, 5e5)),
    "counter_fading": dict(n_cells=2, mobility="random_waypoint",
                           speed_mps=30.0, rng="counter"),
}


def _net_pair(case, n=48, seed=3):
    kw = dict(_NETS[case])
    rng = kw.pop("rng", "legacy")
    return (ref_multicell.MultiCellNetwork.drop(RefWirelessConfig(rng=rng),
                                                n, seed=seed, **kw),
            multicell.MultiCellNetwork.drop(WirelessConfig(rng=rng), n,
                                            seed=seed, **kw))


_NET_ARRAYS = ("bs_xy", "positions", "cpu_freq", "assoc", "distances",
               "cell_bw")


@pytest.mark.parametrize("case", sorted(_NETS))
def test_multicell_drop_and_advance_match_reference(case):
    ref, net = _net_pair(case)
    for k in _NET_ARRAYS:
        np.testing.assert_array_equal(getattr(net, k), getattr(ref, k),
                                      err_msg=k)
    ref_events, events = [], []
    for t in np.cumsum(np.full(25, 3.7)):
        ref_events += ref.advance_to(float(t))
        events += net.advance_to(float(t))
        # a call that completes no new tick is a pure clock update
        assert net.advance_to(float(t)) == []
        ref.advance_to(float(t))
    assert events == ref_events
    assert net.handovers == ref.handovers == len(events)
    if case in ("nearest_rwp", "nearest_full", "load_aware_budgets"):
        assert net.handovers > 0
    for k in _NET_ARRAYS:
        np.testing.assert_array_equal(getattr(net, k), getattr(ref, k),
                                      err_msg=k)
    np.testing.assert_array_equal(net.cell_counts(), ref.cell_counts())
    idx = np.array([3, 7, 7, 40, 1])
    if case == "counter_fading":
        np.testing.assert_array_equal(net.fading_lanes(idx),
                                      ref.fading_lanes(idx))
    else:
        np.testing.assert_array_equal(net.sample_fading_batch(3),
                                      ref.sample_fading_batch(3))
    np.testing.assert_array_equal(net.mean_rates(), ref.mean_rates())


@pytest.mark.parametrize("rng", ["legacy", "counter"])
def test_single_cell_drop_is_bitwise_edge_network(rng):
    from repro_torch.wireless.channel import EdgeNetwork
    cfg = WirelessConfig(rng=rng)
    legacy = EdgeNetwork.drop(cfg, 16, seed=3)
    net = multicell.MultiCellNetwork.drop(cfg, 16, n_cells=1, seed=3)
    np.testing.assert_array_equal(legacy.distances, net.distances)
    np.testing.assert_array_equal(legacy.cpu_freq, net.cpu_freq)
    if rng == "counter":
        idx = np.array([0, 5, 5, 15, 2])
        np.testing.assert_array_equal(legacy.fading_lanes(idx),
                                      net.fading_lanes(idx))
    else:
        np.testing.assert_array_equal(legacy.sample_fading(),
                                      net.sample_fading())


def test_set_active_and_retarget_match_reference():
    ref, net = _net_pair("nearest_rwp", n=24, seed=1)
    for x in (ref, net):
        x.set_active(5, False)
        x.set_active(9, False)
    np.testing.assert_array_equal(net.cell_members(2), ref.cell_members(2))
    idx = np.array([0, 3, 11])
    got = net.retarget_waypoints(idx, 1, 50.0, np.random.default_rng(4))
    want = ref.retarget_waypoints(idx, 1, 50.0, np.random.default_rng(4))
    assert got == want == 3
    ref_events, events = [], []
    for t in (2.0, 5.0, 9.0, 14.0):
        ref_events += ref.advance_to(t)
        events += net.advance_to(t)
    assert events == ref_events
    assert all(u not in (5, 9) for u, _, _ in events)
    np.testing.assert_array_equal(net.positions, ref.positions)
    np.testing.assert_array_equal(net.cell_counts(), ref.cell_counts())


def test_load_aware_association_matches_reference():
    rng = np.random.default_rng(0)
    bs = np.array([[0.0, 0.0], [100.0, 0.0], [50.0, 90.0]])
    pos = np.stack([rng.uniform(0.0, 100.0, 60),
                    rng.uniform(-20.0, 90.0, 60)], axis=1)
    bw = np.array([4e6, 1e6, 1e6])
    got_info, want_info = {}, {}
    got = multicell._associate_load_aware(pos, bs, bw, 50.0, info=got_info)
    want = ref_multicell._associate_load_aware(pos, bs, bw, 50.0,
                                               info=want_info)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got_info["margin"], want_info["margin"])
    assert got_info["converged"] == want_info["converged"]
    for g, w in zip(multicell._associate(pos, bs),
                    ref_multicell._associate(pos, bs)):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# hierarchical cell → cloud aggregation
# ---------------------------------------------------------------------------

def _tree(rng):
    return {"w": rng.normal(size=(4,)).astype(np.float32),
            "b": {"x": rng.normal(size=(2, 3)).astype(np.float32)}}


def _hier_pair(n=12, n_cells=3, a=3, every=2, discount=0.6):
    params = _tree(np.random.default_rng(0))
    kw = dict(n_ues=n, participants_per_round=a, staleness_bound=2,
              beta=0.1, staleness_discount=discount)
    members = [np.arange(c, n, n_cells) for c in range(n_cells)]
    ref = RefHierarchy(jax.tree.map(jnp.asarray, params),
                       [RefServerConfig(**kw) for _ in range(n_cells)],
                       RefHierarchyConfig(n_cells=n_cells,
                                          cloud_sync_every=every), members)
    port = HierarchicalServer(from_numpy_tree(params, "cpu"),
                              [ServerConfig(**kw) for _ in range(n_cells)],
                              HierarchyConfig(n_cells=n_cells,
                                              cloud_sync_every=every),
                              members)
    return ref, port


def _same_result(got, want):
    assert (got is None) == (want is None)
    if got is None:
        return
    for k in ("round", "cell", "distribute", "cloud_synced"):
        assert got[k] == want[k], k
    for g, w in zip(tree_leaves(got["params"]),
                    jax.tree.leaves(want["params"])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _same_state(port, ref):
    for g, w in zip(port.cells, ref.cells):
        np.testing.assert_array_equal(g.ue_version, w.ue_version)
        assert g.round == w.round
    np.testing.assert_array_equal(port.member_cell, ref.member_cell)
    np.testing.assert_array_equal(port.pi_matrix(), ref.pi_matrix())
    assert (port.edge_rounds, port.cloud_rounds, port.departed_arrivals) == \
        (ref.edge_rounds, ref.cloud_rounds, ref.departed_arrivals)
    np.testing.assert_array_equal(port._arrivals_since_sync,
                                  ref._arrivals_since_sync)


def test_hierarchy_per_arrival_feed_matches_reference():
    ref, port = _hier_pair()
    rng = np.random.default_rng(7)
    for step in range(40):
        if step % 5 == 4:                      # a handover between arrivals
            ue = int(rng.integers(12))
            src, dst = int(port.member_cell[ue]), int(rng.integers(3))
            ref.handover(ue, src, dst)
            port.handover(ue, src, dst)
        c, ue = int(rng.integers(3)), int(rng.integers(12))
        g = _tree(rng)
        _same_result(port.on_arrival(c, ue, from_numpy_tree(g, "cpu")),
                     ref.on_arrival(c, ue, jax.tree.map(jnp.asarray, g)))
    assert port.cloud_rounds > 0 and port.departed_arrivals > 0
    _same_state(port, ref)
    assert port.cells[0].ue_version.dtype == np.int64
    assert (port.cells[1].ue_version == NON_MEMBER).any()


def _drained_batch(hier, rng, n=12):
    """One drain's (cells, ues): lanes of other cells short of their close,
    then the closing cell's lanes, its last arrival last."""
    close = int(rng.integers(3))
    cells = []
    for c in range(3):
        need = hier.arrivals_until_round(c)
        k = need if c == close else int(rng.integers(0, need))
        cells += [c] * k
    last = cells.index(close) + cells.count(close) - 1
    cells.pop(last)
    rng.shuffle(cells)
    cells.append(close)
    ues = rng.permutation(n)[:len(cells)]
    return np.array(cells), ues


def test_hierarchy_segment_feed_matches_reference():
    """Interleaved cells force the gather path, a single-cell drain the
    contiguous slice; handovers between drains give departed lanes."""
    ref, port = _hier_pair(every=3)
    rng = np.random.default_rng(11)
    for step in range(14):
        for _ in range(2):
            ue = int(rng.integers(12))
            src, dst = int(port.member_cell[ue]), int(rng.integers(3))
            ref.handover(ue, src, dst)
            port.handover(ue, src, dst)
        cells, ues = _drained_batch(port, rng)
        stacked = jax.tree.map(lambda *xs: np.stack(xs),
                               *[_tree(rng) for _ in ues])
        _same_result(
            port.on_arrival_batch(cells, ues, from_numpy_tree(stacked, "cpu")),
            ref.on_arrival_batch(cells, ues,
                                 jax.tree.map(jnp.asarray, stacked)))
        _same_state(port, ref)
    assert port.cloud_rounds >= 4 and port.departed_arrivals > 0


def test_hierarchy_join_leave_flush_matches_reference():
    ref, port = _hier_pair(every=0, discount=1.0)
    rng = np.random.default_rng(3)
    for h in (ref, port):
        h.leave(4)
        h.leave(7)
        h.join(4, 2)
        h.set_live_cap(0, 2, 1)
    g = [_tree(rng) for _ in range(3)]
    for ue, x in ((0, g[0]), (3, g[1])):
        _same_result(port.on_arrival(0, ue, from_numpy_tree(x, "cpu")),
                     ref.on_arrival(0, ue, jax.tree.map(jnp.asarray, x)))
    for h in (ref, port):
        h.set_live_cap(0, 2, 0)         # every member's upload is in
    _same_result(port.flush(0), ref.flush(0))
    assert port.flush(1) is None and ref.flush(1) is None
    assert port.pending_uploads() == ref.pending_uploads() == 0
    assert port.open_rounds() == ref.open_rounds()
    _same_state(port, ref)


def test_cloud_merge_matches_reference_and_shares_one_tree():
    ref, port = _hier_pair()
    rng = np.random.default_rng(2)
    for c in range(3):
        p = _tree(rng)
        ref.cells[c].params = jax.tree.map(jnp.asarray, p)
        port.cells[c].params = from_numpy_tree(p, "cpu")
    for h in (ref, port):
        h._arrivals_since_sync[:] = [3, 0, 1]
        h.cloud_sync()
    for g, w in zip(tree_leaves(port.cloud_params),
                    jax.tree.leaves(ref.cloud_params)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    assert all(srv.params is port.cloud_params for srv in port.cells)
    assert all(x.dtype == torch.float32 for x in tree_leaves(port.params))
    # a round closing in one cell leaves the shared merged tree untouched
    before = [x.clone() for x in tree_leaves(port.cloud_params)]
    port.cells[0].on_arrival(0, from_numpy_tree(_tree(rng), "cpu"))
    port.cells[0].on_arrival(3, from_numpy_tree(_tree(rng), "cpu"))
    port.cells[0].on_arrival(6, from_numpy_tree(_tree(rng), "cpu"))
    assert port.cells[0].params is not port.cloud_params
    for x, y in zip(before, tree_leaves(port.cells[1].params)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# run_simulation with cfg.mobility.enabled, end to end
# ---------------------------------------------------------------------------

_HIER3 = dict(enabled=True, model="random_waypoint", speed_mps=150.0,
              n_cells=3, hierarchy=True, cloud_sync_every=3, step_s=0.05)

RUNS = {
    # one moving cell, flat server, full second-order payloads
    "one_cell_moving": dict(
        n=12, a=4, s=3, run=dict(max_rounds=5, eval_every=2, seed=0),
        cfg_kw=dict(mob=dict(enabled=True, model="random_waypoint",
                             speed_mps=30.0, n_cells=1, step_s=0.05))),
    # the 3-cell hierarchy, nearest association
    "hierarchy_nearest": dict(
        n=24, a=6, s=4, run=dict(max_rounds=6, eval_every=3, seed=0,
                                 bandwidth_policy="equal"),
        cfg_kw=dict(mob=_HIER3, first_order=True)),
    # load-aware association, per-cell budgets, Theorem-2 bandwidth
    "load_aware_theorem2": dict(
        n=24, a=6, s=4, run=dict(max_rounds=6, eval_every=3, seed=1,
                                 bandwidth_policy="theorem2"),
        cfg_kw=dict(mob=dict(_HIER3, association="load_aware",
                             cell_bandwidth_hz=(2e6, 5e5, 5e5)),
                    first_order=True)),
}


@pytest.mark.parametrize("case", sorted(RUNS))
def test_mobile_run_matches_reference(case):
    c = RUNS[case]
    ref, ref_params, port = run_pair(c["n"], c["a"], c["s"],
                                     cfg_kw=c["cfg_kw"], **c["run"])
    hold_pair(ref, ref_params, port)
    assert port.pi.shape[0] == c["run"]["max_rounds"]
    if case != "one_cell_moving":
        assert port.n_cells == 3 and port.cloud_rounds == 2
        assert port.handovers > 0


# the static goldens of tests/test_driver.py and tests/test_counter_rng.py
_GOLDEN_TIMES = {
    "legacy": ["0x0.0p+0", "0x1.b877293c2d615p-1", "0x1.ae97a23acc733p+0",
               "0x1.4066315c4298cp+1"],
    "counter": ["0x0.0p+0", "0x1.c54356e93685cp-1", "0x1.b627e2dd22877p+0",
                "0x1.44e6583053d06p+1"]}


@pytest.mark.parametrize("rng", ["legacy", "counter"])
def test_degenerate_mobile_is_bitwise_static_golden(rng):
    """speed 0, one cell, hierarchy off: the static run's trajectory, bit
    for bit, in both fading modes (the static goldens of the reference)."""
    run = dict(algorithm="perfed", mode="semi", max_rounds=6, eval_every=2,
               seed=0)
    _, static_cfg = cfg_pair(8, 3, 3, rng=rng)
    degen_cfg = dataclasses.replace(static_cfg, mobility=MobilityConfig(
        enabled=True, speed_mps=0.0, n_cells=1, hierarchy=False))
    init = ref_init(0)
    out = []
    for cfg in (static_cfg, degen_cfg):
        _, clients = clients_pair(8, data_n=600)
        out.append(run_simulation(cfg, port_model(init), clients,
                                  device="cpu", **run))
    static, degen = out
    assert [float(t).hex() for t in degen.times] == _GOLDEN_TIMES[rng]
    assert float(degen.total_time).hex() == _GOLDEN_TIMES[rng][-1]
    assert degen.rounds.tolist() == [0, 2, 4, 6]
    assert degen.payloads_computed == 18
    for field in ("times", "pi", "losses", "global_losses"):
        np.testing.assert_array_equal(getattr(degen, field),
                                      getattr(static, field))
    assert float(degen.wait_fraction).hex() == \
        float(static.wait_fraction).hex()
    assert degen.handovers == degen.cloud_rounds == 0
    assert degen.payload_dispatches == static.payload_dispatches


_FEED = {
    "static_hierarchy": dict(
        n=8, a=4, s=6, rng="legacy",
        mob=dict(enabled=True, model="static", speed_mps=0.0, n_cells=2,
                 hierarchy=True, cell_participants=2, cloud_sync_every=3)),
    "moving_hierarchy": dict(
        n=8, a=4, s=4, rng="counter",
        mob=dict(enabled=True, model="random_waypoint", speed_mps=30.0,
                 n_cells=2, hierarchy=True, cell_participants=2,
                 cloud_sync_every=0, step_s=0.05)),
}


@pytest.mark.parametrize("case", sorted(_FEED))
def test_batch_feed_matches_sequential_and_reference(case):
    """The batch-wise feed (cell-sorted segments, closing cell last) against
    the per-arrival feed in the port, and against the reference's batched
    run: host math bitwise, losses within tolerance."""
    c = _FEED[case]
    _, port_cfg = cfg_pair(c["n"], c["a"], c["s"], mob=c["mob"], rng=c["rng"],
                           first_order=True, eta_mode="distance")
    run = dict(algorithm="perfed", mode="semi", max_rounds=6, eval_every=2,
               seed=0, bandwidth_policy="equal")
    init = ref_init(0)
    seq, bat = (run_simulation(port_cfg, port_model(init),
                               clients_pair(c["n"], data_n=600)[1],
                               device="cpu", payload_mode=mode, **run)
                for mode in ("sequential", "batched"))
    np.testing.assert_array_equal(seq.times, bat.times)
    np.testing.assert_array_equal(seq.pi, bat.pi)
    assert seq.total_time == bat.total_time
    assert (seq.cloud_rounds, seq.handovers, seq.departed_arrivals) == \
        (bat.cloud_rounds, bat.handovers, bat.departed_arrivals)
    np.testing.assert_allclose(seq.losses, bat.losses, rtol=2e-5, atol=1e-6)
    ref, ref_params, port = run_pair(
        c["n"], c["a"], c["s"], data_n=600,
        cfg_kw=dict(mob=c["mob"], rng=c["rng"], first_order=True,
                    eta_mode="distance"), **run)
    hold_pair(ref, ref_params, port)
    np.testing.assert_array_equal(port.times, bat.times)
    if case == "moving_hierarchy":
        assert port.handovers > 0 and port.departed_arrivals > 0
