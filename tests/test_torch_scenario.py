"""The port's open world (``fl/scenario.py`` and the driver's join, leave,
drift and flash paths) vs the JAX reference.

* ``ScenarioRuntime``: the event stream, alive-time integration,
  ``can_spawn``, ``was_alive`` and hotspot draws, bitwise;
* the five scenarios of the reference's registry (static, churn, diurnal,
  flash crowd, drift) on the 3-cell hierarchy, under equal and Theorem-2
  bandwidth: host event math bitwise (times, Π, wait fraction, joins,
  leaves, drifts, aborted rounds, pending uploads), losses and params
  within float32 tolerance;
* a zero-rate enabled scenario is the closed world bitwise, static and on
  the mobile hierarchy; the adaptive round-size clamp against the frozen
  per-cell A; heap exhaustion counted and warned; the Theorem-2 warm start
  dropped on an emptied cell.
"""
import dataclasses

import numpy as np
import pytest
from test_torch_mobility import (cfg_pair, clients_pair, hold_pair, port_model,
                                 ref_init, run_pair)

from benchmarks.scenarios import scenario_registry
from repro.config import ScenarioConfig as RefScenarioConfig
from repro.fl.scenario import ScenarioRuntime as RefRuntime
from repro_torch.config import ScenarioConfig
from repro_torch.fl.mobile import MobileAdapter
from repro_torch.fl.scenario import (DRIFT, FLASH, JOIN, LEAVE,
                                     ScenarioRuntime, make_scenario)
from repro_torch.fl.simulation import run_simulation

N_UES = 16

# the scenario tests' mobile topology: 3 cells, a hierarchy, moving UEs
_HIER = dict(enabled=True, model="random_waypoint", speed_mps=20.0,
             n_cells=3, hierarchy=True, cloud_sync_every=4, step_s=0.2)


def _runtime_pair(n, seed, **kw):
    return (RefRuntime(RefScenarioConfig(enabled=True, **kw), n, seed=seed),
            ScenarioRuntime(ScenarioConfig(enabled=True, **kw), n, seed=seed))


def _drain(scen, limit=1e9):
    out = []
    while True:
        ev = scen.next_event(limit)
        if ev is None:
            return out
        out.append(ev)


# ---------------------------------------------------------------------------
# ScenarioRuntime
# ---------------------------------------------------------------------------

_STREAMS = {
    "churn": dict(initial_active_frac=0.5, arrival_rate=2.0,
                  departure_rate=0.3, min_active=1, horizon_s=50.0),
    "diurnal_flash": dict(initial_active_frac=0.6, arrival_rate=1.5,
                          departure_rate=0.1, min_active=3,
                          diurnal_amplitude=0.8, diurnal_period_s=4.0,
                          flash_time_s=3.0, flash_duration_s=2.0,
                          flash_arrival_boost=5.0, flash_hotspot_frac=0.5,
                          horizon_s=30.0),
    "drift_floor": dict(departure_rate=5.0, min_active=3, drift_rate=0.7,
                        horizon_s=40.0),
}


@pytest.mark.parametrize("case", sorted(_STREAMS))
def test_event_stream_matches_reference_bitwise(case):
    ref, port = _runtime_pair(12, 7, **_STREAMS[case])
    np.testing.assert_array_equal(port.active, ref.active)
    events, ref_events = [], []
    for t in (0.5, 3.0, 3.1, 10.0, 1e9):
        # the driver interleaves hotspot draws with the stream
        events += _drain(port, t)
        ref_events += _drain(ref, t)
        np.testing.assert_array_equal(port.hotspot_targets(),
                                      ref.hotspot_targets())
        assert port.next_time() == ref.next_time()
        assert port.can_spawn() == ref.can_spawn()
        assert float(port.alive_total(t if t < 1e9 else 55.0)).hex() == \
            float(ref.alive_total(t if t < 1e9 else 55.0)).hex()
    assert events == ref_events and len(events) > 0
    assert (port.ue_joins, port.ue_departures, port.label_drifts) == \
        (ref.ue_joins, ref.ue_departures, ref.label_drifts)
    np.testing.assert_array_equal(port.active, ref.active)
    np.testing.assert_array_equal(port.alive_s, ref.alive_s)
    for ue in range(12):
        for t in (0.0, 2.0, 20.0):
            assert port.was_alive(ue, t) == ref.was_alive(ue, t)
    kinds = {k for _, k, _ in events}
    assert kinds <= {JOIN, LEAVE, DRIFT, FLASH}


def test_runtime_units():
    assert make_scenario(ScenarioConfig(), 8, seed=0) is None
    scen = ScenarioRuntime(ScenarioConfig(enabled=True), 6, seed=0)
    assert scen.alive_total(12.34567) == 6 * 12.34567
    assert int(ScenarioRuntime(ScenarioConfig(
        enabled=True, initial_active_frac=0.0), 10, seed=1).active.sum()) == 1
    floor = ScenarioRuntime(ScenarioConfig(
        enabled=True, departure_rate=5.0, min_active=3, horizon_s=100.0),
        8, seed=0)
    _drain(floor)
    assert int(floor.active.sum()) == 3
    wave = ScenarioRuntime(ScenarioConfig(
        enabled=True, arrival_rate=1.0, diurnal_amplitude=0.5,
        diurnal_period_s=4.0, flash_time_s=10.0, flash_duration_s=1.0,
        flash_arrival_boost=3.0), 4, seed=0)
    assert wave.arrival_intensity(1.0) == pytest.approx(1.5)
    assert wave.arrival_intensity(10.5) == pytest.approx(
        3.0 * (1.0 + 0.5 * np.sin(2 * np.pi * 10.5 / 4.0)))
    with pytest.raises(ValueError):
        ScenarioRuntime(ScenarioConfig(enabled=True, diurnal_amplitude=1.5),
                        4, seed=0)


def test_drift_labels_match_reference():
    ref_clients, port_clients = clients_pair(4, data_n=640, data_seed=3)
    for rc, pc in zip(ref_clients, port_clients):
        got = pc.drift_labels(np.random.default_rng(123), frac=0.4)
        want = rc.drift_labels(np.random.default_rng(123), frac=0.4)
        assert got == want
        np.testing.assert_array_equal(pc.data["y"], rc.data["y"])
        np.testing.assert_array_equal(pc.test["y"], rc.test["y"])


# ---------------------------------------------------------------------------
# the registry's five scenarios on the 3-cell hierarchy, end to end
# ---------------------------------------------------------------------------

def _registry():
    """The reference's registry as the port's ``ScenarioConfig``s."""
    return {name: ScenarioConfig(**dataclasses.asdict(sc))
            for name, sc in scenario_registry().items()}


def test_registry_converts_to_port_configs():
    reg = _registry()
    assert sorted(reg) == ["churn", "diurnal", "drift", "flash_crowd",
                           "static"]
    assert not reg["static"].enabled and reg["drift"].drift_rate > 0


@pytest.mark.parametrize("policy", ["equal", "theorem2"])
@pytest.mark.parametrize("name", ["static", "churn", "diurnal",
                                  "flash_crowd", "drift"])
def test_registry_scenario_matches_reference(name, policy):
    """The registry's rates with the arrival and departure rates raised
    eightfold, so that every shape fires inside this run's few simulated
    seconds (the reference's own smoke boosts its churn the same way)."""
    sc = dataclasses.asdict(scenario_registry()[name])
    if sc["enabled"]:
        sc.update(arrival_rate=8 * sc["arrival_rate"],
                  departure_rate=8 * sc["departure_rate"],
                  min_active=4)
    ref, ref_params, port = run_pair(
        N_UES, 4, 4, data_n=640, data_seed=3,
        cfg_kw=dict(mob=_HIER, scen=sc, batch=4, first_order=True),
        algorithm="perfed", mode="semi", bandwidth_policy=policy,
        max_rounds=6, eval_every=3, seed=0)
    hold_pair(ref, ref_params, port)
    assert port.pi.shape[0] == 6 and port.aborted_rounds == 0
    if name in ("churn", "diurnal", "flash_crowd"):
        assert port.ue_joins > 0 or port.ue_departures > 0
    if name == "drift":
        assert port.label_drifts > 0


# ---------------------------------------------------------------------------
# bitwise discipline and lifecycle fixes
# ---------------------------------------------------------------------------

def _port_run(cfg, *, rounds, policy="equal", n=N_UES, seed=0, **kw):
    _, clients = clients_pair(n, data_n=640, data_seed=3)
    return run_simulation(cfg, port_model(ref_init(seed)), clients,
                          algorithm="perfed", mode="semi",
                          bandwidth_policy=policy, max_rounds=rounds,
                          eval_every=0, seed=seed, device="cpu", **kw)


def _fingerprint(res):
    return (res.pi.tobytes(), float(res.total_time).hex(),
            res.eta_realised.tobytes(), float(res.wait_fraction).hex(),
            res.handovers, res.cloud_rounds)


@pytest.mark.parametrize("mob", [None, _HIER], ids=["static", "hierarchy"])
def test_zero_rate_enabled_scenario_is_bitwise_closed_world(mob):
    kw = dict(mob=mob, batch=4, first_order=True)
    closed = _port_run(cfg_pair(N_UES, 4, 4, **kw)[1], rounds=5)
    opened = _port_run(cfg_pair(N_UES, 4, 4, scen=dict(enabled=True),
                                **kw)[1], rounds=5)
    assert _fingerprint(closed) == _fingerprint(opened)
    assert opened.ue_joins == opened.ue_departures == 0
    for a, b in zip(closed.params.values(), opened.params.values()):
        for x, y in zip(a.values(), b.values()):
            assert x.equal(y)


_DRAIN_CHURN = dict(enabled=True, arrival_rate=0.0, departure_rate=1.5,
                    min_active=4, horizon_s=100.0)


def test_adaptive_clamp_against_frozen_cell_a_matches_reference():
    """Departures only, frozen per-cell A: a shrunken cell starves and the
    run aborts with pending uploads; the adaptive clamp completes it.  Both
    runs are held against the reference."""
    mob = dict(_HIER, speed_mps=10.0, cell_participants=3,
               cloud_sync_every=3)
    kw = dict(mob=mob, batch=4, first_order=True)
    run = dict(algorithm="perfed", mode="semi", bandwidth_policy="equal",
               max_rounds=8, eval_every=0, seed=0)
    legacy = run_pair(N_UES, 4, 4, data_n=640, data_seed=3,
                      cfg_kw=dict(kw, scen=dict(_DRAIN_CHURN,
                                                adaptive_cell_a=False)),
                      **run)
    hold_pair(*legacy)
    assert legacy[2].pi.shape[0] < 8 and legacy[2].aborted_rounds > 0
    assert legacy[2].pending_uploads > 0
    fixed = run_pair(N_UES, 4, 4, data_n=640, data_seed=3,
                     cfg_kw=dict(kw, scen=_DRAIN_CHURN), **run)
    hold_pair(*fixed)
    assert fixed[2].pi.shape[0] == 8 and fixed[2].aborted_rounds == 0
    assert fixed[2].ue_departures > 0
    assert 0.0 <= fixed[2].wait_fraction <= 1.0


def test_heap_exhaustion_counts_aborted_round_and_warns(capsys):
    res = _port_run(cfg_pair(3, 5, 4, batch=4, first_order=True)[1],
                    rounds=2, n=3)
    assert res.pi.shape[0] == 0
    assert (res.aborted_rounds, res.pending_uploads) == (1, 3)
    assert "WARNING" in capsys.readouterr().out


def test_empty_cell_resets_theorem2_warm_start():
    cfg = cfg_pair(N_UES, 4, 4, mob=dict(_HIER, cell_participants=3),
                   batch=4, first_order=True)[1]
    adapter = MobileAdapter(cfg, N_UES, seed=0, bandwidth_policy="theorem2",
                            mode="semi")
    adapter.net.active = np.zeros(N_UES, dtype=bool)   # cell 0 emptied
    adapter._t_star[0] = 3.21
    adapter._realloc(0)
    assert adapter._t_star[0] == 0.0


def test_churn_run_is_seed_deterministic():
    scen = dict(enabled=True, initial_active_frac=0.75, arrival_rate=3.0,
                departure_rate=0.3, min_active=4, drift_rate=0.5)
    cfg = cfg_pair(N_UES, 4, 4, mob=_HIER, scen=scen, batch=4,
                   first_order=True)[1]
    a, b = (_port_run(cfg, rounds=6) for _ in range(2))
    assert _fingerprint(a) == _fingerprint(b)
    assert (a.ue_joins, a.ue_departures, a.label_drifts) == \
        (b.ue_joins, b.ue_departures, b.label_drifts)
