"""The port's per-round recorder (``obs/recorder.py``) and metrics files
(``utils/metrics.py``) vs the JAX reference.

* a traced run's records carry the reference's per-round protocol fields
  (round, cell, A_c, arrived UEs, distribution, staleness histogram, heap
  depth, simulated time, dispatch and handover deltas) exactly, and its
  JSONL passes the reference's ``validate_rows`` and the unmodified
  ``scripts/trace_report.py --check``;
* tracing on or off leaves the trajectory bitwise unchanged, on the static
  golden and on the moving hierarchy;
* ``MetricsLogger`` files read back in either package, ``_plain`` coerces
  torch tensors as the reference coerces jax arrays, and the recorder's
  helpers (histogram, row split, validation) match the reference's.
"""
import copy
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_mobility import (cfg_pair, clients_pair, port_model, ref_init,
                                 run_ref)

from repro.obs import Tracer as RefTracer
from repro.obs import recorder as ref_recorder
from repro.utils import metrics as ref_metrics
from repro_torch.obs import Tracer, validate_rows
from repro_torch.fl.simulation import run_simulation
from repro_torch.obs.recorder import (REQUIRED_KEYS, SCHEMA, split_rows,
                                      staleness_histogram)
from repro_torch.utils.metrics import (ARRAY_ELEMS_CAP, MetricsLogger, _plain,
                                       read_metrics)

ROOT = Path(__file__).resolve().parents[1]

_HIER = dict(enabled=True, model="random_waypoint", speed_mps=150.0,
             n_cells=3, hierarchy=True, cloud_sync_every=3, step_s=0.05)
_RUN = dict(algorithm="perfed", mode="semi", bandwidth_policy="equal",
            max_rounds=6, eval_every=3, seed=0)

# per-round fields that are protocol facts, the same in both packages
_EXACT = ("round", "cell", "a", "ues", "distributed", "staleness_hist",
          "heap_depth", "t_sim", "dispatches", "payloads", "eval_dispatches",
          "handovers", "departed_arrivals", "cloud_rounds")


@pytest.fixture(scope="module")
def traced_pair(tmp_path_factory):
    """The moving 3-cell hierarchy traced (with JSONL) in both packages."""
    ref_cfg, port_cfg = cfg_pair(24, 6, 4, mob=_HIER, first_order=True)
    ref_clients, port_clients = clients_pair(24, seed=1, data_n=600)
    ref_dir = tmp_path_factory.mktemp("ref_trace")
    port_dir = tmp_path_factory.mktemp("port_trace")
    ref, _ = run_ref(ref_cfg, ref_clients, tracer=RefTracer(device=True),
                     trace_dir=str(ref_dir), **_RUN)
    port = run_simulation(port_cfg, port_model(ref_init(0)), port_clients,
                          device="cpu", tracer=Tracer(device=True),
                          trace_dir=str(port_dir), **_RUN)
    return (ref, read_metrics(ref.telemetry["trace_path"]),
            port, read_metrics(port.telemetry["trace_path"]))


def test_trace_records_match_reference(traced_pair):
    ref, ref_rows, port, rows = traced_pair
    meta, recs, summary = split_rows(rows)
    ref_meta, ref_recs, ref_summary = ref_recorder.split_rows(ref_rows)
    assert meta == ref_meta and meta["schema"] == SCHEMA
    assert len(recs) == len(ref_recs) == 6
    for got, want in zip(recs, ref_recs):
        assert set(REQUIRED_KEYS) <= set(got)
        for k in _EXACT:
            assert got[k] == want[k], k
    assert sum(r["handovers"] for r in recs) == port.handovers > 0
    assert sum(r["cloud_rounds"] for r in recs) == port.cloud_rounds == 2
    for k in ("rounds", "arrivals", "per_cell_a", "n_cells", "handovers",
              "cloud_rounds", "departed_arrivals"):
        assert summary[k] == ref_summary[k], k
    assert port.telemetry["trace_path"].endswith("metrics.jsonl")
    assert port.telemetry["counts"]["driver.rounds_batchwise"] == \
        ref.telemetry["counts"]["driver.rounds_batchwise"]


def test_port_trace_passes_both_validators(traced_pair):
    _, ref_rows, port, rows = traced_pair
    assert validate_rows(rows) == []
    assert ref_recorder.validate_rows(rows) == []
    assert validate_rows(ref_rows) == []
    out = subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "trace_report.py"),
         port.telemetry["trace_path"], "--check"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stdout + out.stderr
    assert "OK" in out.stdout


def test_validate_rows_catches_corruption(traced_pair):
    _, _, _, rows = traced_pair
    bad = copy.deepcopy(rows)
    del bad[0]["_meta"]["schema"]
    assert any("schema" in e for e in validate_rows(bad))
    bad = copy.deepcopy(rows)
    bad[1]["a"] += 1
    assert any("inconsistent" in e for e in validate_rows(bad))
    bad = copy.deepcopy(rows)
    bad[1]["phase_s"] = {"drain": bad[1]["wall_s"] * 10}
    assert any("exceed" in e for e in validate_rows(bad))
    bad = copy.deepcopy(rows)
    bad[1]["cell_members"] = [3, -1]
    assert validate_rows(bad) == ref_recorder.validate_rows(bad) != []
    assert validate_rows([]) != []


def test_tracing_leaves_the_trajectory_bitwise(traced_pair, tmp_path):
    """Moving hierarchy untraced vs the traced run above, and the static
    golden traced with device timing and JSONL."""
    _, _, traced, _ = traced_pair
    _, port_cfg = cfg_pair(24, 6, 4, mob=_HIER, first_order=True)
    plain = run_simulation(port_cfg, port_model(ref_init(0)),
                           clients_pair(24, seed=1, data_n=600)[1],
                           device="cpu", **_RUN)
    for field in ("times", "losses", "global_losses", "pi"):
        np.testing.assert_array_equal(getattr(plain, field),
                                      getattr(traced, field))
    assert (plain.handovers, plain.payload_dispatches) == \
        (traced.handovers, traced.payload_dispatches)
    for a, b in zip(plain.params.values(), traced.params.values()):
        for x, y in zip(a.values(), b.values()):
            assert x.equal(y)
    assert plain.telemetry is None

    _, cfg = cfg_pair(8, 3, 3)
    res = run_simulation(cfg, port_model(ref_init(0)),
                         clients_pair(8, data_n=600)[1], algorithm="perfed",
                         mode="semi", max_rounds=6, eval_every=2, seed=0,
                         device="cpu", tracer=Tracer(device=True),
                         trace_dir=str(tmp_path))
    assert float(res.total_time).hex() == "0x1.4066315c4298cp+1"
    assert res.pi.tolist()[0] == [1, 0, 0, 1, 0, 0, 0, 1]
    t = res.telemetry
    assert t["rounds"] == 6 and t["arrivals"] == 18
    assert t["counts"]["driver.rounds_fused"] == 6
    assert validate_rows(read_metrics(t["trace_path"])) == []


def test_cfg_obs_enables_tracing(tmp_path):
    _, cfg = cfg_pair(8, 3, 3)
    cfg = dataclasses.replace(cfg, obs=dataclasses.replace(
        cfg.obs, trace=True, trace_dir=str(tmp_path)))
    res = run_simulation(cfg, port_model(ref_init(0)),
                         clients_pair(8, data_n=600)[1], max_rounds=3,
                         eval_every=0, seed=0, device="cpu")
    assert res.telemetry is not None
    assert validate_rows(read_metrics(res.telemetry["trace_path"])) == []


def test_verbose_progress_lines_name_the_cell(capsys):
    """``verbose=True`` prints the reference's progress line, with the
    closing cell on the hierarchy."""
    _, cfg = cfg_pair(8, 3, 3)
    run_simulation(cfg, port_model(ref_init(0)),
                   clients_pair(8, data_n=600)[1], max_rounds=2,
                   eval_every=2, seed=0, device="cpu", verbose=True)
    out = capsys.readouterr().out
    assert "[perfed-semi] round    2 t=" in out and "ploss=" in out
    _, cfg = cfg_pair(24, 6, 4, mob=_HIER, first_order=True)
    run_simulation(cfg, port_model(ref_init(0)),
                   clients_pair(24, seed=1, data_n=600)[1], max_rounds=3,
                   eval_every=3, seed=0, device="cpu", verbose=True,
                   bandwidth_policy="equal")
    assert "[perfed-semi] cell=" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# recorder helpers and metrics files
# ---------------------------------------------------------------------------

def test_staleness_histogram_matches_reference():
    row = np.array([0, 1, 1, 99, -5, 3, 2**60])
    for cap in (4, 32):
        assert staleness_histogram(row, cap=cap) == \
            ref_recorder.staleness_histogram(row, cap=cap)
    assert staleness_histogram(np.array([0, 1, 1, 99, -5]), cap=4) == \
        [2, 2, 0, 0, 1]


def test_metrics_files_cross_read(tmp_path):
    """The port writes what the reference reads, and the reverse."""
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    with MetricsLogger(str(port_dir), meta={"arch": "mnist_dnn"}) as log:
        log.log(step=0, loss=torch.tensor(2.5), hist=torch.arange(3),
                big=torch.zeros(ARRAY_ELEMS_CAP + 1), acc=float("nan"),
                nested={"a": torch.tensor(3, dtype=torch.int32)})
        log.log(step=1, loss=np.float64(2.25))
    with ref_metrics.MetricsLogger(str(ref_dir),
                                   meta={"arch": "mnist_dnn"}) as log:
        log.log(step=0, loss=jnp.float32(2.5), hist=jnp.arange(3),
                big=jnp.zeros(ARRAY_ELEMS_CAP + 1), acc=float("nan"),
                nested={"a": jnp.int32(3)})
        log.log(step=1, loss=np.float64(2.25))
    for d in (port_dir, ref_dir):
        path = str(d / "metrics.jsonl")
        rows, ref_rows = read_metrics(path), ref_metrics.read_metrics(path)
        assert rows == ref_rows
    got = [{k: v for k, v in r.items() if k != "t"}
           for r in read_metrics(str(port_dir / "metrics.jsonl"))]
    want = [{k: v for k, v in r.items() if k != "t"}
            for r in read_metrics(str(ref_dir / "metrics.jsonl"))]
    assert got == want
    assert got[1]["hist"] == [0, 1, 2] and got[1]["acc"] is None
    assert got[1]["big"] == {"shape": [ARRAY_ELEMS_CAP + 1],
                             "dtype": "float32",
                             "size": ARRAY_ELEMS_CAP + 1}


def test_plain_matches_reference_on_numpy():
    for v in (np.array([1, 2, 3]), np.array([[1.5, float("nan")], [0.0, 2.0]]),
              {"v": np.arange(2)}, np.zeros((4, ARRAY_ELEMS_CAP)),
              np.zeros(ARRAY_ELEMS_CAP), np.float32(1.25), [np.int64(3)]):
        assert _plain(v) == ref_metrics._plain(v)
    assert _plain(torch.zeros(2, 3, dtype=torch.float64)) == [[0.0] * 3] * 2


def test_metrics_logger_appends(tmp_path):
    MetricsLogger(str(tmp_path)).log(step=0, x=1)
    MetricsLogger(str(tmp_path)).log(step=1, x=2)
    rows = read_metrics(str(tmp_path / "metrics.jsonl"))
    assert [r["x"] for r in rows] == [1, 2]
