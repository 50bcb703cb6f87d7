"""A run of each cell driven on the CPU at a tiny size: the result line's
keys, planted faults in the timed path that must make ``correct`` false,
the fp8 control that must fail a limit, the run without a card, and the
modules a run loads."""
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from portbench import harness  # noqa: E402

TINY_AUDIO = dict(num_layers=1, d_model=32, num_heads=2, num_kv_heads=2,
                  d_ff=64, vocab_size=32, dtype="float32", remat=False)
TINY = {
    "eval.musicgen-large": (TINY_AUDIO, dict(users=4, check_users=3,
                                             positions=24, pool=2,
                                             warm_calls=1, trace_units=1)),
    # untied: the tied head's 0.02 draws at width 32 give logits of
    # about 0.1, flatter than the card's cell (about 0.64 at width 1,024)
    "eval.mamba2-370m": (dict(num_layers=1, d_model=32, vocab_size=32,
                              tie_embeddings=False,
                              dtype="float32", remat=False,
                              ssm=dict(state_dim=8, head_dim=8, expand=2,
                                       chunk_size=8, conv_width=4)),
                         dict(users=4, check_users=3, positions=20, pool=2,
                              warm_calls=1, trace_units=1)),
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_run(workload, trace=False, seed=2**31 + 9):
    cfg, traffic = TINY[workload]
    return harness.run_cell(ROOT, workload, seed, 0.05, trace,
                            t_start=time.perf_counter(), dev="cpu",
                            cfg_override=cfg, traffic_override=traffic,
                            log=lambda *a: None)


@pytest.mark.parametrize("workload, trace", [
    ("eval.musicgen-large", False), ("eval.mamba2-370m", True)])
def test_result_line(workload, trace):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    r = tiny_run(workload, trace)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    for key in ("platform", "kind", "count", "memory_peak_bytes"):
        assert key in r["device"]
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
        allowed = {m["name"] for m in bench["per_layer"]
                   if workload in m["workloads"]}
        assert set(r["metrics"]) <= allowed
    else:
        want = {m["name"] for m in bench["end_to_end"]
                if workload in m.get("workloads", [workload])}
        assert set(r["metrics"]) == want
        assert all(m["value"] > 0 for m in r["metrics"].values())


def _patch(monkeypatch, method, change):
    """Every model's ``method`` (``predict``, which scoring times) goes
    through ``change(run, batch)``, ``run`` being the original on a
    batch."""
    from repro_torch.models.audio import AudioLM
    from repro_torch.models.ssm import Mamba2LM
    from repro_torch.models.transformer import TransformerLM
    for cls in (TransformerLM, AudioLM, Mamba2LM):
        if method not in vars(cls):
            continue
        orig = vars(cls)[method]

        def patched(self, params, batch, rng=None, orig=orig):
            return change(lambda b: orig(self, params, b), batch)
        monkeypatch.setattr(cls, method, patched)


def _half_batch(run, batch):
    """Half of the batch left out: the first half's rows stand for all.
    Three of four rows are checked, so one checked row is in the half
    left out."""
    n = batch["tokens"].shape[0]
    half = run({k: v[:max(1, n // 2)] for k, v in batch.items()})
    return half.repeat((2,) + (1,) * (half.dim() - 1))[:n]


def _answer_altered(run, batch):
    """One position's answer altered where it is produced, in each
    user's stream (the check compares the rows drawn from the seed)."""
    out = run(batch).clone()
    out[:, 0] = out[:, 0].roll(1, dims=-1)
    return out


@pytest.mark.parametrize("workload, fault", [
    ("eval.musicgen-large", "half_batch"),
    ("eval.musicgen-large", "answer_altered"),
    ("eval.mamba2-370m", "half_batch"),
    ("eval.mamba2-370m", "answer_altered")])
def test_planted_fault_is_not_correct(monkeypatch, workload, fault):
    _patch(monkeypatch, "predict", {"half_batch": _half_batch,
                                    "answer_altered": _answer_altered}[fault])
    assert tiny_run(workload)["correct"] is False


@pytest.mark.parametrize("workload", sorted(TINY))
def test_fp8_control_fails_a_limit(workload):
    from portbench.kinds import score
    cell, cfg, traffic, limits, _, _ = harness.load_cell(ROOT, workload)
    over_cfg, over_traffic = TINY[workload]
    cfg, traffic = {**cfg, **over_cfg}, {**traffic, **over_traffic}
    port = harness.import_port(ROOT)
    ctx = harness.Ctx(torch, port, "cpu", 3, cfg, traffic,
                      port.model_config(cfg), lambda: None)
    read = score.start(ctx).readings(limits, control=True)
    assert all(read["program"][k] <= limits.get(k, 0.0)
               for k in read["program"])
    assert any(read["control"][k] > limits.get(k, 0.0)
               for k in read["control"])


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         "eval.musicgen-large", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.fixture(scope="module")
def loaded():
    """A fresh process: the references imported, then a tiny run."""
    code = f"""
import json, sys, time
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
import portbench.reference.audio_lm, portbench.reference.mamba2
ref = sorted(m for m in sys.modules if m.split(".")[0] == "repro_torch")
from portbench import harness
harness.run_cell(harness.Path({str(ROOT)!r}), "eval.musicgen-large", 1,
                 0.05, False, t_start=time.perf_counter(), dev="cpu",
                 cfg_override={TINY_AUDIO!r},
                 traffic_override={TINY["eval.musicgen-large"][1]!r},
                 log=lambda *a: None)
print(json.dumps({{"reference": ref, "run": harness.forbidden_modules()}}))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_references_import_nothing_of_the_program(loaded):
    assert loaded["reference"] == []


def test_a_run_loads_neither_jax_nor_the_jax_package(loaded):
    assert loaded["run"] == []
