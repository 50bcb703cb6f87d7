"""One run of one cell: set-up, the measured (or traced) window, the check
against the plain reference, and the result line.

Everything a cell is made of is found by name: its entry in
``BENCHMARK.json``, its configuration file, ``traffic/<traffic>.json``
(whose ``kind`` names the module in ``kinds/`` that drives it),
``limits/<workload>.json`` and ``metrics/<metric>.py`` for each
per-layer metric that lists the cell.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Callable, Dict, Optional

from portbench import compare, device

FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
HERE = Path(__file__).resolve().parent


@dataclass
class Ctx:
    """What a kind is handed: torch, the port, the device and the cell."""
    torch: Any
    port: Any
    device: str
    seed: int
    cfg: Dict
    traffic: Dict
    model_cfg: Any
    sync: Callable[[], None]
    log: Callable[..., None] = lambda *a: None


def import_port(root: Path):
    """The program under test: the ``repro_torch`` package of the
    checkout."""
    sys.path.insert(0, str(root / "src"))
    from repro_torch.config import ModelConfig, SSMConfig
    from repro_torch.kernels import flash_attention, ssd_scan
    from repro_torch.models import build_model

    def model_config(cfg: Dict):
        names = {f.name for f in dataclasses.fields(ModelConfig)}
        kw = {k: v for k, v in cfg.items() if k in names and k != "ssm"}
        if "ssm" in cfg:
            kw["ssm"] = SSMConfig(**cfg["ssm"])
        return ModelConfig(**kw)

    return SimpleNamespace(
        model_config=model_config, build_model=build_model,
        counters={"flash_attention": flash_attention, "ssd_scan": ssd_scan})


def load_cell(root: Path, workload: str):
    """(cell entry, config dict, traffic dict, limits, end-to-end and
    per-layer entries that read this cell) for ``workload``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in "
                         f"BENCHMARK.json (have {sorted(cells)})")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    cfg = json.loads((root / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json")
                         .read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    moved = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"]
              if workload in m.get("workloads", [workload] if m["moves"]
                                   in moved else [])]
    return cell, cfg, traffic, limits, e2e, layers


def reader(name: str):
    """``metrics/<name>.py``'s ``read(trace, work)``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, *, t_start: float, dev: str = "cuda",
             cfg_override: Optional[Dict] = None,
             traffic_override: Optional[Dict] = None,
             log=lambda *a: print(*a, file=sys.stderr, flush=True)) -> Dict:
    """One run; returns the result line's object.  ``dev="cpu"`` (tests
    only) drives the same path on the CPU, with the card's readings
    absent."""
    import torch
    cell, cfg, traffic, limits, e2e, layers = load_cell(root, workload)
    cfg = {**cfg, **(cfg_override or {})}
    traffic = {**traffic, **(traffic_override or {})}
    port = import_port(root)
    on_card = dev == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    ctx = Ctx(torch, port, dev, seed, cfg, traffic, port.model_config(cfg),
              sync, lambda what: log(f"[portbench] {what} at "
                                     f"{time.perf_counter() - t_start:.3f} s"))
    for mod in port.counters.values():
        mod.LAUNCHES = 0
    run = kind.start(ctx)
    setup_s = time.perf_counter() - t_start
    launches0 = {k: m.LAUNCHES for k, m in port.counters.items()}
    out: Dict[str, Any] = {}
    if trace:
        # the same number of units untraced first: the model's share of
        # the peak is read on the host clock, without the profiler's cost
        n = traffic["trace_units"]
        t0 = time.perf_counter()
        for _ in range(n):
            run.step()
        plain = {"seconds": time.perf_counter() - t0, **run.work(n)}
        path = str(HERE / "out" / f"trace-{workload}.json")
        tr = device.traced(torch, lambda: [run.step() for _ in range(n)],
                           path)
        done = 2 * n
        work = {**run.work(n), "untraced": plain}
        metrics = {}
        for m in layers:
            value = reader(m["name"])(tr, work)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["breakdown"] = {"device_ops": tr.device_ops,
                            "idle_gaps": tr.idle_gaps}
        trace_dev = {"busy_s": tr.busy_s, "window_s": tr.window_s}
    else:
        lat = []
        t0 = time.perf_counter()
        while True:
            lat.append(run.step())
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        done = len(lat)
        values = run.end_to_end(lat, window_s)
        values["setup_s"] = (setup_s, "s")
        metrics = {m["name"]: {"value": values[m["name"]][0],
                               "unit": m["unit"]} for m in e2e}
        trace_dev = {}
        q = sorted(lat)
        log(f"[portbench] window {window_s:.3f} s, {done} {run.unit}s: "
            f"min {q[0]:.4f} s, median {q[len(q) // 2]:.4f} s, max "
            f"{q[-1]:.4f} s")
    launches = {k: m.LAUNCHES - launches0[k]
                for k, m in port.counters.items()}
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    log(f"[portbench] {workload}: set-up {setup_s:.3f} s; kernel launches "
        f"in the window {launches}; peak memory {peak} B")
    run.free()
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    checks, failed = run.check(limits)
    result = {
        "correct": bool(compare.judged(checks) and failed == 0),
        "attempted": done, "failed": failed, "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(0) if on_card
                            else "cpu"),
                   "count": cell["chips"] if on_card else 0,
                   "memory_peak_bytes": peak, **trace_dev},
    }
    result.update(out)
    result["checks"] = checks
    return result


def forbidden_modules():
    """Top-level names of loaded modules that the run may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
