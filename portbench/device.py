"""The card: the check that it is there, its name, and the reading of a
``torch.profiler`` trace (device busy time, time by kernel, idle gaps by
what the host was doing)."""
from __future__ import annotations

import gzip
import json
import os
import subprocess
import sys
from bisect import bisect_right
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

WINDOW = "portbench_window"          # the traced window's annotation
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
MIN_GAP_US = 2.0                     # gaps shorter than this are not named


def require_cards(torch, chips: int) -> None:
    """Exit with a message (code 1, no result) unless CUDA is there with
    ``chips`` cards."""
    if not torch.cuda.is_available():
        sys.exit("portbench: torch.cuda.is_available() is false; this "
                 "benchmark measures the card and prints no result without "
                 "one")
    if torch.cuda.device_count() < chips:
        sys.exit(f"portbench: the cell asks for {chips} cards, "
                 f"torch.cuda.device_count() is "
                 f"{torch.cuda.device_count()}")


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.splitlines()[0] if out else "nvidia-smi printed nothing"


@dataclass
class Trace:
    """What the device did in the traced window."""
    window_s: float
    busy_s: float
    kernels: Dict[str, Tuple[float, int]] = field(default_factory=dict)
    device_ops: List[List] = field(default_factory=list)
    idle_gaps: List[List] = field(default_factory=list)

    def seconds(self, parts: Tuple[str, ...]) -> Tuple[float, int]:
        """Device seconds and launches of the kernels whose name holds one
        of ``parts``."""
        s = n = 0
        for name, (sec, cnt) in self.kernels.items():
            if any(p in name for p in parts):
                s += sec
                n += cnt
        return s, n


def traced(torch, fn: Callable[[], None], path: str) -> Trace:
    """Run ``fn`` (which synchronises at its end) under the profiler, CPU
    and CUDA, write the trace to ``path`` and read it."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(WINDOW):
            fn()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    prof.export_chrome_trace(path)
    return read_trace(path)


def _load(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def _union(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _innermost(host: List[dict], points: List[float]) -> List[str]:
    """For each time in ``points``: the name of the shortest host event
    (any thread) that covers it, or "host (no event)"."""
    by_tid: Dict[object, List[dict]] = {}
    for e in host:
        by_tid.setdefault(e.get("tid"), []).append(e)
    best = [(float("inf"), "host (no event)")] * len(points)
    for evs in by_tid.values():
        evs.sort(key=lambda e: e["ts"])
        starts = [e["ts"] for e in evs]
        ends = [e["ts"] + e["dur"] for e in evs]
        for i, t in enumerate(points):
            j = bisect_right(starts, t) - 1
            # nested events: walk back while an earlier one may still cover
            # t; stop after a bounded number of steps
            for k in range(j, max(j - 64, -1), -1):
                if ends[k] >= t and evs[k]["dur"] < best[i][0]:
                    best[i] = (evs[k]["dur"], evs[k]["name"])
    return [name for _, name in best]


def read_trace(path: str) -> Trace:
    events = _load(path)
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        raise RuntimeError(f"no '{WINDOW}' annotation in {path}")
    w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
    dev = [e for e in events if e.get("cat", "").lower() in DEVICE_CATS
           and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    spans = _union([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1))
                    for e in dev])
    busy = sum(e - s for s, e in spans)
    kernels: Dict[str, List[float]] = {}
    for e in dev:
        k = kernels.setdefault(e["name"], [0.0, 0])
        k[0] += e["dur"] * 1e-6
        k[1] += 1
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    # idle gaps inside the window, named by what the host was doing
    edges = [w0] + [x for s, e in spans for x in (s, e)] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] - edges[i] >= MIN_GAP_US]
    host = [e for e in events if e.get("cat", "").lower() in HOST_CATS
            and e.get("name") != WINDOW]
    names = _innermost(host, [(s + e) / 2 for s, e in gaps])
    idle: Dict[str, float] = {}
    for (s, e), name in zip(gaps, names):
        idle[name] = idle.get(name, 0.0) + (e - s) * 1e-6
    return Trace(
        window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
        kernels={k: (v[0], int(v[1])) for k, v in kernels.items()},
        device_ops=[[k[:160], v[0]] for k, v in top],
        idle_gaps=[[k[:160], v] for k, v in sorted(
            idle.items(), key=lambda kv: -kv[1])[:10]])
