"""Structured tracing for the simulator stack (near-zero disabled cost).

One substrate replaces the scattered ad-hoc timing that used to live in
one-off monkey patches (``benchmarks/event_loop.py``'s hand-rolled
``perf_counter`` guards around engine/protocol dispatches): a ``Tracer``
with

* **nestable phase spans** — ``with tracer.span("pricing"): ...``
  accumulates *exclusive* host seconds per phase (a child span's time is
  subtracted from its parent), so ``sum(phase_s.values())`` can never
  exceed the run's wall clock;
* **monotonic counters** — ``tracer.add("mobility.ticks", 3)``;
* **device attribution** — ``tracer.device_call("engine", fn, *args)``
  runs ``fn`` and, when ``device_timing`` is on, blocks on its output and
  books the elapsed time as *device* seconds under the given name
  (reentrancy-guarded: the fused round path runs the engine INSIDE the
  protocol call, and only the outermost timed frame may accumulate, or
  device time double-counts — the guard that used to be
  ``benchmarks/event_loop._SPLIT_GUARD``).

**Disabled fast path.** ``CURRENT`` is a module-level singleton that
defaults to ``NOOP`` — a tracer whose ``span`` returns one shared no-op
context manager and whose ``add``/``device_call`` do nothing.  Hot-loop
call sites read ``trace.CURRENT`` (one attribute fetch) and pay a couple
of empty method calls; no allocation, no branching on config, no timing
syscalls.  The per-heap-pop path of the event loop deliberately contains
NO tracing calls at all — mobility integration is instrumented inside its
(rare) tick branch instead.

**Read-only contract.** Nothing in the simulator reads wall-clock time
into the simulation (the simulated clock is pure event math), so tracing
— including the blocking device guard — can never perturb a trajectory:
all bitwise golden tests pass with tracing fully enabled
(``tests/test_obs.py``).

``torch.profiler`` hooks: a ``Tracer(profile=True)`` wraps every span in
a ``torch.profiler.record_function`` so spans show up on the profiler's
timeline, and ``profile_trace(logdir)`` brackets a run with a
``torch.profiler.profile`` and writes its Chrome trace under ``logdir``.

A port of the JAX package's ``obs/trace.py``: the blocking device guard
waits with ``torch.cuda.synchronize()`` where the reference calls
``jax.block_until_ready``.
"""
from __future__ import annotations

import os
import sys
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, Optional

import torch

__all__ = ["Tracer", "NoopTracer", "Reporter", "NOOP", "CURRENT",
           "current", "use", "profile_trace"]


# ---------------------------------------------------------------------------
# disabled fast path
# ---------------------------------------------------------------------------

class _NoopSpan:
    """The one shared no-op context manager every disabled span returns."""
    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


_NOOP_SPAN = _NoopSpan()


class NoopTracer:
    """Disabled tracer: every call site costs one attribute check."""
    __slots__ = ()
    enabled = False
    device_timing = False

    def span(self, name: str) -> _NoopSpan:
        return _NOOP_SPAN

    def add(self, name: str, n: int = 1) -> None:
        return None

    def device_call(self, name: str, fn: Callable, *args: Any,
                    **kw: Any) -> Any:
        return fn(*args, **kw)

    def snapshot(self) -> Dict[str, Any]:
        return {"phase_s": {}, "counts": {}, "device_s": 0.0,
                "device_phase_s": {}}


NOOP = NoopTracer()

# module-level singleton: instrumentation sites read ``trace.CURRENT``
# directly; ``use()`` installs a live tracer for the duration of a run
CURRENT: Any = NOOP


def current() -> Any:
    """The tracer instrumentation sites currently feed (NOOP when off)."""
    return CURRENT


@contextmanager
def use(tracer: Optional["Tracer"]) -> Iterator[Any]:
    """Install ``tracer`` as the process-wide ``CURRENT`` for the block."""
    global CURRENT
    prev = CURRENT
    CURRENT = tracer if tracer is not None else NOOP
    try:
        yield CURRENT
    finally:
        CURRENT = prev


# ---------------------------------------------------------------------------
# live tracer
# ---------------------------------------------------------------------------

class _Span:
    """One phase frame; exclusive-time accounting via the tracer stack."""
    __slots__ = ("tr", "name", "t0", "child_s", "_ann")

    def __init__(self, tr: "Tracer", name: str):
        self.tr = tr
        self.name = name

    def __enter__(self) -> "_Span":
        self.child_s = 0.0
        self._ann = None
        if self.tr.profile:
            self._ann = torch.profiler.record_function(self.name)
            self._ann.__enter__()
        self.tr._stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: Any) -> bool:
        dt = time.perf_counter() - self.t0
        tr = self.tr
        tr._stack.pop()
        phase = tr.phase_s
        # exclusive: child spans (and blocking device frames) already own
        # their share of ``dt``
        phase[self.name] = phase.get(self.name, 0.0) \
            + max(dt - self.child_s, 0.0)
        if tr._stack:
            tr._stack[-1].child_s += dt
        if self._ann is not None:
            self._ann.__exit__(*exc)
        return False


class Tracer:
    """Span/counter/device-time accumulator for one (or more) runs.

    ``device=True`` turns on the blocking device guard: every
    ``device_call`` blocks until its output is ready and the elapsed time
    is booked as device seconds (host seconds = wall − device).  Off by
    default — tracing then never forces synchronization, and
    ``device_s`` stays 0 (async dispatch overlap makes an unblocked split
    meaningless).

    ``profile=True`` additionally wraps spans in
    ``torch.profiler.record_function`` — pair with ``profile_trace(logdir)``
    for a Chrome-trace timeline.
    """
    enabled = True

    def __init__(self, *, device: bool = False, profile: bool = False):
        self.device_timing = bool(device)
        self.profile = bool(profile)
        self.phase_s: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.device_s = 0.0
        self.device_phase_s: Dict[str, float] = {}
        self._stack: list = []
        self._dev_depth = 0

    # -- spans ----------------------------------------------------------
    def span(self, name: str):
        if self._dev_depth:
            # inside a blocking device frame every second is already
            # attributed to that frame — a host span here would double-
            # book (e.g. ``cloud_sync`` under the ``protocol`` guard)
            return _NOOP_SPAN
        return _Span(self, name)

    # -- counters -------------------------------------------------------
    def add(self, name: str, n: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + int(n)

    # -- device attribution --------------------------------------------
    def device_call(self, name: str, fn: Callable, *args: Any,
                    **kw: Any) -> Any:
        """Run ``fn`` and attribute its wall time (including blocking on
        its output) to device seconds under ``name``.  Nested timed
        frames pass through untimed — only the outermost accumulates."""
        if not self.device_timing or self._dev_depth:
            return fn(*args, **kw)
        self._dev_depth += 1
        t0 = time.perf_counter()
        try:
            out = fn(*args, **kw)
            # CPU tensors are computed eagerly; CUDA work is awaited here
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            return out
        finally:
            self._dev_depth -= 1
            dt = time.perf_counter() - t0
            self.device_s += dt
            self.device_phase_s[name] = \
                self.device_phase_s.get(name, 0.0) + dt
            if self._stack:
                # device time spent inside an open span is not that
                # span's host time
                self._stack[-1].child_s += dt

    # -- snapshots ------------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        """Copy of all accumulators (the recorder diffs these per round)."""
        return {"phase_s": dict(self.phase_s),
                "counts": dict(self.counts),
                "device_s": self.device_s,
                "device_phase_s": dict(self.device_phase_s)}


@contextmanager
def profile_trace(logdir: Optional[str]) -> Iterator[None]:
    """Bracket a run with ``torch.profiler.profile`` (CPU, plus CUDA when a
    card is present) and write its Chrome trace to ``logdir/trace.json``.
    A falsy ``logdir`` is a no-op; a profiler that fails raises."""
    if not logdir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# ---------------------------------------------------------------------------
# leveled progress reporting
# ---------------------------------------------------------------------------

_LEVELS = {"quiet": 0, "progress": 1, "debug": 2}


class Reporter:
    """Leveled run reporter replacing the driver's ad-hoc ``print``.

    ``quiet`` emits nothing, ``progress`` the per-eval summary lines the
    old ``verbose=True`` printed (byte-identical format), ``debug``
    additionally per-round close diagnostics.
    """

    def __init__(self, level: str = "quiet", stream: Any = None):
        if level not in _LEVELS:
            raise ValueError(f"unknown report level {level!r}; "
                             f"known: {sorted(_LEVELS)}")
        self.level = _LEVELS[level]
        self.stream = stream

    def _emit(self, msg: str) -> None:
        print(msg, file=self.stream or sys.stdout, flush=True)

    def warn(self, msg: str) -> None:
        """Anomaly reporting (aborted rounds, invariant near-misses):
        emitted at every level including ``quiet`` — losing work silently
        is exactly the failure mode this exists to surface."""
        self._emit(f"WARNING: {msg}")

    def progress(self, msg: str) -> None:
        if self.level >= _LEVELS["progress"]:
            self._emit(msg)

    def debug(self, msg: str) -> None:
        if self.level >= _LEVELS["debug"]:
            self._emit(msg)
