"""Simulator observability: tracing, per-round telemetry, reporting.

``obs.trace``    — ``Tracer`` (nestable phase spans, counters, blocking
                   device attribution), the module-level no-op singleton
                   that makes disabled tracing near-free, the leveled
                   ``Reporter``, and the ``torch.profiler`` hooks.
``obs.recorder`` — per-round record assembly + JSONL schema validation.

Enable per run via ``run_simulation(..., tracer=Tracer())`` /
``trace_dir="runs/trace"``, or through ``ExperimentConfig.obs``.
"""
from repro_torch.obs.recorder import RoundRecorder, validate_rows
from repro_torch.obs.trace import (NOOP, NoopTracer, Reporter, Tracer, current,
                                   profile_trace, use)

__all__ = ["Tracer", "NoopTracer", "Reporter", "RoundRecorder", "NOOP",
           "current", "use", "profile_trace", "validate_rows"]
