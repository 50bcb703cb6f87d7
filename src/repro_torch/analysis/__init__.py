"""repro_torch.analysis — simlint for the PyTorch port.

The port of the JAX package's ``repro.analysis``: static AST checks for
the contracts the simulator relies on, recast for torch: RNG discipline
(SIM1xx: ``torch.Generator`` in place of JAX keys, numpy draw schedules
as they are), host syncs in hot-path modules (SIM2xx), purity of what a
``torch.func`` transform or an autograd ``Function`` runs (SIM3xx), and
the observability read-only contract (SIM4xx).

Run it as ``python -m repro_torch.analysis src/repro_torch`` (against
``simlint-torch-baseline.json`` at the repo root).
"""
from repro_torch.analysis.core import (
    Baseline,
    BaselineEntry,
    Finding,
    LintReport,
    lint_text,
    run_paths,
)

__all__ = [
    "Baseline",
    "BaselineEntry",
    "Finding",
    "LintReport",
    "lint_text",
    "run_paths",
]
