"""JSONL metrics logging (training-run observability substrate).

Append-only, crash-safe (one flush per record), dependency-free:

    logger = MetricsLogger("runs/exp1")
    logger.log(step=10, loss=2.31, grad_norm=0.8)
    ...
    rows = read_metrics("runs/exp1/metrics.jsonl")

The port of the JAX package's ``utils/metrics.py``: the same JSONL, so
either package reads what the other writes.  ``_plain`` takes torch tensors
where the reference takes jax arrays.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional


class MetricsLogger:
    def __init__(self, run_dir: str, filename: str = "metrics.jsonl",
                 meta: Optional[Dict[str, Any]] = None):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, filename)
        self._f = open(self.path, "a", buffering=1)
        self._t0 = time.time()
        if meta:
            self._write({"_meta": _plain(meta)})

    def log(self, step: Optional[int] = None, **values) -> None:
        rec: Dict[str, Any] = {"t": round(time.time() - self._t0, 4)}
        if step is not None:
            rec["step"] = int(step)
        rec.update({k: _plain(v) for k, v in values.items()})
        self._write(rec)

    def _write(self, rec: Dict[str, Any]) -> None:
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# non-0-d arrays at or under this many elements serialise as (nested)
# lists; larger ones as a shape/dtype stub — a [16k]-UE vector logged by
# accident must not explode the JSONL
ARRAY_ELEMS_CAP = 64


def _plain(v: Any) -> Any:
    """Coerce torch/numpy scalars and containers to JSON-safe python."""
    if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
        return v.item()
    if hasattr(v, "ndim") and hasattr(v, "tolist"):
        # non-0-d ndarray/tensor: coerce small ones to lists, summarize
        # big ones
        if int(np_size(v)) <= ARRAY_ELEMS_CAP:
            return _plain(v.tolist())
        return {"shape": [int(s) for s in v.shape],
                "dtype": str(v.dtype).replace("torch.", ""), "size": int(np_size(v))}
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    if isinstance(v, float) and v != v:          # NaN → null
        return None
    return v


def np_size(v: Any) -> int:
    size = getattr(v, "size", None)
    if callable(size):                           # torch: size() is a shape
        return int(v.numel())
    if size is None:                             # duck-typed array
        size = 1
        for s in v.shape:
            size *= int(s)
    return int(size)


def read_metrics(path: str) -> List[Dict[str, Any]]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows
