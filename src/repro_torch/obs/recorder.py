"""Per-round telemetry records: assembly, JSONL flushing, validation.

``RoundRecorder`` sits in the event-loop driver and, at every round
close, diffs the live ``Tracer`` (and the engine's lifetime dispatch
counters) against the previous round's snapshot, assembling one
self-contained record:

    round index · closing cell · per-cell participation A_c (the arrived
    UE set) · staleness histogram at the close · heap depth · handover /
    departed-arrival deltas · dispatch counts by kind · per-phase host
    seconds · device seconds · wall seconds since the previous close

Records flush through ``utils.metrics.MetricsLogger`` (append-only JSONL,
one flush per record) when a trace directory is given, and an end-of-run
summary — totals plus the trace path — is attached to
``SimResult.telemetry`` either way.  ``validate_rows`` checks the schema
and the per-round invariants (phase seconds sum ≤ wall; Σ A_c = consumed
arrivals) and backs both ``scripts/trace_report.py --check`` and the unit
tests.

The port of the JAX package's ``obs/recorder.py`` with the same
``perfeds2-trace-v1`` schema, so the reference's ``trace_report.py --check``
validates the port's traces as they are.  Device seconds come from the
port's ``Tracer``, which synchronises the card where the reference blocks
on its outputs.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

SCHEMA = "perfeds2-trace-v1"

# keys every per-round record must carry (the JSONL contract
# ``scripts/trace_report.py --check`` enforces)
REQUIRED_KEYS = ("round", "cell", "a", "ues", "distributed",
                 "staleness_hist", "heap_depth", "t_sim", "wall_s",
                 "phase_s", "device_s", "dispatches", "payloads",
                 "eval_dispatches", "handovers", "departed_arrivals",
                 "cloud_rounds", "counts")

# staleness histogram cap: τ beyond this lands in the last bucket (the
# forced-refresh rule bounds live τ by S, so this never truncates in
# practice; hierarchy sentinel versions clip from below at 0)
STALE_HIST_CAP = 32


def _delta_map(now: Dict[str, float], then: Dict[str, float]
               ) -> Dict[str, float]:
    return {k: v - then.get(k, 0) for k, v in now.items()
            if v != then.get(k, 0)}


def staleness_histogram(stale_row: np.ndarray,
                        cap: int = STALE_HIST_CAP) -> List[int]:
    """Counts of UEs at each staleness 0..cap (τ ≥ cap folds into the
    last bucket; sentinel/negative values clip to 0)."""
    tau = np.clip(np.asarray(stale_row, dtype=np.int64), 0, cap)
    return np.bincount(tau, minlength=cap + 1).tolist()


class RoundRecorder:
    """Assemble one telemetry record per closed round by snapshot diffs."""

    def __init__(self, tracer: Any, engine: Any = None,
                 logger: Any = None):
        self.tracer = tracer
        self.engine = engine
        self.logger = logger
        self.records: List[Dict[str, Any]] = []
        self._t0 = time.perf_counter()
        self._t_last = self._t0
        self._mark = tracer.snapshot()
        self._eng_mark = self._engine_counters()
        self._extras_mark: Dict[str, int] = {}

    def _engine_counters(self) -> Dict[str, int]:
        e = self.engine
        if e is None:
            return {"dispatches": 0, "payloads": 0, "eval_dispatches": 0}
        return {"dispatches": e.dispatches,
                "payloads": e.payloads_computed,
                "eval_dispatches": e.eval_dispatches}

    # ------------------------------------------------------------------
    def on_round(self, *, result: Dict[str, Any], ues: np.ndarray,
                 heap_depth: int, extras: Dict[str, Any], t_sim: float,
                 staleness: np.ndarray,
                 members: Optional[List[int]] = None) -> Dict[str, Any]:
        """Record the round ``result`` just returned by the protocol;
        ``ues``/``staleness`` are read off the closing server's Π /
        staleness history (observability never writes protocol state).

        ``members`` — live per-protocol-cell membership counts under an
        open-world scenario; recorded as the OPTIONAL ``cell_members``
        key (closed-world traces omit it, so existing traces stay valid
        against the v1 schema).

        The record's wall/phase deltas cover everything since the
        previous close (including that round's redistribution and eval) —
        the tail after the final close lands in the summary only.
        """
        now = time.perf_counter()
        snap = self.tracer.snapshot()
        eng = self._engine_counters()
        rec: Dict[str, Any] = {
            "round": int(result["round"]),
            "cell": int(result.get("cell", 0)),
            "a": int(len(ues)),
            "ues": [int(u) for u in ues],
            "distributed": len(result.get("distribute", ())),
            "staleness_hist": staleness_histogram(staleness),
            "heap_depth": int(heap_depth),
            "t_sim": float(t_sim),
            "wall_s": now - self._t_last,
            "phase_s": _delta_map(snap["phase_s"], self._mark["phase_s"]),
            "device_s": snap["device_s"] - self._mark["device_s"],
            "dispatches": eng["dispatches"] - self._eng_mark["dispatches"],
            "payloads": eng["payloads"] - self._eng_mark["payloads"],
            "eval_dispatches": eng["eval_dispatches"]
            - self._eng_mark["eval_dispatches"],
            "handovers": int(extras.get("handovers", 0))
            - self._extras_mark.get("handovers", 0),
            "departed_arrivals": int(extras.get("departed_arrivals", 0))
            - self._extras_mark.get("departed_arrivals", 0),
            "cloud_rounds": int(extras.get("cloud_rounds", 0))
            - self._extras_mark.get("cloud_rounds", 0),
            "counts": _delta_map(snap["counts"], self._mark["counts"]),
        }
        if members is not None:
            rec["cell_members"] = [int(m) for m in members]
        self._t_last = now
        self._mark = snap
        self._eng_mark = eng
        self._extras_mark = {k: int(extras.get(k, 0))
                             for k in ("handovers", "departed_arrivals",
                                       "cloud_rounds")}
        self.records.append(rec)
        if self.logger is not None:
            self.logger.log(**rec)
        return rec

    # ------------------------------------------------------------------
    def finalize(self, extras: Optional[Dict[str, Any]] = None
                 ) -> Dict[str, Any]:
        """End-of-run summary (attached to ``SimResult.telemetry``); the
        ``_summary`` JSONL row is written and the logger closed."""
        snap = self.tracer.snapshot()
        summary: Dict[str, Any] = {
            "schema": SCHEMA,
            "rounds": len(self.records),
            "arrivals": int(sum(r["a"] for r in self.records)),
            "wall_s": time.perf_counter() - self._t0,
            "phase_s": snap["phase_s"],
            "device_s": snap["device_s"],
            "device_phase_s": snap["device_phase_s"],
            "counts": snap["counts"],
            "per_cell_a": self._per_cell_a(),
        }
        if extras:
            summary.update({k: int(v) for k, v in extras.items()})
        if self.logger is not None:
            self.logger._write({"_summary": _jsonable(summary)})
            summary["trace_path"] = self.logger.path
            self.logger.close()
        return summary

    def _per_cell_a(self) -> Dict[str, int]:
        per: Dict[str, int] = {}
        for r in self.records:
            key = str(r["cell"])
            per[key] = per.get(key, 0) + r["a"]
        return per


def _jsonable(v: Any) -> Any:
    from repro_torch.utils.metrics import _plain
    return _plain(v)


# ---------------------------------------------------------------------------
# schema validation (shared by trace_report --check and the tests)
# ---------------------------------------------------------------------------

def split_rows(rows: List[Dict[str, Any]]):
    """(meta, round_records, summary) from raw ``read_metrics`` rows."""
    meta = rows[0].get("_meta") if rows and "_meta" in rows[0] else None
    summary = rows[-1].get("_summary") \
        if rows and "_summary" in rows[-1] else None
    recs = [r for r in rows if "_meta" not in r and "_summary" not in r]
    return meta, recs, summary


def validate_rows(rows: List[Dict[str, Any]],
                  wall_tol: float = 0.05) -> List[str]:
    """Schema + invariant check of one trace; returns a list of problems
    (empty = valid).

    Invariants: required keys present and sane; round indices strictly
    increasing; per-record Σ phase_s ≤ wall_s (within ``wall_tol``
    slack for timer granularity); Σ A_c over rounds equals the summary's
    consumed-arrival count.
    """
    errs: List[str] = []
    meta, recs, summary = split_rows(rows)
    if meta is None:
        errs.append("missing _meta header row")
    elif meta.get("schema") != SCHEMA:
        errs.append(f"_meta.schema is {meta.get('schema')!r}, "
                    f"want {SCHEMA!r}")
    if not recs:
        errs.append("no per-round records")
    prev_round = 0
    for i, r in enumerate(recs):
        missing = [k for k in REQUIRED_KEYS if k not in r]
        if missing:
            errs.append(f"record {i}: missing keys {missing}")
            continue
        if not isinstance(r["round"], int) or r["round"] <= prev_round:
            errs.append(f"record {i}: round {r['round']!r} not strictly "
                        f"increasing after {prev_round}")
        prev_round = r["round"] if isinstance(r["round"], int) \
            else prev_round
        if r["a"] < 1 or r["a"] != len(r["ues"]):
            errs.append(f"record {i}: a={r['a']} inconsistent with "
                        f"{len(r['ues'])} ues")
        if any(v < 0 for v in r["phase_s"].values()):
            errs.append(f"record {i}: negative phase seconds")
        host = sum(r["phase_s"].values())
        budget = r["wall_s"] * (1.0 + wall_tol) + 1e-6
        if host > budget:
            errs.append(f"record {i}: phase seconds {host:.6f} exceed "
                        f"wall {r['wall_s']:.6f}")
        if r["device_s"] > budget:
            errs.append(f"record {i}: device seconds {r['device_s']:.6f} "
                        f"exceed wall {r['wall_s']:.6f}")
        if sum(r["staleness_hist"]) <= 0:
            errs.append(f"record {i}: empty staleness histogram")
        if "cell_members" in r:        # optional (open-world scenarios)
            cm = r["cell_members"]
            if not isinstance(cm, list) or any(
                    not isinstance(v, int) or v < 0 for v in cm):
                errs.append(f"record {i}: cell_members must be a list of "
                            f"non-negative ints, got {cm!r}")
    if summary is None:
        errs.append("missing _summary trailer row")
    elif recs:
        tot = sum(r["a"] for r in recs)
        if summary.get("arrivals") != tot:
            errs.append(f"summary arrivals {summary.get('arrivals')} != "
                        f"Σ per-round a {tot}")
        if summary.get("rounds") != len(recs):
            errs.append(f"summary rounds {summary.get('rounds')} != "
                        f"{len(recs)} records")
    return errs
