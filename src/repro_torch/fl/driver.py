"""Unified event-loop driver for the PerFedS² simulators.

The port of the JAX package's ``fl/driver.py``.  ``run_simulation`` (static
single cell) and ``run_mobile_simulation`` (mobile multi-cell) are thin
configurations of ``run_event_loop``, parameterized by a small
``TopologyAdapter``; the semi-synchronous machinery lives here once:

* the priority queue over upload-finish times with epoch-based lazy
  cancellation (τ > S forced refresh abandons in-flight work, Alg. 1 l. 13);
* the drain-until-round-closes batching (the server advances only on its
  (A − pending)-th upload, so no distribution — hence no cancellation and
  no membership effect on queued events — can precede the drained arrivals;
  their payloads are all computable NOW, as one engine batch: paper Alg. 1
  / Eq. 8);
* the fused-vs-bucketed dispatch decision (a whole round matching one
  cell's ``A`` with a single batch signature takes the engine's
  one-dispatch-per-version-group ``round_update`` path);
* batched requeue pricing (one ``[k, n]`` fading draw + vectorized Eq.
  (10)–(11), bitwise the legacy per-UE loop), α_i spreading, evaluation
  cadence and ``SimResult`` assembly;
* the open world (``cfg.scenario``): joins, leaves, label drift and flash
  crowds interleaved with the heap in simulated-time order, with the
  live-membership round caps re-armed between drains;
* the per-round JSONL recorder (``trace_dir``, ``obs/recorder.py``).

Arrival routing: every heap event is stamped with the cell that dispatched
it (the UE's association at *cycle start*), so an upload in flight across a
handover closes the round it was computed against.

All host-side event math — simulated times, the Π schedule, wait fraction,
handovers, cloud merges, joins, leaves and drifts — is the reference's
numpy, draw for draw, so it matches the JAX package bitwise; the device
math (payloads, Eq. 8, cloud merges, evals) runs in torch on ``device``.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ExperimentConfig
from repro_torch.data.partition import ClientDataset, sample_triplet_many
from repro_torch.fl.engine import SimulationEngine, ensure_engine
from repro_torch.fl.scenario import DRIFT, FLASH, JOIN, LEAVE, make_scenario
from repro_torch.obs import trace as obs
from repro_torch.obs.recorder import SCHEMA, RoundRecorder
from repro_torch.utils.metrics import MetricsLogger
from repro_torch.utils.tree import tree_to
from repro_torch.wireless.channel import noise_w_per_hz, pathloss_pow
from repro_torch.wireless.timing import compute_times, model_bits, upload_times

# max doubles one fading-draw block may materialise (~8 MB)
FADING_BLOCK = 1 << 20


@dataclass
class SimResult:
    name: str
    times: np.ndarray            # wall-clock at each eval point [s]
    losses: np.ndarray           # personalized (PFL) eval loss
    global_losses: np.ndarray    # loss of the raw global model
    accs: np.ndarray             # accuracy if the task defines one (else nan)
    rounds: np.ndarray           # round index at each eval point
    total_time: float
    pi: np.ndarray               # realised schedule matrix
    eta_target: np.ndarray
    eta_realised: np.ndarray
    wait_fraction: float         # mean fraction of time UEs spent idle
    payload_dispatches: int = 0  # payload calls issued by the engine
    payloads_computed: int = 0   # payloads those calls produced
    # mobile multi-cell extension (zeros on the static single-cell path)
    n_cells: int = 1
    handovers: int = 0           # nearest-BS re-associations during the run
    cloud_rounds: int = 0        # hierarchical cloud merges performed
    departed_arrivals: int = 0   # uploads that arrived after a handover
    # open-world scenario extension (zeros on closed-world runs)
    ue_joins: int = 0            # Poisson arrivals activated mid-run
    ue_departures: int = 0       # departures (in-flight work epoch-cancelled)
    label_drifts: int = 0        # per-UE label-drift events applied
    # rounds still holding uploads when the event heap ran dry before the
    # round target was met (silent loss before; now counted + warned)
    aborted_rounds: int = 0
    pending_uploads: int = 0     # uploads those aborted rounds were holding
    # end-of-run telemetry summary (None unless the run was traced):
    # per-phase host seconds, device seconds, counters, per-cell arrivals,
    # and the JSONL trace path when one was written — see obs/recorder.py
    telemetry: Optional[Dict[str, Any]] = None
    params: Any = None           # final global params (tensors on device)


class TopologyAdapter:
    """What differs between the static and mobile event loops.

    The driver owns the heap, epoch cancellation, drain batching, dispatch
    decisions, eval cadence, batched requeue pricing, and ``SimResult``
    assembly; the adapter supplies topology (network geometry, bandwidth,
    cells) and protocol (the server or server hierarchy).

    Attributes the driver reads:

    ``net``  — ``EdgeNetwork``-compatible channel API (``sample_fading_batch``
               / ``distances`` / ``cpu_freq``).
    ``eta``  — participation targets (reported in ``SimResult``).
    ``bw``   — per-UE bandwidth [Hz]; may be updated **in place** by
               ``pre_requeue`` (the driver holds the array reference).
    ``n_protocol_cells`` — number of cells the drain bookkeeping tracks
               (1 for a single global server, even over many radio cells).
    """

    net: Any
    eta: np.ndarray
    bw: np.ndarray
    n_protocol_cells: int = 1

    # --- protocol ------------------------------------------------------
    def make_servers(self, params0: Any) -> None:
        raise NotImplementedError

    def rounds_done(self) -> int:
        raise NotImplementedError

    def need(self, cell: int) -> int:
        """Arrivals until ``cell``'s round closes (A − pending)."""
        raise NotImplementedError

    def participants(self, cell: int) -> int:
        """``cell``'s A (round size) — the fused-path batch target."""
        raise NotImplementedError

    def on_arrival(self, cell: int, ue: int,
                   payload: Any) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_arrival_batch(self, cells: np.ndarray, ues: np.ndarray,
                         payloads: Any) -> Optional[Dict[str, Any]]:
        """Batch-wise feed: one drained batch, payloads STACKED (leading
        lane axis, arrival order).  At most one round closes — on the
        last lane (drain invariant) — and its result dict is returned."""
        raise NotImplementedError

    def on_round_batch(self, cell: int, ues: List[int],
                       aggregate_fn: Callable) -> Dict[str, Any]:
        raise NotImplementedError

    def protocol(self) -> Any:
        """The top-level protocol object (``params`` / ``pi_matrix`` /
        ``realised_eta``)."""
        raise NotImplementedError

    def pending_uploads(self) -> int:
        """Uploads held toward rounds that have not closed yet."""
        p = self.protocol()
        return int(p.pending_uploads()) if hasattr(p, "pending_uploads") \
            else 0

    def open_rounds(self) -> int:
        """Rounds currently holding at least one pending upload."""
        p = self.protocol()
        if hasattr(p, "open_rounds"):
            return int(p.open_rounds())
        return 1 if self.pending_uploads() > 0 else 0

    # --- open-world scenario hooks (closed world: all no-ops) ----------
    def bind_active(self, mask: np.ndarray) -> None:
        """Receive the scenario's live activity mask BEFORE
        ``make_servers`` — initial membership, round sizes and bandwidth
        must see only the UEs active at t=0.  The array is shared: the
        scenario runtime flips bits in place as UEs join/leave."""

    def pre_drain(self) -> None:
        """Called once before every drain.  Adapters that clamp round
        sizes to live membership push the caps HERE — never mid-drain, so
        ``need`` stays constant while a drain is in flight (the drain
        invariant: at most one round closes, on the last lane)."""

    def flush_ready(self) -> List[Dict[str, Any]]:
        """Round results for every open round whose (live-cap-clamped)
        target its pending uploads already meet — churn can lower a
        target to the pending count after those uploads arrived, and no
        future arrival exists to close such a round through the ordinary
        path.  Called right after ``pre_drain``; closed world: none."""
        return []

    def on_join(self, ue: int) -> Any:
        """A dormant UE joins (scenario arrival): activate it in the
        topology/protocol and return the model params it starts from."""
        return self.protocol().params

    def on_leave(self, ue: int) -> None:
        """An active UE departs: deactivate it everywhere.  The driver
        has already epoch-cancelled its in-flight upload."""

    def on_flash(self, idx: np.ndarray,
                 rng: np.random.Generator) -> int:
        """Flash-crowd window opens: retarget ``idx`` toward the hotspot
        (mobility-model permitting).  Returns how many UEs were
        retargeted."""
        return 0

    def cell_membership(self) -> Optional[List[int]]:
        """Live per-protocol-cell membership counts for trace records
        (``None`` → the recorder omits the field)."""
        return None

    # --- topology hooks (static topology: all no-ops) ------------------
    def bind_link_budget(self, z_bits: float, d_i: np.ndarray) -> None:
        """Called once by ``make_cycle_duration_fn`` with the payload size
        Z [bits] and per-UE sample counts — the link-budget inputs a
        Theorem-2 (equal-finish) bandwidth policy needs to price compute
        times.  Adapters whose allocation ignores Z (equal split /
        weighted-equal-rate) leave this a no-op."""

    def dispatch_cell(self, ue: int) -> int:
        """Cell stamped on a cycle's heap event at dispatch time; arrivals
        are routed back to this cell even if the UE hands over while the
        upload is in flight."""
        return 0

    def dispatch_cells(self, ues: np.ndarray) -> np.ndarray:
        """Vectorized ``dispatch_cell`` — the driver stamps whole
        requeues (and checks whole drains for mid-flight handovers) in
        one call instead of one python call per UE."""
        return np.zeros(len(ues), dtype=np.int64)

    def advance_to(self, t: float) -> None:
        """Move simulated time forward (mobility, handovers, bookkeeping)."""

    def pre_requeue(self, ues) -> None:
        """Chance to refresh per-UE bandwidth before pricing new cycles."""

    def result_extras(self) -> Dict[str, Any]:
        """Extra ``SimResult`` fields (cells / handovers / cloud merges)."""
        return {}


def make_cycle_duration_fn(adapter: TopologyAdapter, wl, z_bits: float,
                           d_i: np.ndarray) -> Callable[[Any], np.ndarray]:
    """Batched requeue pricing: ONE fading draw + vectorized Eq. (10)–(11).

    The legacy drivers priced each requeued UE alone — ``sample_fading()``
    draws the whole [n] Rayleigh vector, then a ``UEChannel`` and
    python-scalar timing math, per UE per requeue.  Here a requeue of k UEs
    draws one ``[k, n]`` matrix and the timing math vectorizes over the k
    lanes.  Every value is bitwise identical to the legacy loop: the batch
    draw consumes the same bitstream, and ``pathloss_pow`` keeps d^{−κ} on
    libm's scalar pow — a full cached vector on frozen topologies, per-lane
    pricing once mobility starts replacing the distances array (see
    ``_pathloss`` below).
    """
    net = adapter.net
    adapter.bind_link_budget(z_bits, d_i)
    p, kappa = wl.tx_power_w, wl.path_loss_exp
    n0 = noise_w_per_hz(wl.noise_dbm_per_hz)
    cycles = wl.cpu_cycles_per_sample
    cache: Dict[str, Any] = {"src": None, "pw": None, "volatile": False}

    def _pathloss(dists, idx: np.ndarray) -> np.ndarray:
        # Static topologies keep one distances array for the whole run →
        # build the full d^{−κ} vector once and index it forever.  Moving
        # mobility replaces the array on every movement step; a full
        # rebuild there would cost O(n) scalar pows per requeue, so on the
        # second distinct array we switch to pricing only the requeued
        # lanes (k scalar pows — exactly the legacy per-UE cost).
        if cache["src"] is dists:
            return cache["pw"][idx]
        if not cache["volatile"] and cache["src"] is None:
            cache["pw"] = pathloss_pow(dists, kappa)
            cache["src"] = dists
            return cache["pw"][idx]
        cache["volatile"] = True
        cache["src"], cache["pw"] = None, None
        # dists is the host sim clock's numpy distance matrix; asarray
        # never touches a device array here
        return pathloss_pow(np.asarray(dists)[idx], kappa)

    counter_rng = getattr(wl, "rng", "legacy") == "counter"

    def _fading_lanes(idx: np.ndarray) -> np.ndarray:
        if counter_rng:
            # counter stream: O(k) lane-indexed draws — no [k, n] matrix,
            # no dependence on how the event loop batches its pricing
            return net.fading_lanes(idx)
        # legacy stream: one [k, n] draw, in row blocks of ≤ FADING_BLOCK
        # doubles: numpy Generators fill arrays from the bitstream
        # sequentially, so the blocks are bitwise the single big call —
        # without the O(k·n) peak memory (an [n, n] matrix at the initial
        # heap fill: 2 GB at 16384 UEs)
        k = len(idx)
        rows = max(1, FADING_BLOCK // max(net.n_ues, 1))
        if k <= rows:
            return net.sample_fading_batch(k)[np.arange(k), idx]
        h = np.empty(k)
        for lo in range(0, k, rows):
            hi = min(lo + rows, k)
            h[lo:hi] = net.sample_fading_batch(hi - lo)[
                np.arange(hi - lo), idx[lo:hi]]
        return h

    def cycle_durations(ues) -> np.ndarray:
        # one span per requeue (not per lane): disabled cost is a single
        # no-op context enter/exit on the batched call
        with obs.CURRENT.span("pricing"):
            adapter.pre_requeue(ues)
            idx = np.asarray(ues, dtype=np.int64)
            h = _fading_lanes(idx)
            tcmp = compute_times(cycles, d_i[idx], net.cpu_freq[idx])
            q = p * h * _pathloss(net.distances, idx) / n0   # UEChannel.q
            tcom = upload_times(z_bits, adapter.bw[idx], q)
            return tcmp + tcom

    return cycle_durations


def _protocol_call(fn, *args):
    """Feed the protocol under the "protocol" phase span, with device
    attribution when the tracer blocks (segment slicing, staleness
    aggregation, cloud merges are device tree ops)."""
    tr = obs.CURRENT
    with tr.span("protocol"):
        return tr.device_call("protocol", fn, *args)


def _closing_server(adapter: TopologyAdapter, result: Dict[str, Any]):
    """The ``SemiSyncServer`` whose round just closed (read-only: the
    recorder reads its Π row / staleness snapshot)."""
    proto = adapter.protocol()
    if hasattr(proto, "cells") and "cell" in result:
        return proto.cells[result["cell"]]
    return proto


def run_event_loop(cfg: ExperimentConfig, model,
                   clients: List[ClientDataset],
                   adapter: TopologyAdapter, *,
                   algorithm: str = "perfed", mode: str = "semi",
                   max_rounds: Optional[int] = None,
                   eval_every: int = 5, eval_clients: int = 8,
                   seed: int = 0, name: Optional[str] = None,
                   verbose: bool = False,
                   payload_mode: Optional[str] = None,
                   engine: Optional[SimulationEngine] = None,
                   device="cuda",
                   tracer: Optional[obs.Tracer] = None,
                   trace_dir: Optional[str] = None,
                   profile_dir: Optional[str] = None,
                   reporter: Optional[obs.Reporter] = None) -> SimResult:
    """Run the event loop on ``device``, optionally under the telemetry
    layer.

    ``tracer``/``trace_dir``/``profile_dir``/``reporter`` override the
    corresponding ``cfg.obs`` fields; a tracer (explicit or implied by
    ``cfg.obs.trace`` / a trace dir) is installed as the process-wide
    ``obs.trace.CURRENT`` for the duration of the run, a per-round JSONL
    trace is written when a directory is given, and the end-of-run
    summary lands on ``SimResult.telemetry``.  Tracing is read-only —
    trajectories are bitwise identical with it on or off.
    """
    oc = cfg.obs
    trace_dir = trace_dir or (oc.trace_dir or None)
    profile_dir = profile_dir or (oc.profile_dir or None)
    if tracer is None and (oc.trace or trace_dir or profile_dir):
        tracer = obs.Tracer(device=oc.device_timing,
                            profile=bool(profile_dir))
    rep = reporter or obs.Reporter("progress" if verbose else oc.report)
    with obs.use(tracer), obs.profile_trace(profile_dir):
        return _event_loop(cfg, model, clients, adapter,
                           algorithm=algorithm, mode=mode,
                           max_rounds=max_rounds, eval_every=eval_every,
                           eval_clients=eval_clients, seed=seed, name=name,
                           payload_mode=payload_mode, engine=engine,
                           device=device, tracer=tracer, trace_dir=trace_dir,
                           rep=rep)


def _event_loop(cfg: ExperimentConfig, model,
                clients: List[ClientDataset],
                adapter: TopologyAdapter, *,
                algorithm: str, mode: str,
                max_rounds: Optional[int],
                eval_every: int, eval_clients: int,
                seed: int, name: Optional[str],
                payload_mode: Optional[str],
                engine: Optional[SimulationEngine],
                device,
                tracer: Optional[obs.Tracer],
                trace_dir: Optional[str],
                rep: obs.Reporter) -> SimResult:
    fl, wl = cfg.fl, cfg.wireless
    n = len(clients)
    max_rounds = max_rounds or fl.rounds
    rng = np.random.default_rng(seed)

    # --- model / engine -----------------------------------------------------
    engine = ensure_engine(engine, model, fl, algorithm=algorithm,
                           payload_mode=payload_mode, device=device)
    # init draws on a CPU generator, so a seed gives the same weights on
    # every device; payloads and evals draw nothing
    params0 = tree_to(model.init(torch.Generator().manual_seed(seed)),
                      engine.device)
    z_bits = wl.grad_bits or model_bits(params0, wl.bits_per_param)
    # snapshot so SimResult reports THIS run's dispatch counts even when the
    # engine (and its lifetime counters) is shared across a sweep
    disp0, pay0 = engine.dispatches, engine.payloads_computed

    recorder: Optional[RoundRecorder] = None
    if tracer is not None:
        logger = None
        if trace_dir:
            logger = MetricsLogger(trace_dir, meta={
                "schema": SCHEMA, "name": name or f"{algorithm}-{mode}",
                "algorithm": algorithm, "mode": mode, "seed": seed,
                "n_ues": n, "payload_mode": engine.payload_mode,
                "device_timing": tracer.device_timing})
        recorder = RoundRecorder(tracer, engine=engine, logger=logger)
    # per-UE inner learning rates α_i (paper §II-B: "easily extended to the
    # general case when UEs have diverse learning rate α_i")
    if fl.alpha_spread > 0:
        s = 1.0 + fl.alpha_spread
        alphas = fl.alpha * np.exp(rng.uniform(-np.log(s), np.log(s), size=n))
    else:
        alphas = np.full(n, fl.alpha)

    # open-world scenario (None = closed world, zero overhead): the
    # activity mask must be bound BEFORE make_servers so initial
    # membership / round sizes / bandwidth see only the t=0-active UEs
    scen = make_scenario(cfg.scenario, n, seed)
    if scen is not None:
        adapter.bind_active(scen.active)
    adapter.make_servers(params0)

    # --- per-UE state -------------------------------------------------------
    held_params: List[Any] = [params0 for _ in range(n)]
    d_i = np.array([min(fl.inner_batch + fl.outer_batch + fl.hessian_batch,
                        len(c)) for c in clients])
    busy_time = np.zeros(n)
    # batch shapes are a pure function of the shard size; a round whose UEs
    # share one signature can take the fused path, mixed rounds fall back to
    # bucketed payloads (rule lives on ClientDataset, next to the sampler)
    batch_sig = [c.triplet_sizes(fl.inner_batch, fl.outer_batch,
                                 fl.hessian_batch) for c in clients]

    cycle_durations = make_cycle_duration_fn(adapter, wl, z_bits, d_i)

    # --- eval ----------------------------------------------------------------
    eval_idx = rng.choice(n, size=min(eval_clients, n), replace=False)

    def evaluate(params) -> Tuple[float, float, float]:
        # the whole cohort evaluates as one vmapped call per shape group
        with obs.CURRENT.span("eval"):
            batches_list = [{"inner": clients[ci].sample(fl.inner_batch),
                             "outer": dict(clients[ci].test)}
                            for ci in eval_idx]
            pl, gl, ac = engine.eval_many(params, batches_list)
        acc = (float(np.nanmean(ac))
               if np.any(np.isfinite(ac)) else float("nan"))
        return float(np.mean(pl)), float(np.mean(gl)), acc

    # --- event loop ----------------------------------------------------------
    # epoch-based lazy cancellation: when the server re-distributes to a UE
    # whose upload is still in flight (τ > S forced refresh, Alg. 1 line 13),
    # the UE ABANDONS the stale computation and restarts — the old event is
    # dropped at pop time if its epoch is outdated.
    # event = (t_finish, seq, ue, version, duration, epoch, dispatch_cell)
    epoch = np.zeros(n, dtype=np.int64)
    # only t=0-active UEs get an initial cycle; the dormant pool is what
    # scenario arrivals later activate (closed world: everyone)
    fill_ues = np.arange(n) if scen is None else np.nonzero(scen.active)[0]
    fill_cells = adapter.dispatch_cells(fill_ues)
    # events are totally ordered by (t, seq), so heapify yields the exact
    # pop sequence of n pushes at a fraction of the fill cost
    heap: List[Tuple[float, int, int, int, float, int, int]] = [
        (float(dur), i, int(ue), 0, float(dur), 0, int(c))
        for i, (ue, dur, c) in enumerate(zip(fill_ues,
                                             cycle_durations(fill_ues),
                                             fill_cells))]
    heapq.heapify(heap)
    seq = len(fill_ues)

    times, plosses, glosses, accs, rounds_at = [], [], [], [], []
    t_now = 0.0
    do_eval = eval_every > 0            # 0 → pure-throughput mode, no evals

    if do_eval:
        p0, g0, a0 = evaluate(params0)
        times.append(0.0)
        plosses.append(p0)
        glosses.append(g0)
        accs.append(a0)
        rounds_at.append(0)

    def restart_departed(items: List[Tuple[int, float]]) -> None:
        # Liveness for handed-over UEs: an upload that closed at the SOURCE
        # cell gets no redistribution from it (the UE is no longer a
        # member), and the destination owes it nothing until the τ > S
        # forced refresh — so the device simply continues from the model it
        # already holds.  Its true staleness was grafted onto the
        # destination's round clock at handover time, so the next upload is
        # weighted correctly there.  Without this the UE would idle for up
        # to S destination rounds after every mid-flight handover.
        # ``items`` is every (ue, cycle start time) of the drain batch —
        # priced with ONE cycle_durations call (one [k, n] fading draw)
        # instead of one [1, n] draw each.  A departed UE the closing
        # (destination) cell redistributed to in this very drain already
        # holds a fresh cycle — restarting it too would double-queue it.
        nonlocal seq
        items = [it for it in items if it[0] not in redistributed]
        if scen is not None:
            # a UE that departed mid-flight gets no fresh cycle: its
            # already-finished upload may still aggregate (stale-tolerant
            # protocol), but restarting it would resurrect a zombie that
            # keeps computing after it left the system
            items = [it for it in items if scen.active[it[0]]]
        if not items:
            return
        with obs.CURRENT.span("restart"):
            obs.CURRENT.add("driver.restarted_ues", len(items))
            cells_r = adapter.dispatch_cells([u for u, _ in items])
            durs_r = cycle_durations([u for u, _ in items])
            version = adapter.rounds_done()
            for (ue, t0), dur, dc in zip(items, durs_r, cells_r):
                heapq.heappush(heap, (t0 + float(dur), seq, ue, version,
                                      float(dur), int(epoch[ue]), int(dc)))
                seq += 1

    redistributed: set = set()          # UEs given a new cycle this drain

    def apply_scenario_event(ev: Tuple[float, str, int]) -> bool:
        """One open-world lifecycle event, in simulated-time order with
        the heap.  Joins are priced and queued like any other cycle;
        leaves cancel in-flight work via the epoch mechanism (exactly the
        τ > S refresh path); drift rewrites the client's labels; flash
        retargets waypoints at the hotspot.  Returns True when the event
        changed membership — the caller must then end its drain so the
        live-membership round caps can re-arm (``pre_drain``/``flush``)
        before any further pops."""
        nonlocal seq
        t_ev, kind, ue = ev
        adapter.advance_to(t_ev)
        if kind == JOIN:
            # a joining UE starts from the model its cell would hand it,
            # with a fresh cycle priced through the ordinary batched path
            held_params[ue] = adapter.on_join(ue)
            epoch[ue] += 1              # orphan any stray old event
            obs.CURRENT.add("driver.ue_joins")
            dc = int(adapter.dispatch_cells([ue])[0])
            dur = float(cycle_durations([ue])[0])
            heapq.heappush(heap, (t_ev + dur, seq, ue,
                                  adapter.rounds_done(), dur,
                                  int(epoch[ue]), dc))
            seq += 1
            return True
        if kind == LEAVE:
            epoch[ue] += 1              # lazy-cancel the in-flight upload
            adapter.on_leave(ue)
            obs.CURRENT.add("driver.ue_departures")
            return True
        if kind == DRIFT:
            changed = clients[ue].drift_labels(scen.rng,
                                               cfg.scenario.drift_frac)
            obs.CURRENT.add("driver.label_drifts")
            if changed:
                obs.CURRENT.add("driver.drifted_samples", changed)
        elif kind == FLASH:
            moved = adapter.on_flash(scen.hotspot_targets(), scen.rng)
            if moved:
                obs.CURRENT.add("driver.flash_retargets", moved)
        return False

    def handle(result) -> None:
        nonlocal seq
        if recorder is not None:
            # read-only peek at the closing server: its just-appended Π row
            # is the arrived-UE set, its staleness vector the τ snapshot
            srv = _closing_server(adapter, result)
            rec = recorder.on_round(
                result=result,
                ues=np.nonzero(srv.history_pi[-1])[0],
                heap_depth=len(heap),
                extras=adapter.result_extras(),
                t_sim=t_now,
                staleness=srv.history_staleness[-1],
                members=adapter.cell_membership())
            rep.debug(f"[trace] round {rec['round']} cell={rec['cell']} "
                      f"a={rec['a']} heap={rec['heap_depth']} "
                      f"wall={rec['wall_s']*1e3:.1f}ms")
        dist = result["distribute"]
        if dist:
            with obs.CURRENT.span("redistribute"):
                redistributed.update(int(i) for i in dist)
                for i in dist:
                    held_params[i] = result["params"]
                dist_arr = np.asarray(dist, dtype=np.int64)
                epoch[dist_arr] += 1    # cancels any in-flight computation
                cells_d = adapter.dispatch_cells(dist_arr)
                for i, dur_i, dc in zip(dist, cycle_durations(dist),
                                        cells_d):
                    heapq.heappush(heap, (t_now + float(dur_i), seq, int(i),
                                          result["round"], float(dur_i),
                                          int(epoch[i]), int(dc)))
                    seq += 1
        k = result["round"]
        if do_eval and (k % eval_every == 0 or k == max_rounds):
            p, g, a = evaluate(result["params"])
            times.append(t_now)
            plosses.append(p)
            glosses.append(g)
            accs.append(a)
            rounds_at.append(k)
            cell = f" cell={result['cell']}" if "cell" in result else ""
            rep.progress(f"[{name or algorithm}-{mode}]{cell} round {k:4d} "
                         f"t={t_now:8.2f}s ploss={p:.4f} gloss={g:.4f}")

    inf = float("inf")

    def events_remain() -> bool:
        # a dry heap can only be refilled by a future join (can_spawn);
        # departures/drift alone cannot restart progress
        return bool(heap) or (scen is not None and scen.can_spawn())

    while adapter.rounds_done() < max_rounds and events_remain():
        # live-membership round-size caps are pushed between drains only
        # (never mid-drain): ``need`` stays constant while a drain is in
        # flight, preserving the drain invariant
        adapter.pre_drain()
        # a clamped target the pending uploads already meet can never be
        # closed by a future arrival (every remaining member's upload is
        # in) — close those rounds now, then re-arm the caps: the closes
        # redistribute, changing both pending and in-flight counts
        flushed = adapter.flush_ready()
        if flushed:
            for result in flushed:
                handle(result)
                if adapter.rounds_done() >= max_rounds:
                    break
            continue
        # ---- drain arrivals until the first cell would close its round ----
        # No distribution (hence no cancellation, no membership effect on
        # queued events) can occur before then, so every drained payload is
        # computable NOW, as one batch — per cell.  ``need`` is recomputed
        # per pop: it depends only on pending-upload counts, which change
        # exclusively when arrivals are *fed* (after the drain), never on
        # mid-drain handovers — recomputing makes the loop robust to future
        # protocols where that invariant stops holding, at O(1) cost.
        drained = [0] * adapter.n_protocol_cells
        batch: List[Tuple[float, int, int, float, int]] = []
        closing: Optional[int] = None
        redistributed.clear()
        stale_pops = 0
        rearm = False       # drain ended on a membership change
        # NOTE: the pop loop itself carries no per-pop tracing calls — the
        # drain is the hot path and must stay free when tracing is off;
        # mobility/handover time is attributed inside the (rare) tick
        # branch of ``multicell.advance_to``, not here.  Scenario lifecycle
        # events are interleaved in simulated-time order: each one is
        # applied before any later-timestamped upload pops, so a departure
        # always cancels in-flight work before that work could arrive.
        with obs.CURRENT.span("drain"):
            while True:
                if not heap and (scen is None or not scen.can_spawn()):
                    break
                t_head = heap[0][0] if heap else inf
                if scen is not None and scen.next_time() <= t_head:
                    ev = scen.next_event(t_head)
                    if ev is not None and apply_scenario_event(ev):
                        # membership changed: end the drain so the live
                        # caps re-arm (pre_drain / flush_ready) before
                        # any further pops — mid-drain cap pushes would
                        # break the drain invariant instead
                        rearm = True
                        break
                    continue
                if not heap:
                    break
                t, sq, ue, _version, dur, ev_epoch, cell = \
                    heapq.heappop(heap)
                if ev_epoch != epoch[ue]:
                    stale_pops += 1
                    continue            # abandoned (stale-refresh) cycle
                adapter.advance_to(t)
                # route by the *stamped* dispatch cell: an upload in flight
                # across a handover still closes the round it was computed
                # for
                batch.append((t, ue, sq, dur, cell))
                drained[cell] += 1
                if drained[cell] >= adapter.need(cell):
                    closing = cell
                    break
        if stale_pops:
            obs.CURRENT.add("driver.stale_pops", stale_pops)
        if not batch:
            if rearm:
                continue    # nothing drained yet; re-clamp and go again
            break

        held = [held_params[ue] for _, ue, _, _, _ in batch]
        a_i = [alphas[ue] for _, ue, _, _, _ in batch]
        ues_arr = np.fromiter((b[1] for b in batch), np.int64,
                              count=len(batch))
        cells_arr = np.fromiter((b[4] for b in batch), np.int64,
                                count=len(batch))

        srv_a = adapter.participants(closing) if closing is not None else -1
        if (engine.payload_mode == "batched" and len(batch) == srv_a
                and srv_a <= engine.max_bucket
                and all(b[4] == closing for b in batch)
                and len({batch_sig[ue] for ue in ues_arr}) == 1):
            # fused fast path: the whole round of the closing cell —
            # vmapped payloads + Eq. (8) — in one call per version group
            obs.CURRENT.add("driver.rounds_fused")
            with obs.CURRENT.span("sampling"):
                triplets = [clients[ue].sample_triplet(
                    fl.inner_batch, fl.outer_batch, fl.hessian_batch)
                    for ue in ues_arr]
            t_now = batch[-1][0]
            busy_time[ues_arr] += [b[3] for b in batch]   # completed cycles

            def aggregate(params, weights):
                return engine.round_update(params, held, triplets, a_i,
                                           weights, beta=fl.beta)

            handle(_protocol_call(adapter.on_round_batch,
                                  closing, [int(ue) for ue in ues_arr],
                                  aggregate))
            moved = np.nonzero(
                adapter.dispatch_cells(ues_arr) != cells_arr)[0]
            restart_departed([(int(ues_arr[i]), batch[i][0])
                              for i in moved])
        elif engine.payload_mode == "sequential":
            obs.CURRENT.add("driver.rounds_sequential")
            with obs.CURRENT.span("sampling"):
                triplets = [clients[ue].sample_triplet(
                    fl.inner_batch, fl.outer_batch, fl.hessian_batch)
                    for ue in ues_arr]
            with obs.CURRENT.span("payload"):
                payloads = engine.compute_payloads(held, triplets, a_i)
            # ---- feed the protocol in arrival order ------------------------
            restarts: List[Tuple[int, float]] = []
            for (t, ue, _sq, dur, cell), payload in zip(batch, payloads):
                t_now = t
                busy_time[ue] += dur    # only completed cycles count as busy
                result = _protocol_call(adapter.on_arrival, cell, ue,
                                        payload)
                if result is not None:
                    handle(result)
                if adapter.dispatch_cell(ue) != cell:
                    restarts.append((ue, t))
            restart_departed(restarts)
        else:
            # ---- batch-wise feed: payloads stay stacked on device ----------
            # lanes grouped by batch-shape signature; each group samples its
            # triplets STACKED (one RNG draw + gather per client — bitwise
            # the per-UE loop, the generators are private) and the engine
            # returns ONE stacked payload tree that goes to the protocol
            # whole: no per-lane tree.map extraction, no per-arrival
            # on_arrival python loop
            t_now = batch[-1][0]
            orig_pos = None
            sig_of = [batch_sig[ue] for ue in ues_arr]
            cell_sorted = closing is not None and adapter.n_protocol_cells > 1
            if cell_sorted:
                # sort lanes by (cell, signature), stable, closing cell
                # LAST: the hierarchy slices per-cell segments out of the
                # stacked payloads contiguously, and each cell×signature
                # run is one contiguous engine group — no whole-tree
                # gather or inverse permute anywhere (payload trees are
                # [k, model]-sized, so every avoided copy counts).  Within
                # a (cell, signature) run arrival order is preserved;
                # summation order changes only for a cell with mixed
                # signatures (tolerance-level, never golden-pinned)
                cell_keys = np.where(cells_arr == closing,
                                     np.iinfo(np.int64).max, cells_arr)
                sig_ids: Dict[Tuple, int] = {}
                sig_rank = np.fromiter(
                    (sig_ids.setdefault(s, len(sig_ids)) for s in sig_of),
                    np.int64, count=len(sig_of))
                perm = np.lexsort((sig_rank, cell_keys))
                if not np.array_equal(perm, np.arange(len(batch))):
                    orig_pos = perm
                    batch = [batch[i] for i in perm]
                    ues_arr = ues_arr[perm]
                    cells_arr = cells_arr[perm]
                    held = [held[i] for i in perm]
                    a_i = [a_i[i] for i in perm]
                    sig_of = [sig_of[i] for i in perm]
            if cell_sorted:
                # contiguous runs of equal signature, in feed order
                lane_groups: List[List[int]] = []
                start = 0
                for i in range(1, len(sig_of) + 1):
                    if i == len(sig_of) or sig_of[i] != sig_of[start]:
                        lane_groups.append(list(range(start, i)))
                        start = i
            else:
                sig_groups: Dict[Tuple, List[int]] = {}
                for lane, s in enumerate(sig_of):
                    sig_groups.setdefault(s, []).append(lane)
                lane_groups = list(sig_groups.values())
            obs.CURRENT.add("driver.rounds_batchwise")
            with obs.CURRENT.span("sampling"):
                groups = [(lanes, sample_triplet_many(
                               [clients[int(ues_arr[i])] for i in lanes],
                               fl.inner_batch, fl.outer_batch,
                               fl.hessian_batch))
                          for lanes in lane_groups]
            with obs.CURRENT.span("payload"):
                payloads_stacked = engine.compute_payloads_stacked(
                    held, groups, a_i)
            busy_time[ues_arr] += [b[3] for b in batch]   # completed cycles
            result = _protocol_call(adapter.on_arrival_batch, cells_arr,
                                    ues_arr, payloads_stacked)
            if result is not None:
                handle(result)
            moved = np.nonzero(
                adapter.dispatch_cells(ues_arr) != cells_arr)[0]
            if orig_pos is not None:
                # restarts price fading in list order — restore the drain
                # arrival order the per-arrival path uses
                moved = moved[np.argsort(orig_pos[moved])]
            restart_departed([(int(ues_arr[i]), batch[i][0])
                              for i in moved])

    proto = adapter.protocol()
    if engine.device.type == "cuda":
        # wall-clock timings of this function include all device work
        torch.cuda.synchronize(engine.device)

    # ---- aborted-round accounting -----------------------------------------
    # An exit BEFORE the round target with uploads still pending means the
    # event heap ran dry mid-round (e.g. A > live population, or a frozen
    # per-cell A above a shrunken cell's membership).  This used to be
    # silent — the run reported a clean SimResult and the held uploads
    # simply vanished.  Count it, warn, and surface it on the result.
    pending = adapter.pending_uploads()
    aborted = adapter.open_rounds() \
        if (adapter.rounds_done() < max_rounds and pending > 0) else 0
    if aborted:
        obs.CURRENT.add("driver.aborted_round", aborted)
        rep.warn(f"[{name or f'{algorithm}-{mode}'}] event heap exhausted "
                 f"with {pending} pending upload(s) across {aborted} open "
                 f"round(s) — completed {adapter.rounds_done()}/"
                 f"{max_rounds} rounds")

    telemetry = None
    if recorder is not None:
        scen_extras = {} if scen is None else {
            "ue_joins": scen.ue_joins, "ue_departures": scen.ue_departures,
            "label_drifts": scen.label_drifts}
        telemetry = recorder.finalize(extras={
            **{k: v for k, v in adapter.result_extras().items()
               if isinstance(v, (int, np.integer))},
            **scen_extras,
            **({"aborted_rounds": aborted} if aborted else {})})

    # busy time over seconds of *existence*: a departed UE's absence is
    # not idle time (the closed-world denominator n·t_now is reproduced
    # exactly by alive_total when no churn events fired)
    alive_s = scen.alive_total(t_now) if scen is not None else n * t_now
    wait_frac = float(1.0 - busy_time.sum() / max(alive_s, 1e-9))
    return SimResult(
        ue_joins=scen.ue_joins if scen is not None else 0,
        ue_departures=scen.ue_departures if scen is not None else 0,
        label_drifts=scen.label_drifts if scen is not None else 0,
        aborted_rounds=aborted,
        pending_uploads=pending,
        telemetry=telemetry,
        name=name or f"{algorithm}-{mode}",
        times=np.array(times), losses=np.array(plosses),
        global_losses=np.array(glosses), accs=np.array(accs),
        rounds=np.array(rounds_at), total_time=t_now,
        pi=proto.pi_matrix(), eta_target=adapter.eta,
        eta_realised=proto.realised_eta(),
        wait_fraction=max(wait_frac, 0.0),
        payload_dispatches=engine.dispatches - disp0,
        payloads_computed=engine.payloads_computed - pay0,
        params=proto.params,
        **adapter.result_extras(),
    )
