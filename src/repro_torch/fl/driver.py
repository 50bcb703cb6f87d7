"""Event-loop driver for the PerFedS² simulator — the closed-world path.

The port of the JAX package's ``fl/driver.py``.  ``run_simulation`` (static
single cell) is a thin configuration of ``run_event_loop`` through a small
``TopologyAdapter``; the semi-synchronous machinery lives here once:

* the priority queue over upload-finish times with epoch-based lazy
  cancellation (τ > S forced refresh abandons in-flight work, Alg. 1 l. 13);
* the drain-until-round-closes batching (the server advances only on its
  (A − pending)-th upload, so no distribution — hence no cancellation — can
  precede the drained arrivals; their payloads are all computable NOW, as
  one engine batch: paper Alg. 1 / Eq. 8);
* the fused-vs-bucketed dispatch decision (a whole round with a single
  batch signature takes the engine's one-dispatch-per-version-group
  ``round_update`` path);
* batched requeue pricing (one ``[k, n]`` fading draw + vectorized Eq.
  (10)–(11), bitwise the legacy per-UE loop), α_i spreading, evaluation
  cadence and ``SimResult`` assembly.

All host-side event math — simulated times, the Π schedule, wait fraction —
is the reference's numpy, draw for draw, so it matches the JAX package
bitwise; the device math (payloads, Eq. 8, evals) runs in torch on
``device``.  Only the closed world is ported: ``cfg.scenario.enabled``
(open-world churn) and the per-round JSONL recorder (``trace_dir``) raise
``NotImplementedError``.
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
from repro_torch.obs import trace as obs
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
    # rounds still holding uploads when the event heap ran dry before the
    # round target was met
    aborted_rounds: int = 0
    pending_uploads: int = 0     # uploads those aborted rounds were holding
    params: Any = None           # final global params (tensors on device)


class TopologyAdapter:
    """What a topology supplies to the event loop.

    The driver owns the heap, epoch cancellation, drain batching, dispatch
    decisions, eval cadence, batched requeue pricing, and ``SimResult``
    assembly; the adapter supplies topology (network geometry, bandwidth)
    and protocol (the server).

    Attributes the driver reads:

    ``net``  — ``EdgeNetwork``-compatible channel API (``sample_fading_batch``
               / ``distances`` / ``cpu_freq``).
    ``eta``  — participation targets (reported in ``SimResult``).
    ``bw``   — per-UE bandwidth [Hz].
    """

    net: Any
    eta: np.ndarray
    bw: np.ndarray
    n_protocol_cells: int = 1

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
        ``realised_eta`` / ``pending_uploads``)."""
        raise NotImplementedError

    def bind_link_budget(self, z_bits: float, d_i: np.ndarray) -> None:
        """Called once by ``make_cycle_duration_fn`` with the payload size
        Z [bits] and per-UE sample counts (a static allocation ignores it)."""

    def dispatch_cells(self, ues: np.ndarray) -> np.ndarray:
        """Cell stamped on each cycle's heap event at dispatch time."""
        return np.zeros(len(ues), dtype=np.int64)

    def advance_to(self, t: float) -> None:
        """Move simulated time forward (static topology: nothing moves)."""

    def pre_requeue(self, ues) -> None:
        """Chance to refresh per-UE bandwidth before pricing new cycles."""


def make_cycle_duration_fn(adapter: TopologyAdapter, wl, z_bits: float,
                           d_i: np.ndarray) -> Callable[[Any], np.ndarray]:
    """Batched requeue pricing: ONE fading draw + vectorized Eq. (10)–(11).

    A requeue of k UEs draws one ``[k, n]`` matrix (or k lane-indexed
    counter draws) and the timing math vectorizes over the k lanes; every
    value is bitwise identical to the legacy per-UE loop (``pathloss_pow``
    keeps d^{−κ} on libm's scalar pow — one cached vector on a frozen
    topology, per-lane once the distances array is replaced).
    """
    net = adapter.net
    adapter.bind_link_budget(z_bits, d_i)
    p, kappa = wl.tx_power_w, wl.path_loss_exp
    n0 = noise_w_per_hz(wl.noise_dbm_per_hz)
    cycles = wl.cpu_cycles_per_sample
    cache: Dict[str, Any] = {"src": None, "pw": None, "volatile": False}

    def _pathloss(dists, idx: np.ndarray) -> np.ndarray:
        if cache["src"] is dists:
            return cache["pw"][idx]
        if not cache["volatile"] and cache["src"] is None:
            cache["pw"] = pathloss_pow(dists, kappa)
            cache["src"] = dists
            return cache["pw"][idx]
        cache["volatile"] = True
        cache["src"], cache["pw"] = None, None
        return pathloss_pow(np.asarray(dists)[idx], kappa)

    counter_rng = getattr(wl, "rng", "legacy") == "counter"

    def _fading_lanes(idx: np.ndarray) -> np.ndarray:
        if counter_rng:
            return net.fading_lanes(idx)
        # legacy stream: one [k, n] draw, in row blocks of ≤ FADING_BLOCK
        # doubles (numpy fills arrays from the bitstream sequentially, so
        # the blocks are bitwise the single big call)
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
    attribution when the tracer blocks."""
    tr = obs.CURRENT
    with tr.span("protocol"):
        return tr.device_call("protocol", fn, *args)


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
    """Run the closed-world event loop on ``device``, optionally traced.

    ``tracer``/``profile_dir``/``reporter`` override the corresponding
    ``cfg.obs`` fields; a tracer is installed as ``obs.trace.CURRENT`` for
    the run.  Tracing is read-only — trajectories are identical with it on
    or off.
    """
    if cfg.scenario.enabled:
        raise NotImplementedError(
            "open-world scenarios (cfg.scenario) are not ported yet "
            "(ROADMAP queue 1, open world)")
    oc = cfg.obs
    if trace_dir or oc.trace_dir:
        raise NotImplementedError(
            "per-round JSONL traces (trace_dir) need obs/recorder.py, "
            "which is not ported yet (ROADMAP queue 1, observability)")
    profile_dir = profile_dir or (oc.profile_dir or None)
    if tracer is None and (oc.trace or profile_dir):
        tracer = obs.Tracer(device=oc.device_timing,
                            profile=bool(profile_dir))
    rep = reporter or obs.Reporter("progress" if verbose else oc.report)
    with obs.use(tracer), obs.profile_trace(profile_dir):
        return _event_loop(cfg, model, clients, adapter,
                           algorithm=algorithm, mode=mode,
                           max_rounds=max_rounds, eval_every=eval_every,
                           eval_clients=eval_clients, seed=seed, name=name,
                           payload_mode=payload_mode, engine=engine,
                           device=device, rep=rep)


def _event_loop(cfg: ExperimentConfig, model,
                clients: List[ClientDataset],
                adapter: TopologyAdapter, *,
                algorithm: str, mode: str,
                max_rounds: Optional[int],
                eval_every: int, eval_clients: int,
                seed: int, name: Optional[str],
                payload_mode: Optional[str],
                engine: Optional[SimulationEngine],
                device, rep: obs.Reporter) -> SimResult:
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

    # per-UE inner learning rates α_i (paper §II-B)
    if fl.alpha_spread > 0:
        s = 1.0 + fl.alpha_spread
        alphas = fl.alpha * np.exp(rng.uniform(-np.log(s), np.log(s), size=n))
    else:
        alphas = np.full(n, fl.alpha)

    adapter.make_servers(params0)

    # --- per-UE state -------------------------------------------------------
    held_params: List[Any] = [params0 for _ in range(n)]
    d_i = np.array([min(fl.inner_batch + fl.outer_batch + fl.hessian_batch,
                        len(c)) for c in clients])
    busy_time = np.zeros(n)
    # batch shapes are a pure function of the shard size; a round whose UEs
    # share one signature can take the fused path
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
    # epoch-based lazy cancellation: a redistribution to a UE whose upload
    # is still in flight (τ > S forced refresh) abandons that computation;
    # the old event is dropped at pop time when its epoch is outdated.
    # event = (t_finish, seq, ue, version, duration, epoch, dispatch_cell)
    epoch = np.zeros(n, dtype=np.int64)
    fill_ues = np.arange(n)
    fill_cells = adapter.dispatch_cells(fill_ues)
    # events are totally ordered by (t, seq), so heapify yields the exact
    # pop sequence of n pushes
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

    def handle(result) -> None:
        nonlocal seq
        dist = result["distribute"]
        if dist:
            with obs.CURRENT.span("redistribute"):
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
            rep.progress(f"[{name or algorithm}-{mode}] round {k:4d} "
                         f"t={t_now:8.2f}s ploss={p:.4f} gloss={g:.4f}")

    while adapter.rounds_done() < max_rounds and heap:
        # ---- drain arrivals until the round would close ----------------------
        # No distribution (hence no cancellation) can occur before then, so
        # every drained payload is computable NOW, as one batch.
        drained = [0] * adapter.n_protocol_cells
        batch: List[Tuple[float, int, int, float, int]] = []
        closing: Optional[int] = None
        stale_pops = 0
        with obs.CURRENT.span("drain"):
            while heap:
                t, sq, ue, _version, dur, ev_epoch, cell = \
                    heapq.heappop(heap)
                if ev_epoch != epoch[ue]:
                    stale_pops += 1
                    continue            # abandoned (stale-refresh) cycle
                adapter.advance_to(t)
                batch.append((t, ue, sq, dur, cell))
                drained[cell] += 1
                if drained[cell] >= adapter.need(cell):
                    closing = cell
                    break
        if stale_pops:
            obs.CURRENT.add("driver.stale_pops", stale_pops)
        if not batch:
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
        elif engine.payload_mode == "sequential":
            obs.CURRENT.add("driver.rounds_sequential")
            with obs.CURRENT.span("sampling"):
                triplets = [clients[ue].sample_triplet(
                    fl.inner_batch, fl.outer_batch, fl.hessian_batch)
                    for ue in ues_arr]
            with obs.CURRENT.span("payload"):
                payloads = engine.compute_payloads(held, triplets, a_i)
            # ---- feed the protocol in arrival order ------------------------
            for (t, ue, _sq, dur, cell), payload in zip(batch, payloads):
                t_now = t
                busy_time[ue] += dur    # only completed cycles count as busy
                result = _protocol_call(adapter.on_arrival, cell, ue,
                                        payload)
                if result is not None:
                    handle(result)
        else:
            # ---- batch-wise feed: payloads stay stacked on device ----------
            # lanes grouped by batch-shape signature; each group samples its
            # triplets STACKED (bitwise the per-UE loop — the generators are
            # private) and the engine returns ONE stacked payload tree
            t_now = batch[-1][0]
            sig_groups: Dict[Tuple, List[int]] = {}
            for lane, ue in enumerate(ues_arr):
                sig_groups.setdefault(batch_sig[ue], []).append(lane)
            obs.CURRENT.add("driver.rounds_batchwise")
            with obs.CURRENT.span("sampling"):
                groups = [(lanes, sample_triplet_many(
                               [clients[int(ues_arr[i])] for i in lanes],
                               fl.inner_batch, fl.outer_batch,
                               fl.hessian_batch))
                          for lanes in sig_groups.values()]
            with obs.CURRENT.span("payload"):
                payloads_stacked = engine.compute_payloads_stacked(
                    held, groups, a_i)
            busy_time[ues_arr] += [b[3] for b in batch]   # completed cycles
            result = _protocol_call(adapter.on_arrival_batch, cells_arr,
                                    ues_arr, payloads_stacked)
            if result is not None:
                handle(result)

    proto = adapter.protocol()
    if engine.device.type == "cuda":
        # wall-clock timings of this function include all device work
        torch.cuda.synchronize(engine.device)

    # An exit BEFORE the round target with uploads still pending means the
    # event heap ran dry mid-round: count it and warn.
    pending = int(proto.pending_uploads())
    aborted = 1 if (adapter.rounds_done() < max_rounds and pending > 0) \
        else 0
    if aborted:
        obs.CURRENT.add("driver.aborted_round", aborted)
        rep.warn(f"[{name or f'{algorithm}-{mode}'}] event heap exhausted "
                 f"with {pending} pending upload(s) — completed "
                 f"{adapter.rounds_done()}/{max_rounds} rounds")

    wait_frac = float(1.0 - busy_time.sum() / max(n * t_now, 1e-9))
    return SimResult(
        name=name or f"{algorithm}-{mode}",
        times=np.array(times), losses=np.array(plosses),
        global_losses=np.array(glosses), accs=np.array(accs),
        rounds=np.array(rounds_at), total_time=t_now,
        pi=proto.pi_matrix(), eta_target=adapter.eta,
        eta_realised=proto.realised_eta(),
        wait_fraction=max(wait_frac, 0.0),
        payload_dispatches=engine.dispatches - disp0,
        payloads_computed=engine.payloads_computed - pay0,
        aborted_rounds=aborted, pending_uploads=pending,
        params=proto.params,
    )
