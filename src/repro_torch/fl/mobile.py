"""Mobile multi-cell simulation driver (``cfg.mobility.enabled=True``).

The same event-driven PerFedS² loop as ``fl/simulation.py`` — literally:
both are thin configurations of ``fl.driver.run_event_loop``.  The
``MobileAdapter`` below contributes what mobility changes:

* UE positions advance under a vectorized mobility model as simulated time
  passes, so path loss — and therefore upload times and the straggler
  population — is *time-varying* (``advance_to``).
* Each UE associates under ``mobility.association`` (pure nearest-BS, or
  load-aware: distance plus a members-per-budget penalty so hot cells shed
  UEs); handovers re-home it to the new cell's scheduler and bandwidth
  budget (cells whose membership changed are re-allocated lazily, at the
  next requeue that touches them — ``pre_requeue``).
* Each cell owns its own uplink budget (``mobility.cell_bandwidth_hz``:
  macro/micro mixes; unset → every cell owns the full system bandwidth)
  and splits it per ``bandwidth_policy``: ``equal`` (even split over
  members), ``optimal`` (Theorem-4 weighted-equal-rate), or ``theorem2``
  (the paper's per-round equal-finish bisection over the cell's current
  members, warm-started from the cell's previous ``t_star`` — previously
  only the static path's benchmarks ran it).
* With ``mobility.hierarchy`` on, each cell runs its own semi-synchronous
  edge server (Eq. 8 via the engine's fused ``stale_aggregate_tree`` path)
  and a cloud tier merges cell models every ``cloud_sync_every`` edge
  rounds (``core/hierarchy.py``).

Arrival routing: heap events carry the cell that *dispatched* the cycle
(the UE's association at cycle start), and the driver routes each arrival
back to that cell.  An upload in flight across a handover therefore counts
toward — and closes — the round it was computed against, and
``HierarchicalServer``'s departed-UE bookkeeping (visiting staleness, no
membership resurrection) actually fires.  Routing by pop-time association,
as the pre-unification driver did, both mis-credited such uploads to the
destination cell and made the departed path dead code.

Degenerate configuration (speed 0, one cell, hierarchy off) reproduces the
static single-cell driver **bitwise** for the same seed: the network
consumes the main RNG stream in the legacy order, the drain yields the
identical batches, and all engine calls receive identical inputs.

The port of the JAX package's ``fl/mobile.py``: the topology and the
bandwidth math (Theorem-2 bisection included) stay float64 numpy, so they
match the reference bitwise; the protocol's device math runs in torch on
the run's ``device``.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.config import ExperimentConfig
from repro_torch.core.bandwidth import (equal_finish_allocation,
                                  weighted_equal_rate_allocation)
from repro_torch.core.hierarchy import HierarchicalServer, HierarchyConfig
from repro_torch.core.scheduler import get_policy
from repro_torch.core.server import SemiSyncServer, ServerConfig
from repro_torch.data.partition import ClientDataset
from repro_torch.fl.driver import SimResult, TopologyAdapter, run_event_loop
from repro_torch.fl.engine import SimulationEngine
from repro_torch.mobility.multicell import MultiCellNetwork
from repro_torch.obs import trace as obs
from repro_torch.wireless.channel import noise_w_per_hz, pathloss_pow
from repro_torch.wireless.timing import compute_times

__all__ = ["SimResult", "MobileAdapter", "run_mobile_simulation"]


class MobileAdapter(TopologyAdapter):
    """Moving multi-cell topology + per-cell (or flat) semi-sync protocol."""

    def __init__(self, cfg: ExperimentConfig, n: int, *, seed: int,
                 bandwidth_policy: str, mode: str):
        fl, mob, wl = cfg.fl, cfg.mobility, cfg.wireless
        policy = get_policy(fl.eta_mode)
        self.net = MultiCellNetwork.drop(
            wl, n, n_cells=mob.n_cells, seed=seed, mobility=mob.model,
            speed_mps=mob.speed_mps, pause_s=mob.pause_s,
            gm_alpha=mob.gm_alpha, uniform_distance=policy.uniform_drop,
            step_s=mob.step_s, cell_bandwidth_hz=mob.cell_bandwidth_hz,
            association=mob.association, load_penalty_m=mob.load_penalty_m,
            reassoc=mob.reassoc)
        self.eta = policy.frequencies(n, self.net)
        self._h_mean = wl.rayleigh_scale * float(np.sqrt(np.pi / 2))

        if bandwidth_policy not in ("optimal", "equal", "theorem2"):
            raise ValueError(f"unknown bandwidth policy {bandwidth_policy!r}")
        self._bandwidth_policy = bandwidth_policy
        self._wl = wl
        # Theorem-2 link-budget inputs: bound by the driver via
        # bind_link_budget (Z depends on the model, which does not exist
        # yet); until then theorem2 cells fall back to an equal split of
        # their own budget — never actually priced, because binding marks
        # every cell dirty and pre_requeue runs before the first pricing
        self._z_bits: float = 0.0
        self._tcmp: Optional[np.ndarray] = None
        self._t_star = np.zeros(self.net.n_cells)   # warm-start per cell
        self.bw = np.zeros(n)
        self._dirty_cells: set = set()
        for c in range(self.net.n_cells):
            self._realloc(c)

        self._hier_on = mob.hierarchy and mob.n_cells > 1
        if self._hier_on and mode != "semi":
            raise ValueError("hierarchical aggregation runs semi-sync edge "
                             f"servers; mode={mode!r} is not supported")
        self.n_protocol_cells = mob.n_cells if self._hier_on else 1
        self._fl, self._mob, self._mode, self._n = fl, mob, mode, n
        self.hier: Optional[HierarchicalServer] = None
        self.server: Optional[SemiSyncServer] = None
        # open-world scenario state (inert when cfg.scenario is off):
        # adaptive per-cell A — clamp each cell's close threshold to live
        # membership so a shrunken cell keeps closing rounds (the fix for
        # the frozen-at-init-A live-lock)
        self._scen = cfg.scenario
        self._adaptive_a = cfg.scenario.enabled and cfg.scenario.adaptive_cell_a
        self._active_mask: Optional[np.ndarray] = None

    # --- per-cell bandwidth (re-allocated lazily on membership change) -
    def bind_link_budget(self, z_bits: float, d_i: np.ndarray) -> None:
        """Driver hook: receive Z and per-UE sample counts, then force a
        re-allocation of every cell so the theorem2 policy prices real
        link budgets from the very first cycle."""
        self._z_bits = float(z_bits)
        self._tcmp = compute_times(self._wl.cpu_cycles_per_sample, d_i,
                                   self.net.cpu_freq)
        if self._bandwidth_policy == "theorem2":
            self._dirty_cells.update(range(self.net.n_cells))

    def _realloc(self, c: int) -> None:
        members = self.net.cell_members(c)
        if len(members) == 0:
            # drop the theorem2 warm-start: the old membership's t_star is
            # meaningless once the cell empties, and a re-populated cell
            # must not seed its equal-finish bisection from it
            self._t_star[c] = 0.0
            return
        budget = float(self.net.cell_bw[c])
        if self._bandwidth_policy == "optimal":
            chans = [self.net.channel(i, self._h_mean) for i in members]
            self.bw[members] = weighted_equal_rate_allocation(
                self.eta[members], chans, budget)
        elif self._bandwidth_policy == "theorem2" and self._tcmp is not None:
            self._realloc_theorem2(c, members, budget)
        else:
            self.bw[members] = budget / len(members)

    def _realloc_theorem2(self, c: int, members: np.ndarray,
                          budget: float) -> None:
        """Theorem-2 equal-finish split of the cell's budget over its
        current members (mean-fading channel snapshot, true per-UE compute
        times), warm-started from the cell's previous ``t_star``.  A
        non-converged bisection is retried cold with a wider iteration
        budget; if it *still* reports non-convergence the cell falls back
        to an equal split rather than trusting an allocation that no
        longer equalises finish times (the ``converged`` contract of
        ``EqualFinishAllocation``).

        The SNR numerators go in directly as ``q`` — same values, to the
        bit, as building per-member ``UEChannel``s (``pathloss_pow`` keeps
        d^{−κ} on scalar pow exactly as ``UEChannel.q`` does), without the
        throwaway object list on every membership change."""
        wl = self._wl
        q = wl.tx_power_w * self._h_mean \
            * pathloss_pow(self.net.distances[members], wl.path_loss_exp) \
            / noise_w_per_hz(wl.noise_dbm_per_hz)
        z = np.full(len(members), self._z_bits)
        tc = self._tcmp[members]
        hint = float(self._t_star[c]) if self._t_star[c] > 0 else None
        res = equal_finish_allocation(z, tc, None, budget, t_hint=hint, q=q)
        if not res.converged:
            res = equal_finish_allocation(z, tc, None, budget, max_iter=400,
                                          q=q)
        if res.converged:
            self.bw[members] = res.b
            self._t_star[c] = res.t_star
        else:
            self.bw[members] = budget / len(members)
            self._t_star[c] = 0.0

    # --- protocol ------------------------------------------------------
    def make_servers(self, params0) -> None:
        fl, mob, n = self._fl, self._mob, self._n
        if self._hier_on:
            a_req = mob.cell_participants or max(
                1, -(-fl.participants_per_round // mob.n_cells))
            members0 = [self.net.cell_members(c) for c in range(mob.n_cells)]
            # Legacy behaviour: cap each cell's A at its *initial*
            # population, frozen for the whole run.  That prevents a
            # never-closable round at t=0, but handovers/churn can still
            # drop a cell below its frozen A later — it then starves its
            # members forever.  The adaptive mode keeps the nominal A and
            # clamps the effective close threshold to LIVE membership,
            # re-pushed before every drain (``pre_drain``).
            cell_cfgs = [ServerConfig(
                n_ues=n,
                participants_per_round=(
                    a_req if self._adaptive_a
                    else max(1, min(a_req, max(len(m), 1)))),
                staleness_bound=fl.staleness_bound, beta=fl.beta,
                mode="semi", staleness_discount=fl.staleness_discount)
                for m in members0]
            self.hier = HierarchicalServer(
                params0, cell_cfgs,
                HierarchyConfig(n_cells=mob.n_cells,
                                cloud_sync_every=mob.cloud_sync_every),
                members0)
            if self._adaptive_a:
                self.pre_drain()        # clamp before the first drain too
        else:
            self.server = SemiSyncServer(params0, ServerConfig(
                n_ues=n, participants_per_round=fl.participants_per_round,
                staleness_bound=fl.staleness_bound, beta=fl.beta,
                mode=self._mode, staleness_discount=fl.staleness_discount))
            if self._active_mask is not None:
                # dormant UEs must neither be distributed to nor appear
                # stale: deactivate them in the flat server
                self.server.ue_active[:] = self._active_mask
                if self._adaptive_a:
                    self.pre_drain()

    def rounds_done(self) -> int:
        return self.hier.edge_rounds if self.hier is not None \
            else self.server.round

    def need(self, cell: int) -> int:
        if self.hier is not None:
            return self.hier.arrivals_until_round(cell)
        return self.server.arrivals_until_round()

    def participants(self, cell: int) -> int:
        # the EFFECTIVE round size (== A unless live-cap clamped): the
        # fused-dispatch path batches exactly this many lanes
        return self.hier.cells[cell].target if self.hier is not None \
            else self.server.target

    def on_arrival(self, cell, ue, payload):
        if self.hier is not None:
            return self.hier.on_arrival(cell, ue, payload)
        return self.server.on_arrival(ue, payload)

    def on_arrival_batch(self, cells, ues, payloads):
        if self.hier is not None:
            return self.hier.on_arrival_batch(cells, ues, payloads)
        return self.server.on_arrival_batch(ues, payloads)

    def on_round_batch(self, cell, ues, aggregate_fn):
        if self.hier is not None:
            return self.hier.on_round_batch(cell, ues, aggregate_fn)
        return self.server.on_round_batch(ues, aggregate_fn)

    def protocol(self):
        return self.hier if self.hier is not None else self.server

    # --- topology ------------------------------------------------------
    def dispatch_cell(self, ue: int) -> int:
        # stamped on the heap event so the arrival routes back here even
        # if the UE hands over while the upload is in flight
        return int(self.net.assoc[ue]) if self.hier is not None else 0

    def dispatch_cells(self, ues) -> np.ndarray:
        ues = np.asarray(ues, dtype=np.int64)
        if self.hier is not None:
            return self.net.assoc[ues].astype(np.int64)
        return np.zeros(len(ues), dtype=np.int64)

    def advance_to(self, t: float) -> None:
        for (u, src, dst) in self.net.advance_to(t):
            if self.hier is not None:
                self.hier.handover(u, src, dst)
            self._dirty_cells.add(src)
            self._dirty_cells.add(dst)

    def pre_requeue(self, ues) -> None:
        # vectorized: the common warm-path case (no membership change
        # since the last pricing) exits on one set check instead of a
        # python loop over every requeued lane
        if not self._dirty_cells:
            return
        with obs.CURRENT.span("bandwidth"):
            touched = np.unique(
                self.net.assoc[np.asarray(ues, dtype=np.int64)])
            for c in touched:
                c = int(c)
                if c in self._dirty_cells:
                    self._realloc(c)
                    self._dirty_cells.discard(c)

    # --- open-world scenario hooks -------------------------------------
    def bind_active(self, mask: np.ndarray) -> None:
        # shared reference: the scenario runtime flips bits in place and
        # the network's membership queries see them immediately
        self._active_mask = mask
        self.net.active = mask

    def pre_drain(self) -> None:
        # cap = pending + in-flight: live members whose upload is already
        # held can't produce another arrival before the close, so they
        # are subtracted from the members that still can
        if not self._adaptive_a:
            return
        counts = self.net.cell_counts()
        if self.hier is not None:
            for c in range(self.net.n_cells):
                pend = self.hier.cells[c].pending_ue_set()
                members = self.net.cell_members(c)
                in_flight = int(sum(1 for u in members
                                    if int(u) not in pend))
                self.hier.set_live_cap(c, int(counts[c]), in_flight)
        elif self.server is not None:
            pend = self.server.pending_ue_set()
            live = int(counts.sum())
            live_pending = 0 if self._active_mask is None else \
                sum(1 for u in pend if self._active_mask[u])
            self.server.set_live_cap(live, live - live_pending)

    def flush_ready(self):
        if not self._adaptive_a:
            return []
        if self.hier is not None:
            out = []
            for c in range(self.net.n_cells):
                res = self.hier.flush(c)
                if res is not None:
                    out.append(res)
            return out
        res = self.server.flush()
        return [res] if res is not None else []

    def on_join(self, ue: int):
        cell = int(self.net.assoc[ue])
        self._dirty_cells.add(cell)     # bandwidth re-split with the joiner
        if self.hier is not None:
            self.hier.join(ue, cell)
            return self.hier.cells[cell].params
        self.server.activate(ue)
        return self.server.params

    def on_leave(self, ue: int) -> None:
        # net.active is the scenario's mask (already flipped); drop the
        # leaver from its cell's membership bookkeeping + bandwidth split
        self._dirty_cells.add(int(self.net.assoc[ue]))
        if self.hier is not None:
            self.hier.leave(ue)
        else:
            self.server.deactivate(ue)

    def on_flash(self, idx: np.ndarray, rng: np.random.Generator) -> int:
        hotspot = min(max(self._scen.flash_hotspot_cell, 0),
                      self.net.n_cells - 1)
        return self.net.retarget_waypoints(
            idx, hotspot, self._wl.cell_radius_m / 4.0, rng)

    def cell_membership(self):
        if self._active_mask is None:
            return None
        counts = self.net.cell_counts()
        if self.hier is not None:
            return [int(c) for c in counts]
        return [int(counts.sum())]

    def result_extras(self):
        return {
            "n_cells": self.net.n_cells,
            "handovers": self.net.handovers,
            "cloud_rounds":
                self.hier.cloud_rounds if self.hier is not None else 0,
            "departed_arrivals":
                self.hier.departed_arrivals if self.hier is not None else 0,
        }


def run_mobile_simulation(cfg: ExperimentConfig, model,
                          clients: List[ClientDataset], *,
                          algorithm: str = "perfed", mode: str = "semi",
                          bandwidth_policy: str = "optimal",
                          max_rounds: Optional[int] = None,
                          eval_every: int = 5, eval_clients: int = 8,
                          seed: int = 0, name: Optional[str] = None,
                          verbose: bool = False,
                          payload_mode: Optional[str] = None,
                          engine: Optional[SimulationEngine] = None,
                          device="cuda",
                          **obs_kw) -> SimResult:
    """The mobile multi-cell simulation on ``device`` (the card by default;
    the CPU only when asked).  ``obs_kw`` forwards the telemetry knobs
    (``tracer`` / ``trace_dir`` / ``profile_dir`` / ``reporter``) to
    ``run_event_loop``."""
    adapter = MobileAdapter(cfg, len(clients), seed=seed,
                            bandwidth_policy=bandwidth_policy, mode=mode)
    return run_event_loop(cfg, model, clients, adapter,
                          algorithm=algorithm, mode=mode,
                          max_rounds=max_rounds, eval_every=eval_every,
                          eval_clients=eval_clients, seed=seed, name=name,
                          verbose=verbose, payload_mode=payload_mode,
                          engine=engine, device=device, **obs_kw)
