"""Static single-cell simulation of PerFedS² (the paper's Sec. VI setup).

Combines all the pieces:

  wireless.EdgeNetwork   — geometry, Rayleigh fading, heterogeneous CPUs
  core.bandwidth         — Theorem-2/4 allocations (or equal-split baseline)
  core.scheduler         — SchedulingPolicy (equal / rates-derived η)
  core.server            — Algorithm 1 round protocol (sync / semi / async)
  fl.engine              — batched (vmap-bucketed) payload computation
  fl.driver              — the ONE event loop (heap, drain batching, fused
                           dispatch, SimResult)
  fl.client              — payload math (perfed / fedavg / fedprox / pfedme)

``run_simulation`` is a thin configuration of ``fl.driver.run_event_loop``:
the ``StaticAdapter`` below contributes a frozen single-cell drop, a static
Theorem-4 (or equal-split) bandwidth allocation, and one global
``SemiSyncServer``; everything event-driven lives in the shared driver.
The mobile multi-cell path (``cfg.mobility.enabled``) configures the same
loop with a ``MobileAdapter`` — see ``fl/mobile.py``.

The port of the JAX package's ``fl/simulation.py``; entry points run on the
card (``device="cuda"``) unless the caller asks for the CPU.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.config import ExperimentConfig
from repro_torch.core.bandwidth import weighted_equal_rate_allocation
from repro_torch.core.scheduler import get_policy
from repro_torch.core.server import SemiSyncServer, ServerConfig
from repro_torch.data.partition import ClientDataset
from repro_torch.fl.driver import SimResult, TopologyAdapter, run_event_loop
from repro_torch.fl.engine import SimulationEngine
from repro_torch.wireless.channel import EdgeNetwork

__all__ = ["SimResult", "StaticAdapter", "run_simulation"]


class StaticAdapter(TopologyAdapter):
    """Frozen single-cell geometry + one global Algorithm-1 server."""

    def __init__(self, cfg: ExperimentConfig, n: int, *, seed: int,
                 bandwidth_policy: str, mode: str):
        fl, wl = cfg.fl, cfg.wireless
        policy = get_policy(fl.eta_mode)
        self.net = EdgeNetwork.drop(wl, n, seed=seed,
                                    uniform_distance=policy.uniform_drop)
        self.eta = policy.frequencies(n, self.net)
        h_mean = wl.rayleigh_scale * float(np.sqrt(np.pi / 2))
        mean_chans = [self.net.channel(i, h_mean) for i in range(n)]
        if bandwidth_policy == "optimal":
            self.bw = weighted_equal_rate_allocation(self.eta, mean_chans,
                                                     wl.total_bandwidth_hz)
        elif bandwidth_policy == "equal":
            self.bw = np.full(n, wl.total_bandwidth_hz / n)
        else:
            raise ValueError(f"unknown bandwidth policy {bandwidth_policy!r}")
        self._fl, self._mode, self._n = fl, mode, n
        self.server: Optional[SemiSyncServer] = None
        # open-world scenario state (inert when cfg.scenario is off); the
        # static drop has no mobility, so churn here is joins/leaves/drift
        # over a frozen geometry (bandwidth keeps the drop-time split)
        self._adaptive_a = cfg.scenario.enabled and cfg.scenario.adaptive_cell_a
        self._active_mask: Optional[np.ndarray] = None

    # --- protocol ------------------------------------------------------
    def make_servers(self, params0) -> None:
        fl = self._fl
        self.server = SemiSyncServer(params0, ServerConfig(
            n_ues=self._n, participants_per_round=fl.participants_per_round,
            staleness_bound=fl.staleness_bound, beta=fl.beta,
            mode=self._mode, staleness_discount=fl.staleness_discount))
        if self._active_mask is not None:
            self.server.ue_active[:] = self._active_mask
            self.pre_drain()

    def rounds_done(self) -> int:
        return self.server.round

    def need(self, cell: int) -> int:
        return self.server.arrivals_until_round()

    def participants(self, cell: int) -> int:
        # effective round size (== A unless clamped by the live cap)
        return self.server.target

    def on_arrival(self, cell, ue, payload):
        return self.server.on_arrival(ue, payload)

    def on_arrival_batch(self, cells, ues, payloads):
        return self.server.on_arrival_batch(ues, payloads)

    def on_round_batch(self, cell, ues, aggregate_fn):
        return self.server.on_round_batch(ues, aggregate_fn)

    def protocol(self):
        return self.server

    # --- open-world scenario hooks -------------------------------------
    def bind_active(self, mask: np.ndarray) -> None:
        self._active_mask = mask        # shared with the scenario runtime

    def pre_drain(self) -> None:
        # cap = pending + in-flight (live members whose upload is already
        # held can't produce another arrival before the close)
        if self._adaptive_a and self._active_mask is not None:
            live = int(self._active_mask.sum())
            pend = self.server.pending_ue_set()
            live_pending = sum(1 for u in pend if self._active_mask[u])
            self.server.set_live_cap(live, live - live_pending)

    def flush_ready(self):
        if not (self._adaptive_a and self._active_mask is not None):
            return []
        res = self.server.flush()
        return [res] if res is not None else []

    def on_join(self, ue: int):
        self.server.activate(ue)
        return self.server.params

    def on_leave(self, ue: int) -> None:
        self.server.deactivate(ue)

    def cell_membership(self):
        if self._active_mask is None:
            return None
        return [int(self._active_mask.sum())]


def run_simulation(cfg: ExperimentConfig, model, clients: List[ClientDataset],
                   *, algorithm: str = "perfed", mode: str = "semi",
                   bandwidth_policy: str = "optimal",
                   max_rounds: Optional[int] = None,
                   eval_every: int = 5, eval_clients: int = 8,  # 0 = no eval
                   seed: int = 0, name: Optional[str] = None,
                   verbose: bool = False,
                   payload_mode: Optional[str] = None,  # default: batched
                   engine: Optional[SimulationEngine] = None,
                   device="cuda",
                   **obs_kw) -> SimResult:
    """Run the paper's simulation on ``device`` (the card by default; the
    CPU only when asked).  ``obs_kw`` forwards the telemetry knobs
    (``tracer`` / ``trace_dir`` / ``profile_dir`` / ``reporter``) to
    ``run_event_loop``."""
    if cfg.mobility.enabled:
        # mobile multi-cell path (time-varying channels, handovers,
        # optional cell→cloud hierarchy) — fl/mobile.py; the static path
        # below stays bitwise untouched when the flag is off
        from repro_torch.fl.mobile import run_mobile_simulation
        return run_mobile_simulation(
            cfg, model, clients, algorithm=algorithm, mode=mode,
            bandwidth_policy=bandwidth_policy, max_rounds=max_rounds,
            eval_every=eval_every, eval_clients=eval_clients, seed=seed,
            name=name, verbose=verbose, payload_mode=payload_mode,
            engine=engine, device=device, **obs_kw)
    adapter = StaticAdapter(cfg, len(clients), seed=seed,
                            bandwidth_policy=bandwidth_policy, mode=mode)
    return run_event_loop(cfg, model, clients, adapter,
                          algorithm=algorithm, mode=mode,
                          max_rounds=max_rounds, eval_every=eval_every,
                          eval_clients=eval_clients, seed=seed, name=name,
                          verbose=verbose, payload_mode=payload_mode,
                          engine=engine, device=device, **obs_kw)
