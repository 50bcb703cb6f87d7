"""Open-world churn / traffic scenario runtime (``cfg.scenario``).

The closed-world simulator assumes an immortal, stationary UE population.
``ScenarioRuntime`` relaxes that: it owns an *activity mask* over a fixed
UE universe of size n and a stream of timed lifecycle events the driver
interleaves with its upload heap —

* **joins** — a (possibly time-varying) Poisson process activates dormant
  UEs: λ(t) = ``arrival_rate`` · (1 + ``diurnal_amplitude`` ·
  sin(2π t / ``diurnal_period_s``)) · flash boost, sampled exactly by
  Lewis–Shedler thinning.  The driver prices the joining UE a fresh cycle
  and hands it the current model.
* **departures** — each active UE carries an exponential departure hazard
  (aggregate rate ``departure_rate`` · n_active, memoryless, re-armed on
  every membership change); the driver cancels the leaver's in-flight
  upload through its epoch mechanism.
* **flash crowd** — a one-shot window start event (the driver boosts
  nothing itself: the arrival intensity already folds the boost in; the
  event retargets a fraction of random-waypoint UEs at the hotspot BS).
* **label drift** — each active UE carries a drift hazard; firing remaps
  a fraction of that client's labels (``ClientDataset.drift_labels``).

All randomness draws from ONE auxiliary generator seeded by
``(sim seed, scenario seed, stream tag)`` — the fading, mobility, and
payload RNG schedules are untouched, which is what lets a zero-rate
enabled scenario stay bitwise identical to the closed-world goldens.

Alive-time integration: the runtime tracks per-UE alive intervals so the
driver's ``wait_fraction`` can divide busy time by seconds of *existence*
rather than ``n · t`` (which charges departed UEs their whole absence as
idle).  With no churn events the total is exactly ``n · t``.

A copy of the JAX package's ``fl/scenario.py``, draw for draw: the event
stream, and with it every count and time it drives, matches bitwise.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.config import ScenarioConfig

__all__ = ["ScenarioRuntime", "make_scenario"]

_SCEN_STREAM = 0x7363656E     # "scen" — decorrelates the scenario stream
_INF = float("inf")

# event kinds the driver switches on
JOIN, LEAVE, DRIFT, FLASH = "join", "leave", "drift", "flash"


class ScenarioRuntime:
    """Timed open-world events over a fixed UE universe (see module doc)."""

    def __init__(self, cfg: ScenarioConfig, n: int, *, seed: int = 0):
        if not 0.0 <= cfg.diurnal_amplitude <= 1.0:
            raise ValueError("diurnal_amplitude must be in [0, 1], got "
                             f"{cfg.diurnal_amplitude}")
        if cfg.flash_arrival_boost < 0.0:
            raise ValueError("flash_arrival_boost must be >= 0")
        self.cfg = cfg
        self.n = n
        # independent auxiliary stream: scenario draws never perturb the
        # simulator's fading / mobility / payload schedules
        self.rng = np.random.default_rng([seed, cfg.seed, _SCEN_STREAM])

        k = max(1, min(n, int(round(cfg.initial_active_frac * n))))
        self.active = np.zeros(n, dtype=bool)
        if k == n:
            self.active[:] = True
        else:
            self.active[np.sort(self.rng.choice(n, size=k,
                                                replace=False))] = True
        # alive-time integration (wait_fraction denominator)
        self.alive_s = np.zeros(n)
        self.alive_since = np.where(self.active, 0.0, np.nan)

        self.ue_joins = 0
        self.ue_departures = 0
        self.label_drifts = 0
        self.log: List[Tuple[float, str, int]] = []   # (t, kind, ue)

        self._t = 0.0                 # time of the last processed event
        self._arr_at = self._gen_arrival(0.0)
        self._dep_at = self._gen_exp(0.0, cfg.departure_rate)
        self._drift_at = self._gen_exp(0.0, cfg.drift_rate)
        self._flash_at = cfg.flash_time_s if cfg.flash_time_s >= 0.0 \
            else _INF

    # ------------------------------------------------------------------
    # intensity model
    # ------------------------------------------------------------------
    def _in_flash(self, t: float) -> bool:
        c = self.cfg
        return (c.flash_time_s >= 0.0
                and c.flash_time_s <= t < c.flash_time_s
                + c.flash_duration_s)

    def arrival_intensity(self, t: float) -> float:
        """λ(t): base rate × diurnal wave × flash boost [joins/s]."""
        c = self.cfg
        lam = c.arrival_rate
        if c.diurnal_amplitude > 0.0 and c.diurnal_period_s > 0.0:
            lam *= 1.0 + c.diurnal_amplitude * np.sin(
                2.0 * np.pi * t / c.diurnal_period_s)
        if self._in_flash(t):
            lam *= c.flash_arrival_boost
        return float(lam)

    def _past_horizon(self, t: float) -> bool:
        return self.cfg.horizon_s > 0.0 and t > self.cfg.horizon_s

    def _gen_arrival(self, t0: float) -> float:
        """Next accepted arrival after ``t0`` by Lewis–Shedler thinning
        against the envelope λ_max = rate·(1+amp)·max(boost, 1)."""
        c = self.cfg
        lam_max = c.arrival_rate * (1.0 + c.diurnal_amplitude) \
            * max(c.flash_arrival_boost, 1.0)
        if lam_max <= 0.0:
            return _INF
        t = t0
        while True:
            t += self.rng.exponential(1.0 / lam_max)
            if self._past_horizon(t):
                return _INF
            if self.rng.random() * lam_max <= self.arrival_intensity(t):
                return t

    def _gen_exp(self, t0: float, per_ue_rate: float) -> float:
        """Next event of an aggregate exponential clock (rate scales with
        the live population; memoryless, so re-arming on membership
        change is exact)."""
        rate = per_ue_rate * int(self.active.sum())
        if rate <= 0.0:
            return _INF
        t = t0 + self.rng.exponential(1.0 / rate)
        return _INF if self._past_horizon(t) else t

    def _rearm(self, t: float) -> None:
        """Membership changed at ``t``: re-draw the population-scaled
        clocks (exponentials are memoryless — this is distributionally
        exact, not an approximation)."""
        self._dep_at = self._gen_exp(t, self.cfg.departure_rate)
        self._drift_at = self._gen_exp(t, self.cfg.drift_rate)

    # ------------------------------------------------------------------
    # event interface (driver side)
    # ------------------------------------------------------------------
    def next_time(self) -> float:
        """Time of the next scheduled scenario event (inf when none)."""
        return min(self._arr_at, self._dep_at, self._drift_at,
                   self._flash_at)

    def can_spawn(self) -> bool:
        """Whether a future join can still create upload events — the
        only scenario event kind that feeds the driver's heap.  When the
        heap is dry and this is False the run is over: departures/drift
        alone can never restart progress.  A full pool still spawns if a
        departure can free a slot first."""
        if self._arr_at >= _INF:
            return False
        if not bool(self.active.all()):
            return True
        # full pool: a join needs a departure to free a slot first, which
        # the min_active floor must permit
        return self._dep_at < _INF and self.n > max(self.cfg.min_active, 1)

    def next_event(self, t_limit: float
                   ) -> Optional[Tuple[float, str, int]]:
        """Pop and apply the next *actionable* event at or before
        ``t_limit``; returns ``(t, kind, ue)`` (ue = −1 for flash) or
        ``None``.  Non-actionable firings (a join with no dormant UE
        left, a departure at the ``min_active`` floor) are consumed
        silently — their stream still advances."""
        while True:
            t = self.next_time()
            if t > t_limit:
                return None
            if t == self._arr_at:
                self._arr_at = self._gen_arrival(t)
                ue = self._pick(~self.active)
                if ue < 0:
                    continue                      # nobody left to join
                self._join(ue, t)
                return (t, JOIN, ue)
            if t == self._dep_at:
                if int(self.active.sum()) <= max(self.cfg.min_active, 1):
                    self._dep_at = self._gen_exp(
                        t, self.cfg.departure_rate)
                    continue                      # at the population floor
                ue = self._pick(self.active)
                self._leave(ue, t)
                return (t, LEAVE, ue)
            if t == self._drift_at:
                self._drift_at = self._gen_exp(t, self.cfg.drift_rate)
                ue = self._pick(self.active)
                if ue < 0:
                    continue
                self.label_drifts += 1
                self.log.append((t, DRIFT, ue))
                return (t, DRIFT, ue)
            # flash window start (one-shot)
            self._flash_at = _INF
            self.log.append((t, FLASH, -1))
            return (t, FLASH, -1)

    def _pick(self, mask: np.ndarray) -> int:
        idx = np.nonzero(mask)[0]
        if len(idx) == 0:
            return -1
        return int(idx[self.rng.integers(len(idx))])

    def _join(self, ue: int, t: float) -> None:
        self.active[ue] = True
        self.alive_since[ue] = t
        self.ue_joins += 1
        self.log.append((t, JOIN, ue))
        self._rearm(t)

    def _leave(self, ue: int, t: float) -> None:
        self.active[ue] = False
        self.alive_s[ue] += t - self.alive_since[ue]
        self.alive_since[ue] = np.nan
        self.ue_departures += 1
        self.log.append((t, LEAVE, ue))
        self._rearm(t)

    # ------------------------------------------------------------------
    # flash-crowd hotspot targets
    # ------------------------------------------------------------------
    def hotspot_targets(self) -> np.ndarray:
        """Active UEs to retarget at the hotspot BS when the flash window
        opens (``flash_hotspot_frac`` of the live population)."""
        idx = np.nonzero(self.active)[0]
        k = int(round(self.cfg.flash_hotspot_frac * len(idx)))
        if k <= 0 or len(idx) == 0:
            return np.empty(0, dtype=np.int64)
        return np.sort(self.rng.choice(idx, size=min(k, len(idx)),
                                       replace=False))

    # ------------------------------------------------------------------
    # alive-time integration
    # ------------------------------------------------------------------
    def alive_total(self, t: float) -> float:
        """Σ_i seconds UE i existed in [0, t].  With zero churn this is
        exactly ``n · t`` (so the churn-free ``wait_fraction`` stays
        bitwise identical to the legacy denominator)."""
        open_s = float(self.active.sum()) * t \
            - float(np.nansum(np.where(self.active, self.alive_since, 0.0)))
        return float(self.alive_s.sum()) + open_s

    def was_alive(self, ue: int, t: float) -> bool:
        """Test support: was ``ue`` active at time ``t``?  Replays the
        event log from the UE's t=0 state, so it stays correct however
        many joins/leaves the UE has been through."""
        alive = self._initially_active(ue)
        for (te, kind, u) in self.log:
            if te > t:
                break
            if u != ue:
                continue
            if kind == JOIN:
                alive = True
            elif kind == LEAVE:
                alive = False
        return alive

    def _initially_active(self, ue: int) -> bool:
        """Reconstruct the t=0 activity bit by unwinding the UE's logged
        join/leave events from its current state."""
        alive = bool(self.active[ue])
        for (_te, kind, u) in reversed(self.log):
            if u != ue:
                continue
            if kind == JOIN:
                alive = False        # before the join it was dormant
            elif kind == LEAVE:
                alive = True
        return alive


def make_scenario(cfg: ScenarioConfig, n: int,
                  seed: int) -> Optional[ScenarioRuntime]:
    """The driver's entry point: a runtime when the scenario is enabled,
    else ``None`` (closed world, zero overhead)."""
    if not cfg.enabled:
        return None
    return ScenarioRuntime(cfg, n, seed=seed)
