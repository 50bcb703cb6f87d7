"""Multi-cell mobile edge network: several BSs, moving UEs, handovers.

Generalises ``wireless.channel.EdgeNetwork`` (one static cell) to a hex-ish
grid of base stations with UEs that move under a ``MobilityModel`` and
associate under a pluggable policy.  The channel API (``sample_fading`` /
``channel`` / ``channels`` / ``mean_rates`` / ``distances``) is a drop-in
superset of ``EdgeNetwork``'s, so ``SchedulingPolicy`` and the Theorem-2/4
bandwidth allocators work per cell unchanged.

Heterogeneous radio resources: each BS owns its own uplink budget
``cell_bw[c]`` (``resolve_cell_bandwidth`` broadcasts a scalar or validates
a per-cell vector; the empty spec reproduces the legacy behaviour where
every cell owns the full system bandwidth).  Association is either

* ``nearest``     — pure nearest-BS (the bitwise-identical default), or
* ``load_aware``  — best-response iteration on an effective distance
  ``d(u, c) + load_penalty_m · members_c / fair_share_c`` with the fair
  share proportional to the cell's bandwidth budget: hot (or skinny-budget)
  cells shed UEs to neighbours, which changes the handover dynamics
  (cf. the macro/micro setting of arXiv:2303.10580).

RNG discipline — two independent streams:

* ``rng``      (main, ``default_rng(seed)``): consumed in exactly the order
  ``EdgeNetwork.drop`` consumes it (distance radii, CPU frequencies, then
  Rayleigh fading per ``sample_fading``), so a 1-cell static drop is
  **bitwise identical** to the legacy network for the same seed.
* ``mob_rng``  (auxiliary): drop angles, multi-cell positions, and all
  mobility-model draws — extra geometry never perturbs the fading stream.

``advance_to(t)`` runs the simulation clock.  Two properties keep its
amortized per-call cost O(1) even though the event loop calls it once per
heap pop (tens of thousands of times per run):

* **Grid-aligned ticks** — integration steps live on the global
  ``step_s`` grid (tick ``j`` covers ``[j·step_s, (j+1)·step_s)``), and an
  advance integrates all newly-completed ticks with one batched
  ``[ticks, n, D]`` RNG draw (``MobilityModel.step_many``).  Positions —
  and hence the mobility RNG schedule — are a pure function of *which*
  ticks have elapsed, never of how the event loop grouped them into calls
  (``advance_to(t1); advance_to(t2)`` ≡ ``advance_to(t2)`` bitwise).
  Calls that complete no tick are pure clock updates.
* **Safe-radius re-association** — every re-score records a per-UE
  handover margin (half the gap to the runner-up BS, in metres); on later
  ticks only UEs whose displacement since their last score reaches that
  margin are re-scored against the full BS list.  Exact for ``nearest``
  by the triangle inequality; for ``load_aware`` the margin is measured
  on *effective* cost and gates whether the best-response recompute runs
  at all (loads can only change through a recompute, so an all-safe tick
  is provably a fixpoint).  ``reassoc="full"`` forces the legacy
  every-tick ``[n, k]`` recompute — both modes are pinned bitwise
  identical in ``tests/test_sim_clock.py``.

A copy of the JAX package's ``mobility/multicell.py`` (numpy only, draw for
draw): positions, association, handovers and distances match it bitwise.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.config import WirelessConfig
from repro_torch.core.bandwidth import UEChannel
from repro_torch.mobility.models import Area, MobilityModel, get_mobility
from repro_torch.obs import trace as obs
from repro_torch.wireless.channel import (CounterFadingMixin, make_channel,
                                    mean_rates_for, validate_rng_mode)

MIN_DIST_M = 5.0        # same floor as EdgeNetwork.drop
_MOB_STREAM = 0x6D6F62  # "mob" — decorrelates the auxiliary stream


def resolve_cell_bandwidth(spec, n_cells: int, default_hz: float
                           ) -> np.ndarray:
    """Per-cell uplink budgets [Hz] from a ``MobilityConfig.cell_bandwidth_hz``
    spec: ``()``/``None`` → every cell owns ``default_hz`` (legacy), one
    value → broadcast, else exactly one positive entry per cell."""
    if spec is None:
        spec = ()
    arr = np.asarray(spec, dtype=np.float64).reshape(-1)
    if arr.size == 0:
        arr = np.full(n_cells, float(default_hz))
    elif arr.size == 1:
        arr = np.full(n_cells, float(arr[0]))
    elif arr.size != n_cells:
        raise ValueError(f"cell_bandwidth_hz has {arr.size} entries for "
                         f"{n_cells} cells (want 0, 1, or {n_cells})")
    else:
        arr = arr.copy()
    if not np.all(arr > 0):
        raise ValueError(f"cell bandwidth budgets must be positive, got {arr}")
    return arr


def cell_layout(n_cells: int, radius_m: float) -> np.ndarray:
    """BS coordinates [n_cells, 2] on a hex-ish grid (col pitch √3·R, row
    pitch 1.5·R, odd rows offset half a column)."""
    if n_cells < 1:
        raise ValueError("need at least one cell")
    col_pitch = np.sqrt(3.0) * radius_m
    row_pitch = 1.5 * radius_m
    cols = int(np.ceil(np.sqrt(n_cells)))
    xy = np.empty((n_cells, 2))
    for k in range(n_cells):
        r, c = divmod(k, cols)
        xy[k, 0] = c * col_pitch + (0.5 * col_pitch if r % 2 else 0.0)
        xy[k, 1] = r * row_pitch
    return xy


@dataclass
class MultiCellNetwork(CounterFadingMixin):
    """Time-varying geometry: positions, nearest-BS association, handovers."""
    cfg: WirelessConfig
    n_ues: int
    bs_xy: np.ndarray                 # [n_cells, 2]
    positions: np.ndarray             # [n_ues, 2]
    cpu_freq: np.ndarray              # [n_ues] Hz
    rng: np.random.Generator          # main stream (fading)
    mob_rng: np.random.Generator      # auxiliary stream (geometry/mobility)
    mobility: MobilityModel
    area: Area
    assoc: np.ndarray                 # [n_ues] serving cell index
    _dist: np.ndarray                 # [n_ues] distance to serving BS [m]
    _mob_state: dict = field(default_factory=dict)
    time: float = 0.0                 # simulated seconds advanced so far
    handovers: int = 0                # lifetime handover count
    step_s: float = 1.0               # mobility integration step
    cell_bw: np.ndarray = None        # [n_cells] uplink budget per BS [Hz]
    association: str = "nearest"      # nearest | load_aware
    load_penalty_m: float = 50.0      # effective metres per unit rel. load
    reassoc: str = "safe_radius"      # safe_radius | full (exact reference)
    _ticks: int = 0                   # completed step_s grid ticks
    _anchor: np.ndarray = None        # [n, 2] position at last re-score
    _margin: np.ndarray = None        # [n] safe handover radius [m]
    _la_converged: bool = False       # load_aware best response at fixpoint
    # open-world scenario: which UEs currently exist.  ``None`` (default,
    # closed world) keeps every legacy code path untouched; when set,
    # membership queries and handover events see only active UEs —
    # positions/association still advance for everyone, so a dormant UE
    # re-joins wherever its trajectory carried it.
    active: np.ndarray = None         # [n_ues] bool, or None

    # ------------------------------------------------------------------
    @classmethod
    def drop(cls, cfg: WirelessConfig, n_ues: int, *, n_cells: int = 1,
             seed: int = 0, mobility: str = "static", speed_mps: float = 0.0,
             pause_s: float = 0.0, gm_alpha: float = 0.85,
             uniform_distance: bool = False, step_s: float = 1.0,
             cell_bandwidth_hz=None, association: str = "nearest",
             load_penalty_m: float = 50.0,
             reassoc: str = "safe_radius") -> "MultiCellNetwork":
        if step_s <= 0.0:
            raise ValueError(f"step_s must be positive, got {step_s}")
        validate_rng_mode(cfg.rng)
        if association not in ("nearest", "load_aware"):
            raise ValueError(f"unknown association policy {association!r}; "
                             f"known: ['load_aware', 'nearest']")
        if reassoc not in ("safe_radius", "full"):
            raise ValueError(f"unknown reassoc mode {reassoc!r}; "
                             f"known: ['full', 'safe_radius']")
        cell_bw = resolve_cell_bandwidth(cell_bandwidth_hz, n_cells,
                                         cfg.total_bandwidth_hz)
        rng = np.random.default_rng(seed)
        mob_rng = np.random.default_rng([seed, _MOB_STREAM])
        bs_xy = cell_layout(n_cells, cfg.cell_radius_m)
        r_cell = cfg.cell_radius_m
        area = Area(float(bs_xy[:, 0].min() - r_cell),
                    float(bs_xy[:, 1].min() - r_cell),
                    float(bs_xy[:, 0].max() + r_cell),
                    float(bs_xy[:, 1].max() + r_cell))

        if n_cells == 1:
            # main-stream consumption mirrors EdgeNetwork.drop exactly; the
            # polar angle comes from the auxiliary stream so fading draws
            # that follow are unperturbed
            if uniform_distance:
                radii = np.full(n_ues, r_cell / 2.0)
            else:
                radii = np.maximum(
                    r_cell * np.sqrt(rng.uniform(size=n_ues)), MIN_DIST_M)
            theta = mob_rng.uniform(0.0, 2.0 * np.pi, size=n_ues)
            positions = bs_xy[0] + radii[:, None] * np.stack(
                [np.cos(theta), np.sin(theta)], axis=1)
            dist0 = radii                  # exact (no norm round-trip)
            assoc = np.zeros(n_ues, dtype=np.int64)
        elif uniform_distance:
            # equal-η ablation in a multi-cell drop: ring of radius R/2
            # around an auxiliary-stream home cell
            home = mob_rng.integers(0, n_cells, size=n_ues)
            theta = mob_rng.uniform(0.0, 2.0 * np.pi, size=n_ues)
            positions = bs_xy[home] + (r_cell / 2.0) * np.stack(
                [np.cos(theta), np.sin(theta)], axis=1)
            assoc, dist0 = _run_association(positions, bs_xy, association,
                                            cell_bw, load_penalty_m)
        else:
            positions = area.uniform(mob_rng, n_ues)
            assoc, dist0 = _run_association(positions, bs_xy, association,
                                            cell_bw, load_penalty_m)

        ratio = max(cfg.cpu_hetero, 1.0)
        cpu = cfg.cpu_freq_hz * np.exp(
            rng.uniform(np.log(1.0 / ratio), 0.0, size=n_ues))

        model = get_mobility(mobility, speed_mps=speed_mps, pause_s=pause_s,
                             gm_alpha=gm_alpha)
        net = cls(cfg=cfg, n_ues=n_ues, bs_xy=bs_xy, positions=positions,
                  cpu_freq=cpu, rng=rng, mob_rng=mob_rng, mobility=model,
                  area=area, assoc=assoc, _dist=dist0, step_s=step_s,
                  cell_bw=cell_bw, association=association,
                  load_penalty_m=load_penalty_m, reassoc=reassoc)
        net._mob_state = model.init_state(n_ues, area, mob_rng)
        net._init_counter_fading(seed, n_ues)
        # safe-radius bookkeeping: zero margins force the first moving tick
        # to re-score everyone (and establish real margins); until a
        # load_aware best response is observed at a fixpoint its margins
        # cannot be trusted, so _la_converged starts False
        net._anchor = positions.copy()
        net._margin = np.zeros(n_ues)
        return net

    # ------------------------------------------------------------------
    # channel API (EdgeNetwork-compatible)
    # ------------------------------------------------------------------
    @property
    def n_cells(self) -> int:
        return len(self.bs_xy)

    @property
    def distances(self) -> np.ndarray:
        """Distance to the *serving* BS per UE [m]."""
        return self._dist

    def sample_fading(self) -> np.ndarray:
        """Rayleigh small-scale coefficients for one round (main stream —
        the same draw ``EdgeNetwork.sample_fading`` makes)."""
        return self.rng.rayleigh(scale=self.cfg.rayleigh_scale,
                                 size=self.n_ues)

    def sample_fading_batch(self, k: int) -> np.ndarray:
        """``k`` successive fading draws as one ``[k, n]`` main-stream RNG
        call — bitwise identical to the loop (see
        ``EdgeNetwork.sample_fading_batch``)."""
        return self.rng.rayleigh(scale=self.cfg.rayleigh_scale,
                                 size=(k, self.n_ues))

    def channel(self, ue: int, h: Optional[float] = None) -> UEChannel:
        hval = float(h) if h is not None else float(self.sample_fading()[ue])
        return make_channel(self.cfg, self._dist[ue], hval)

    def channels(self, h: Optional[np.ndarray] = None) -> list:
        h = h if h is not None else self.sample_fading()
        return [self.channel(i, h[i]) for i in range(self.n_ues)]

    def mean_rates(self, bandwidth_per_ue: Optional[float] = None
                   ) -> np.ndarray:
        """Expected uplink rate at equal-split bandwidth (policy input)."""
        return mean_rates_for(self.cfg, self._dist, bandwidth_per_ue)

    # ------------------------------------------------------------------
    # cells
    # ------------------------------------------------------------------
    def cell_members(self, c: int) -> np.ndarray:
        if self.active is None:
            return np.nonzero(self.assoc == c)[0]
        return np.nonzero((self.assoc == c) & self.active)[0]

    def cell_counts(self) -> np.ndarray:
        if self.active is None:
            return np.bincount(self.assoc, minlength=self.n_cells)
        return np.bincount(self.assoc[self.active],
                           minlength=self.n_cells)

    # ------------------------------------------------------------------
    # open-world scenario hooks
    # ------------------------------------------------------------------
    def set_active(self, ue: int, flag: bool) -> None:
        """Flip one UE's existence bit (lazily materialises the mask)."""
        if self.active is None:
            self.active = np.ones(self.n_ues, dtype=bool)
        self.active[ue] = flag

    def retarget_waypoints(self, idx: np.ndarray, cell: int,
                           spread_m: float,
                           rng: np.random.Generator) -> int:
        """Flash crowd: point the random waypoints of ``idx`` at a spot
        near BS ``cell`` — their next legs converge on the hotspot.  Draws
        from the caller's ``rng`` (the scenario stream), never from
        ``mob_rng``, so the mobility draw schedule of every other UE is
        untouched.  No-op (returns 0) for mobility models without
        waypoint state."""
        wp = self._mob_state.get("waypoint")
        if wp is None or len(idx) == 0:
            return 0
        tgt = self.bs_xy[cell] + rng.normal(0.0, spread_m,
                                            size=(len(idx), 2))
        np.clip(tgt[:, 0], self.area.xmin, self.area.xmax, out=tgt[:, 0])
        np.clip(tgt[:, 1], self.area.ymin, self.area.ymax, out=tgt[:, 1])
        wp[idx] = tgt
        return len(idx)

    # ------------------------------------------------------------------
    # time
    # ------------------------------------------------------------------
    def advance_to(self, t: float) -> List[Tuple[int, int, int]]:
        """Advance the simulation clock to ``t``; integrate any newly
        completed ``step_s`` grid ticks, refresh association, and return
        the handover events ``[(ue, src, dst), ...]`` this advance caused.

        Static mobility (or a zero/negative time step) is a pure clock
        update — positions, distances and association stay exactly as
        dropped, which is what keeps the degenerate configuration bitwise
        identical to the legacy single-cell path.  So is any advance that
        completes no new grid tick — the O(1)-amortized common case when
        the event loop calls this once per heap pop.
        """
        if t <= self.time or self.mobility.is_static:
            self.time = max(self.time, t)
            return []
        self.time = t
        target = int(math.floor(t / self.step_s + 1e-9))
        if target <= self._ticks:
            return []
        # tracing lives only in this (rare) tick branch — the per-heap-pop
        # no-new-tick calls above stay free of instrumentation
        tr = obs.CURRENT
        tr.add("mobility.ticks", target - self._ticks)
        with tr.span("mobility"):
            self.positions, self._mob_state = self.mobility.step_many(
                self.positions, self._mob_state, target - self._ticks,
                self.step_s, self.area, self.mob_rng)
        self._ticks = target
        with tr.span("reassociate"):
            new_assoc = self._reassociate()
        moved = np.nonzero(new_assoc != self.assoc)[0]
        if self.active is not None:
            # dormant UEs keep moving and re-associating silently — no
            # handover events (they are nobody's member) and no count;
            # a later join simply finds them in their current cell
            moved = moved[self.active[moved]]
        events = [(int(u), int(self.assoc[u]), int(new_assoc[u]))
                  for u in moved]
        self.handovers += len(events)
        if events:
            tr.add("mobility.handovers", len(events))
        self.assoc = new_assoc
        return events

    # ------------------------------------------------------------------
    # association refresh (safe-radius incremental, or full reference)
    # ------------------------------------------------------------------
    def _serving_dist(self, assoc: np.ndarray) -> np.ndarray:
        """Serving-BS distance per UE from current positions — the same
        x² + y² → sqrt arithmetic as selecting the serving column of the
        full ``[n, k]`` matrix, so the values are bitwise identical."""
        return np.maximum(
            np.sqrt(((self.positions - self.bs_xy[assoc]) ** 2).sum(-1)),
            MIN_DIST_M)

    def _reassociate(self) -> np.ndarray:
        if self.reassoc == "full":
            new_assoc, self._dist = _run_association(
                self.positions, self.bs_xy, self.association, self.cell_bw,
                self.load_penalty_m, assoc0=self.assoc)
            return new_assoc
        if self.association == "nearest":
            return self._reassoc_nearest()
        return self._reassoc_load_aware()

    def _reassoc_nearest(self) -> np.ndarray:
        """Exact incremental nearest-BS: only UEs displaced past their
        safe radius since their last score can have changed argmin (by the
        triangle inequality: every other BS is still ≥ 2·margin − 2·disp
        farther), so only those rows are re-scored against the BS list."""
        pos, bs = self.positions, self.bs_xy
        new_assoc = self.assoc
        if self.n_cells > 1:
            disp_sq = ((pos - self._anchor) ** 2).sum(-1)
            cand = np.nonzero(disp_sq >= self._margin * self._margin)[0]
            if len(cand):
                obs.CURRENT.add("mobility.rescored", len(cand))
                d2 = ((pos[cand, None, :] - bs[None, :, :]) ** 2).sum(-1)
                new_assoc = self.assoc.copy()
                new_assoc[cand] = d2.argmin(axis=1).astype(np.int64)
                two = np.partition(np.sqrt(d2), 1, axis=1)
                self._margin[cand] = (two[:, 1] - two[:, 0]) / 2.0
                self._anchor[cand] = pos[cand]
        # serving distance tracks every tick (it prices upload times)
        self._dist = self._serving_dist(new_assoc)
        return new_assoc

    def _reassoc_load_aware(self) -> np.ndarray:
        """Safe-radius-gated load-aware refresh.  Margins are half the
        effective-cost gap to the runner-up cell at the last best-response
        fixpoint.  While no UE has moved past its margin, loads are
        unchanged (they only change through a recompute) and each UE's own
        column drifted by < margin, so every UE is still at its strict
        argmin — the full best response would move nobody — and the
        ``[n, k]`` recompute is skipped.  Any breach (or a non-converged
        previous pass, whose margins are meaningless) runs the full
        recompute and re-anchors everyone."""
        pos = self.positions
        if self._la_converged:
            disp_sq = ((pos - self._anchor) ** 2).sum(-1)
            if not np.any(disp_sq >= self._margin * self._margin):
                obs.CURRENT.add("mobility.load_aware_skips")
                self._dist = self._serving_dist(self.assoc)
                return self.assoc
        obs.CURRENT.add("mobility.load_aware_recomputes")
        info: dict = {}
        new_assoc, self._dist = _associate_load_aware(
            pos, self.bs_xy, self.cell_bw, self.load_penalty_m,
            assoc0=self.assoc, info=info)
        self._margin = info["margin"]
        self._la_converged = bool(info["converged"])
        self._anchor = pos.copy()
        return new_assoc


def _associate(positions: np.ndarray, bs_xy: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Nearest-BS association: [n] cell ids + [n] serving distances."""
    d2 = ((positions[:, None, :] - bs_xy[None, :, :]) ** 2).sum(-1)
    assoc = d2.argmin(axis=1).astype(np.int64)
    dist = np.maximum(np.sqrt(d2[np.arange(len(positions)), assoc]),
                      MIN_DIST_M)
    return assoc, dist


def _associate_load_aware(positions: np.ndarray, bs_xy: np.ndarray,
                          cell_bw: np.ndarray, penalty_m: float,
                          assoc0: Optional[np.ndarray] = None,
                          passes: int = 2,
                          info: Optional[dict] = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Load-aware association: best response on the effective distance
    ``d(u, c) + penalty_m · members_c / fair_c`` with the fair share
    ``fair_c = n · cell_bw_c / Σ cell_bw`` proportional to the cell's
    bandwidth budget — hot (or skinny-budget) cells price themselves up
    and shed UEs.

    Two details make the dynamics well-behaved:

    * **strict improvement with self-exclusion** — a UE evaluating its own
      cell excludes itself from that cell's load, and only moves when the
      alternative is *strictly* cheaper (hysteresis: an unchanged geometry
      re-associates to exactly the same assignment, so a lazy re-run never
      manufactures handovers);
    * **chunked updates** — simultaneous best response oscillates (every
      member of a hot cell sees the same cheaper neighbour and the whole
      cell migrates en masse, then back).  Re-deciding in index chunks of
      ``~n/4k`` with load counts refreshed between chunks keeps the
      overshoot bounded by one chunk while staying vectorized; for small n
      the chunk is a single UE, i.e. exact sequential best response.

    Deterministic (fixed UE order, no RNG), starts from the previous
    association (or nearest-BS on a fresh drop), and runs a fixed number
    of ``passes`` over the population.

    When ``info`` is supplied it is filled with the safe-radius gating
    state: ``info["converged"]`` — whether a full pass observed no moves
    (the assignment is a best-response fixpoint), and ``info["margin"]``
    — per-UE half effective-cost gap to the runner-up cell, i.e. how far
    a UE may drift before its strict argmin could change while loads stay
    frozen.
    """
    n, k = len(positions), len(bs_xy)
    d = np.sqrt(((positions[:, None, :] - bs_xy[None, :, :]) ** 2).sum(-1))
    fair = n * cell_bw / cell_bw.sum()          # expected members per cell
    unit = penalty_m / np.maximum(fair, 1e-12)  # metres per member, per cell
    assoc = (d.argmin(axis=1).astype(np.int64) if assoc0 is None
             else np.asarray(assoc0, dtype=np.int64).copy())
    counts = np.bincount(assoc, minlength=k).astype(np.float64)
    chunk = max(1, n // (4 * k))
    converged = False
    for _ in range(passes):
        moved = 0
        for start in range(0, n, chunk):
            rows = np.arange(start, min(start + chunk, n))
            cur = assoc[rows]
            cost = d[rows] + unit[None, :] * counts[None, :]
            cost[np.arange(len(rows)), cur] -= unit[cur]   # exclude self
            best = cost.argmin(axis=1).astype(np.int64)
            better = cost[np.arange(len(rows)), best] \
                < cost[np.arange(len(rows)), cur]
            new = np.where(better, best, cur)
            if np.any(new != cur):
                counts += np.bincount(new, minlength=k) \
                    - np.bincount(cur, minlength=k)
                assoc[rows] = new
                moved += int((new != cur).sum())
        if moved == 0:
            converged = True
            break
    dist = np.maximum(d[np.arange(n), assoc], MIN_DIST_M)
    if info is not None:
        rows = np.arange(n)
        cost = d + unit[None, :] * counts[None, :]
        cost[rows, assoc] -= unit[assoc]                   # exclude self
        own = cost[rows, assoc].copy()
        cost[rows, assoc] = np.inf
        alt = cost.min(axis=1)          # k == 1 → inf → infinite margin
        info["margin"] = np.maximum((alt - own) / 2.0, 0.0)
        info["converged"] = converged
    return assoc, dist


def _run_association(positions: np.ndarray, bs_xy: np.ndarray,
                     association: str, cell_bw: np.ndarray, penalty_m: float,
                     assoc0: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Dispatch on the association policy (``nearest`` stays the exact
    legacy code path, bit for bit)."""
    if association == "nearest":
        return _associate(positions, bs_xy)
    return _associate_load_aware(positions, bs_xy, cell_bw, penalty_m,
                                 assoc0=assoc0)
