"""Vectorized UE mobility models.

All models advance an ``[n, 2]`` position array with pure array math — no
Python per-UE loops — so a 10k-UE network costs the same handful of numpy
ops as a 10-UE one.  The canonical entry point is ``step_many``: advance
``ticks`` integration steps of ``dt`` simulated seconds each, drawing all
the randomness those ticks need as ONE batched ``[ticks, n, D]``-shaped RNG
call up front (``step`` is the ``ticks=1`` special case).

Draw-schedule discipline: every tick consumes exactly one contiguous block
of ``n·D`` variates from the caller's generator, in tick order.  Because
numpy Generators fill arrays from the bitstream sequentially regardless of
shape, ``step_many(ticks=T)`` is **bitwise identical** to ``T`` successive
``step`` calls — the trajectory depends only on *which grid ticks elapsed*,
never on how the caller grouped them into ``advance_to`` calls (pinned by
``tests/test_sim_clock.py``).  Draws are applied with ``np.where`` masks,
so the count never depends on which UEs happened to arrive at a waypoint.

* ``StaticMobility``     — positions never move (the original single-cell
                           drop); draws nothing.
* ``RandomWaypoint``     — each UE walks toward a uniformly-drawn waypoint
                           at a per-leg speed ``U[0.5, 1.5]·v̄``, pauses
                           ``pause_s``, redraws.
* ``GaussMarkov``        — speed/heading follow an AR(1) around per-UE
                           means; reflects (position and heading) at the
                           area boundary.

``get_mobility`` resolves a config string; any model at ``speed_mps ≤ 0``
collapses to ``StaticMobility``.

A copy of the JAX package's ``mobility/models.py``, draw for draw, so
trajectories match it bitwise.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

State = Dict[str, np.ndarray]

# max doubles one batched step_many draw may materialise (~32 MB); a long
# inter-event gap at 16k UEs would otherwise allocate GBs in one RNG call.
# Blocks are bitwise the single big draw (sequential bitstream).
MAX_DRAW_DOUBLES = 1 << 22


def _tick_draws(ticks: int, n: int, d: int, draw):
    """Yield one ``[n, d]`` random slab per tick, drawn in blocks of at
    most ``MAX_DRAW_DOUBLES`` doubles via ``draw(size=...)``.  numpy
    Generators consume the bitstream sequentially regardless of shape, so
    the slabs are bitwise one unbounded ``[ticks, n, d]`` call — and
    bitwise per-tick ``[1, n, d]`` calls (the schedule-independence
    invariant) — without the unbounded allocation."""
    block = max(1, MAX_DRAW_DOUBLES // max(d * n, 1))
    for start in range(0, ticks, block):
        yield from draw(size=(min(block, ticks - start), n, d))


@dataclass(frozen=True)
class Area:
    """Axis-aligned rectangle the UEs roam in."""
    xmin: float
    ymin: float
    xmax: float
    ymax: float

    @property
    def lo(self) -> np.ndarray:
        return np.array([self.xmin, self.ymin])

    @property
    def hi(self) -> np.ndarray:
        return np.array([self.xmax, self.ymax])

    def uniform(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return rng.uniform(self.lo, self.hi, size=(n, 2))

    def contains(self, pos: np.ndarray, tol: float = 1e-6) -> np.ndarray:
        return ((pos >= self.lo - tol) & (pos <= self.hi + tol)).all(axis=-1)


class MobilityModel:
    """Protocol: ``init_state`` once per drop, ``step_many`` per advance."""

    def init_state(self, n: int, area: Area,
                   rng: np.random.Generator) -> State:
        return {}

    def step(self, pos: np.ndarray, state: State, dt: float, area: Area,
             rng: np.random.Generator) -> Tuple[np.ndarray, State]:
        """One tick — the ``ticks=1`` case of ``step_many``."""
        return self.step_many(pos, state, 1, dt, area, rng)

    def step_many(self, pos: np.ndarray, state: State, ticks: int,
                  dt: float, area: Area, rng: np.random.Generator
                  ) -> Tuple[np.ndarray, State]:
        raise NotImplementedError

    @property
    def is_static(self) -> bool:
        return False


class StaticMobility(MobilityModel):
    """No movement, no RNG consumption — the original frozen geometry."""

    def step_many(self, pos, state, ticks, dt, area, rng):
        return pos, state

    @property
    def is_static(self) -> bool:
        return True


@dataclass(frozen=True)
class RandomWaypoint(MobilityModel):
    """Classic RWP: walk → (optional pause) → new waypoint, vectorized.

    Per tick: one contiguous ``[n, 3]`` uniform block — waypoint x/y and
    the replacement leg speed (used only on lanes that arrive this tick).
    """

    speed_mps: float
    pause_s: float = 0.0

    def _leg_speed(self, u: np.ndarray) -> np.ndarray:
        """Per-leg speed from a pre-drawn U[0, 1) block: U[0.5, 1.5]·v̄."""
        return self.speed_mps * (0.5 + u)

    def _draw_speed(self, rng: np.random.Generator, n: int) -> np.ndarray:
        return self._leg_speed(rng.random(size=n))

    def init_state(self, n: int, area: Area,
                   rng: np.random.Generator) -> State:
        return {"waypoint": area.uniform(rng, n),
                "speed": self._draw_speed(rng, n),
                "pause": np.zeros(n)}

    def step_many(self, pos, state, ticks, dt, area, rng):
        lo, span = area.lo, area.hi - area.lo
        waypoint, speed, pause = (state["waypoint"], state["speed"],
                                  state["pause"])
        for u in _tick_draws(ticks, len(pos), 3, rng.random):
            new_wp = lo + u[:, :2] * span
            new_speed = self._leg_speed(u[:, 2])

            moving = pause <= 0.0
            vec = waypoint - pos
            dist = np.linalg.norm(vec, axis=1)
            step_len = speed * dt
            arrive = moving & (dist <= step_len)
            # unit direction, safe where dist == 0
            unit = vec / np.maximum(dist, 1e-12)[:, None]
            walked = pos + unit * np.minimum(step_len, dist)[:, None]
            pos = np.where((moving & ~arrive)[:, None], walked, pos)
            pos = np.where(arrive[:, None], waypoint, pos)

            waypoint = np.where(arrive[:, None], new_wp, waypoint)
            speed = np.where(arrive, new_speed, speed)
            pause = np.where(arrive, self.pause_s, np.maximum(pause - dt, 0.0))
        return pos, {"waypoint": waypoint, "speed": speed, "pause": pause}


@dataclass(frozen=True)
class GaussMarkov(MobilityModel):
    """AR(1) speed/heading (Camp et al.): s ← αs + (1−α)s̄ + √(1−α²)·σ·w.

    Per tick: one contiguous ``[n, 2]`` standard-normal block (speed and
    heading innovations).
    """

    speed_mps: float
    alpha: float = 0.85
    speed_std_frac: float = 0.25     # σ_s = frac · s̄
    heading_std: float = 0.5         # σ_θ [rad]

    def init_state(self, n: int, area: Area,
                   rng: np.random.Generator) -> State:
        theta = rng.uniform(0.0, 2.0 * np.pi, size=n)
        return {"speed": np.full(n, self.speed_mps),
                "theta": theta.copy(),
                "mean_theta": theta}

    def step_many(self, pos, state, ticks, dt, area, rng):
        a = self.alpha
        noise = np.sqrt(max(1.0 - a * a, 0.0))
        speed, theta = state["speed"], state["theta"]
        mean_theta = state["mean_theta"]
        lo, hi = area.lo, area.hi
        for w in _tick_draws(ticks, len(pos), 2, rng.standard_normal):
            speed = (a * speed + (1.0 - a) * self.speed_mps
                     + noise * self.speed_std_frac * self.speed_mps
                     * w[:, 0])
            speed = np.maximum(speed, 0.0)
            theta = (a * theta + (1.0 - a) * mean_theta
                     + noise * self.heading_std * w[:, 1])

            pos = pos + dt * speed[:, None] * np.stack(
                [np.cos(theta), np.sin(theta)], axis=1)
            # reflect at the boundary (position and heading)
            under, over = pos < lo, pos > hi
            pos = np.where(under, 2.0 * lo - pos, pos)
            pos = np.where(over, 2.0 * hi - pos, pos)
            pos = np.clip(pos, lo, hi)           # guard: step longer than area
            flip_x = under[:, 0] | over[:, 0]
            flip_y = under[:, 1] | over[:, 1]
            theta = np.where(flip_x, np.pi - theta, theta)
            theta = np.where(flip_y, -theta, theta)
        return pos, {"speed": speed, "theta": theta,
                     "mean_theta": mean_theta}


def get_mobility(name: str, *, speed_mps: float, pause_s: float = 0.0,
                 gm_alpha: float = 0.85) -> MobilityModel:
    """Resolve a ``MobilityConfig.model`` string to a model instance."""
    if speed_mps <= 0.0 or name == "static":
        return StaticMobility()
    if name == "random_waypoint":
        return RandomWaypoint(speed_mps=speed_mps, pause_s=pause_s)
    if name in ("gauss_markov", "gauss-markov"):
        return GaussMarkov(speed_mps=speed_mps, alpha=gm_alpha)
    raise ValueError(f"unknown mobility model {name!r}; "
                     f"known: static, random_waypoint, gauss_markov")
