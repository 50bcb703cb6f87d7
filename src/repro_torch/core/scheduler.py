"""UE scheduling — Sec. V-C of the paper.

* ``relative_frequencies`` — η_i (Eq. 15) from equal or distance-derived rates.
* ``estimate_A_K``        — Eq. (42)/(43): A*, K* from the convergence bound.
* ``greedy_schedule``     — Algorithm 2: greedy construction of the periodic
                            participation matrix Π with Σ_i π_k^i = A (Eq. 14).
* ``SchedulingPolicy``    — small protocol bundling "how η is derived" with
                            "how Π is planned", so equal/rates/distance
                            policies compose with sync/semi/async server
                            modes instead of living as if-chains in the
                            simulator and benchmarks (``get_policy``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Protocol, Tuple, runtime_checkable

import numpy as np

from repro_torch.config import FLConfig


def relative_frequencies(n: int, mode: str = "equal", *,
                         distances: Optional[np.ndarray] = None,
                         rates: Optional[np.ndarray] = None,
                         kappa: float = 3.8) -> np.ndarray:
    """η vector (sums to 1).

    ``equal``    — η_i = 1/n.
    ``distance`` — η_i ∝ achievable rate ∝ log(1 + d^-κ·const): farther UEs
                   upload slower and naturally participate less (Sec. VI-A-4).
    ``rates``    — proportional to externally supplied average rates.
    """
    if mode == "equal":
        eta = np.ones(n)
    elif mode == "distance":
        assert distances is not None
        snr = np.power(np.maximum(distances, 1.0), -kappa) * 1e9
        eta = np.log1p(snr)
    elif mode == "rates":
        assert rates is not None
        eta = np.asarray(rates, dtype=float)
    else:
        raise ValueError(f"unknown eta mode {mode!r}")
    eta = np.maximum(eta, 1e-9)
    return eta / eta.sum()


def estimate_A_K(fl: FLConfig, *, eta: np.ndarray, epsilon: float,
                 L_F: float, sigma_F2: float, gamma_F2: float,
                 loss_gap: float = 1.0) -> Tuple[int, int]:
    """Optimal participants A* (Eq. 43) and rounds K* (Eq. 42).

    K* ≈ min_i { 2(F(w0)−F(w*)) / (β ε),  S/η_i }
    A* ≈ min_i { ε² / (16 (L_F β + 2 L_F² β² S²)² (σ_F²+γ_F²)²),  1/(η_i S) }
    """
    beta, s = fl.beta, fl.staleness_bound
    k_theory = 2.0 * loss_gap / (beta * epsilon)
    k_eta = (s / eta).max()                       # K ≥ S/η_i for all i (C1.5)
    k_star = max(1, int(np.ceil(min(k_theory, k_eta))))

    denom = 16.0 * (L_F * beta + 2.0 * L_F ** 2 * beta ** 2 * s ** 2) ** 2 \
        * (sigma_F2 + gamma_F2) ** 2
    a_theory = epsilon ** 2 / max(denom, 1e-30)
    a_eta = (1.0 / (eta * s)).min()               # A ≥ 1/(η_i S) (C4.2)
    a_star = max(1, int(np.ceil(min(a_theory, a_eta))))
    return min(a_star, len(eta)), k_star


def greedy_schedule(eta: np.ndarray, A: int, K: int) -> np.ndarray:
    """Algorithm 2 — greedy Π construction.

    Each round, pick the A UEs whose *current* relative participation
    frequency η̂_i lags its target η_i the most (the paper's "poorest first"
    greedy); ties go to lower index, matching the paper's "schedule the first
    A − |picked| UEs" fallback.  Returns Π as an int matrix [K, n].
    """
    n = len(eta)
    assert 1 <= A <= n
    pi = np.zeros((K, n), dtype=np.int64)
    counts = np.zeros(n, dtype=np.int64)
    total = 0
    for k in range(K):
        if total == 0:
            eta_hat = np.zeros(n)
        else:
            eta_hat = counts / total
        deficit = eta - eta_hat
        # candidates whose η̂ has not yet reached target, poorest first
        order = np.argsort(-deficit, kind="stable")
        chosen = [i for i in order if eta_hat[i] <= eta[i]][:A]
        if len(chosen) < A:
            # Alg. 2 line 11-13: fill with the first unchosen UEs
            rest = [i for i in range(n) if i not in chosen]
            chosen += rest[:A - len(chosen)]
        pi[k, chosen] = 1
        counts[chosen] += 1
        total += A
    return pi


def schedule_staleness(pi: np.ndarray) -> np.ndarray:
    """Per-(round, UE) staleness implied by Π: rounds since last participation
    start.  τ_k^i = k − (last round ≤ k where UE i was scheduled)."""
    k_rounds, n = pi.shape
    tau = np.zeros_like(pi)
    last = -np.ones(n, dtype=np.int64)
    for k in range(k_rounds):
        for i in range(n):
            tau[k, i] = k - last[i] - 1 if last[i] >= 0 else k
        last[pi[k] == 1] = k
    return tau


# ---------------------------------------------------------------------------
# Scheduling policies — composable with sync / semi / async server modes
# ---------------------------------------------------------------------------

@runtime_checkable
class SchedulingPolicy(Protocol):
    """How participation targets are derived and planned.

    ``frequencies``  — the η vector (Eq. 15) for a concrete network drop.
    ``plan``         — a Π matrix hitting those targets (Alg. 2 by default).
    ``uniform_drop`` — whether the UE drop should be distance-uniform (the
                       paper's equal-η ablation removes geometry entirely).
    """

    uniform_drop: bool

    def frequencies(self, n: int, net=None) -> np.ndarray: ...

    def plan(self, eta: np.ndarray, A: int, K: int) -> np.ndarray: ...


@dataclass(frozen=True)
class _GreedyPlanMixin:
    """Default Π planner: the paper's Algorithm 2 greedy construction."""

    def plan(self, eta: np.ndarray, A: int, K: int) -> np.ndarray:
        return greedy_schedule(eta, A, K)


@dataclass(frozen=True)
class EqualPolicy(_GreedyPlanMixin):
    """η_i = 1/n; pairs with a distance-uniform drop (Sec. VI-A equal-η)."""

    uniform_drop: bool = True

    def frequencies(self, n: int, net=None) -> np.ndarray:
        return relative_frequencies(n, "equal")


@dataclass(frozen=True)
class RatesPolicy(_GreedyPlanMixin):
    """η_i ∝ mean achievable uplink rate of the drop (Sec. VI-A-4: farther,
    slower UEs naturally participate less)."""

    uniform_drop: bool = False

    def frequencies(self, n: int, net=None) -> np.ndarray:
        if net is None:
            return relative_frequencies(n, "equal")
        return relative_frequencies(n, "rates", rates=net.mean_rates())


@dataclass(frozen=True)
class DistancePolicy(_GreedyPlanMixin):
    """η_i from the closed-form distance proxy (no channel model needed)."""

    uniform_drop: bool = False
    kappa: float = 3.8

    def frequencies(self, n: int, net=None) -> np.ndarray:
        if net is None:
            return relative_frequencies(n, "equal")
        return relative_frequencies(n, "distance", distances=net.distances,
                                    kappa=self.kappa)


# ``distance`` maps to RatesPolicy on purpose: the simulator's historical
# eta_mode="distance" derives η from the mean rates of a distance-dependent
# drop (that IS the paper's Sec. VI-A-4 recipe); the pure closed-form proxy
# stays available as "distance-proxy".
_POLICIES = {
    "equal": EqualPolicy,
    "rates": RatesPolicy,
    "distance": RatesPolicy,
    "distance-proxy": DistancePolicy,
}


def get_policy(name: str) -> SchedulingPolicy:
    """Resolve an ``fl.eta_mode`` string to a SchedulingPolicy instance."""
    try:
        return _POLICIES[name]()
    except KeyError:
        raise ValueError(f"unknown scheduling policy {name!r}; "
                         f"known: {sorted(_POLICIES)}") from None


def schedule_period(pi: np.ndarray) -> int:
    """Detect the recurrence period K_p of a schedule (Theorem 3)."""
    k_rounds = pi.shape[0]
    for p in range(1, k_rounds // 2 + 1):
        if k_rounds % p == 0 and np.array_equal(pi[:-p], pi[p:]):
            return p
    return k_rounds
