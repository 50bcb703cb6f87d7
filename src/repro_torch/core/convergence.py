"""Convergence theory — Sec. IV (Theorem 1, Corollary 1, Lemmas 1–3).

These are the analytic expressions the scheduler consumes (A*, K* come from
this bound via Eq. 42/43) and that the tests/benchmarks validate empirically.

A copy of the JAX package's ``core/convergence.py`` (float math, no draws).
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class SmoothnessParams:
    """Problem constants of Assumptions 2–5."""
    L: float = 1.0          # gradient Lipschitz constant of f_i
    C: float = 1.0          # gradient bound ‖∇f_i‖ ≤ C
    rho: float = 1.0        # Hessian Lipschitz constant
    sigma_G: float = 1.0    # per-sample gradient variance
    sigma_H: float = 1.0    # per-sample Hessian variance
    gamma_G: float = 1.0    # inter-client gradient diversity
    gamma_H: float = 1.0    # inter-client Hessian diversity


def smoothness_F(p: SmoothnessParams, alpha: float) -> float:
    """Lemma 1: L_F = 4L + α·ρ·C."""
    return 4.0 * p.L + alpha * p.rho * p.C


def sigma_F2(p: SmoothnessParams, alpha: float, d_in: int, d_o: int,
             d_h: int) -> float:
    """Lemma 2 (Eq. 24): variance of the stochastic meta-gradient."""
    t1 = p.C ** 2 + p.sigma_G ** 2 * (1.0 / d_o + (alpha * p.L) ** 2 / d_in)
    t2 = 1.0 + p.sigma_H ** 2 * alpha ** 2 / (4.0 * d_h)
    return 12.0 * t1 * t2 - 12.0 * p.C ** 2


def gamma_F2(p: SmoothnessParams, alpha: float) -> float:
    """Lemma 3 (Eq. 26): γ_F² = 3 C² α² γ_H² + 192 γ_G²."""
    return 3.0 * p.C ** 2 * alpha ** 2 * p.gamma_H ** 2 + 192.0 * p.gamma_G ** 2


def step_condition(l_f: float, beta: float, s: int) -> float:
    """Theorem 1 prerequisite (Eq. 27): L_F β² − β + 2 L_F² β² S² ≤ 1.

    Returns the LHS; callers check ``step_condition(...) <= 1``.
    """
    return l_f * beta ** 2 - beta + 2.0 * l_f ** 2 * beta ** 2 * s ** 2


def max_feasible_beta(l_f: float, s: int) -> float:
    """Largest β satisfying Eq. (27) (quadratic in β, positive root)."""
    a = l_f + 2.0 * l_f ** 2 * s ** 2
    # a β² − β − 1 ≤ 0  →  β ≤ (1 + sqrt(1 + 4a)) / (2a)
    return (1.0 + math.sqrt(1.0 + 4.0 * a)) / (2.0 * a)


def fosp_bound(*, loss_gap: float, beta: float, k: int, a: int, s: int,
               l_f: float, sig_f2: float, gam_f2: float) -> float:
    """Theorem 1 (Eq. 28): upper bound on (1/K) Σ E‖∇F(w_k)‖².

        2(F(w₀)−F(w*)) / (βK) + 4(L_F β + 2 L_F² β² S²)(σ_F²+γ_F²)·√A
    """
    t1 = 2.0 * loss_gap / (beta * k)
    t2 = 4.0 * (l_f * beta + 2.0 * l_f ** 2 * beta ** 2 * s ** 2) \
        * (sig_f2 + gam_f2) * math.sqrt(a)
    return t1 + t2


def corollary1_rates(epsilon: float) -> dict:
    """Corollary 1 parameter scalings for an ε-FOSP."""
    return {
        "K": epsilon ** -3,
        "beta": epsilon ** 2,
        "S": epsilon ** -1,
        "A": epsilon ** -2,
    }
