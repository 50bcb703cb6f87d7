"""Optimal bandwidth allocation — Sec. V-B (Theorems 2–4) of the paper.

Core facts implemented here:

* Theorem 2: within a round, the round time is minimised iff all scheduled
  UEs finish simultaneously (uplink rate is monotone in bandwidth, so any
  slack is re-assignable to the slowest UE).
* Theorem 4: the per-UE bandwidth that hits a finish time ``t`` has the
  closed form  b = −q·Γ / (W₋₁(−Γ e^{−Γ}) + Γ),  Γ = Z·N₀ /((t−Tcmp)·p·h·d^{−κ}),
  with W the Lambert-W function; any allocation between the two extreme
  policies (only-A_k vs all-UE weighted-equal-rate) attains the same optimum.

Everything is host-side numpy (the allocator runs in the round loop of the
simulator, not inside jit).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import numpy as np

from repro_torch.obs import trace as obs


# ---------------------------------------------------------------------------
# Lambert W (principal and -1 branches) via Halley iteration
# ---------------------------------------------------------------------------

def lambertw(x: np.ndarray, branch: int = 0, iters: int = 64) -> np.ndarray:
    """Lambert W: solves w·e^w = x. Supports branch 0 (x ≥ −1/e) and −1
    (−1/e ≤ x < 0). Vectorised, float64."""
    x = np.asarray(x, dtype=np.float64)
    if branch == 0:
        # start: series for small |x|, log asymptote for large x
        w = np.where(x >= 1.0,
                     np.log(np.maximum(x, 1e-300)),
                     x / (1.0 + np.maximum(x, -0.99)))
    elif branch == -1:
        # valid for x in [-1/e, 0)
        lx = np.log(np.maximum(-x, 1e-300))
        w = lx - np.log(np.maximum(-lx, 1e-12))
        w = np.where(x > -0.1, lx - np.log(-lx), w)
        w = np.minimum(w, -1.0)
    else:
        raise ValueError("branch must be 0 or -1")
    for _ in range(iters):
        ew = np.exp(np.clip(w, -700, 700))
        f = w * ew - x
        wp1 = w + 1.0
        denom = ew * wp1 - (w + 2.0) * f / (2.0 * wp1 + 1e-300)
        step = f / np.where(np.abs(denom) < 1e-300, 1e-300, denom)
        w = w - step
        if branch == -1:
            w = np.minimum(w, -1.0 + 1e-12)
    return w


# ---------------------------------------------------------------------------
# Rate model (Eq. 9-10)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class UEChannel:
    """Per-UE channel snapshot in a round."""
    p: float           # transmit power [W]
    h: float           # small-scale fading coefficient (Rayleigh sample)
    dist: float        # distance to BS [m]
    kappa: float       # path loss exponent
    n0: float          # noise PSD [W/Hz]

    @property
    def q(self) -> float:
        """q ≡ p·h·d^{−κ} / N₀ — SNR numerator per Hz (units of Hz·SNR)."""
        return self.p * self.h * self.dist ** (-self.kappa) / self.n0


def uplink_rate(b: np.ndarray, ch: UEChannel) -> np.ndarray:
    """r = b · ln(1 + q / b) [nats/s]  (Eq. 9)."""
    b = np.asarray(b, dtype=np.float64)
    return b * np.log1p(ch.q / np.maximum(b, 1e-12))


def bandwidth_for_rate(rate: float, ch: UEChannel) -> float:
    """Invert Eq. 9: the bandwidth b with r(b) = rate (Theorem 4 closed form).

    With c ≡ rate/q:  b = −q·c / (W₋₁(−c·e^{−c}) + c).  Requires c < 1
    (rate below the b→∞ limit r→q); returns +inf if unattainable.
    """
    q = ch.q
    c = rate / q
    if c >= 1.0:
        return float("inf")
    if c <= 0.0:
        return 0.0
    w = float(lambertw(np.asarray(-c * np.exp(-c)), branch=-1))
    u = -w / c - 1.0          # u = q/b > 0
    if u <= 0:
        return float("inf")
    return q / u


def bandwidth_for_time(z_bits: float, t: float, tcmp: float, ch: UEChannel,
                       bits_per_nat: float = 1.0 / np.log(2.0)) -> float:
    """Bandwidth so UE finishes compute+upload of Z bits in exactly t seconds
    (Γ of Theorem 4 = Z·N₀/((t−Tcmp)·p·h·d^{−κ}) = required_rate / q)."""
    t_com = t - tcmp
    if t_com <= 0:
        return float("inf")
    rate_nats = z_bits / bits_per_nat / t_com      # required nats/s
    return bandwidth_for_rate(rate_nats, ch)


def bandwidths_for_time(z_bits: np.ndarray, t: float, tcmp: np.ndarray,
                        q: np.ndarray,
                        bits_per_nat: float = 1.0 / np.log(2.0)
                        ) -> np.ndarray:
    """Vectorized ``bandwidth_for_time`` over the UEs of one round, with
    ``q = p·h·d^{−κ}/N₀`` per UE precomputed (``UEChannel.q``).

    Every lane is **bitwise identical** to the scalar form: the expression
    applies the same float64 ufunc chain elementwise (numpy's f64 loops call
    the same libm routines the scalar path does — unlike ``pow``, see
    ``wireless.channel.pathloss_pow``), and the Lambert-W Halley iteration
    is already elementwise.  This is what makes the Theorem-2 bisection
    affordable inside the mobile loop's requeue at 1024 UEs
    (``tests/test_bandwidth_properties.py`` pins the equivalence).
    """
    z = np.asarray(z_bits, dtype=np.float64)
    tc = np.asarray(tcmp, dtype=np.float64)
    q = np.asarray(q, dtype=np.float64)
    t_com = t - tc
    out = np.full(len(q), np.inf)
    feas = t_com > 0
    if not np.any(feas):
        return out
    rate = (z[feas] / bits_per_nat) / t_com[feas]  # required nats/s
    c = rate / q[feas]
    b = np.full(len(rate), np.inf)
    b[c <= 0.0] = 0.0
    mid = (c > 0.0) & (c < 1.0)
    if np.any(mid):
        cm = c[mid]
        w = lambertw(-cm * np.exp(-cm), branch=-1)
        u = -w / cm - 1.0
        b[mid] = np.where(u > 0, q[feas][mid] / u, np.inf)
    out[feas] = b
    return out


# ---------------------------------------------------------------------------
# Theorem 2: equal-finish-time allocation within a round
# ---------------------------------------------------------------------------

class EqualFinishAllocation(NamedTuple):
    """Theorem-2 allocation result.

    ``converged`` is False when the bisection exhausted ``max_iter`` without
    reaching ``tol``, or when the final simplex rescale (Σb = B numerical
    guard) had to move the allocation materially — in either case the
    returned ``b`` no longer makes all UEs finish simultaneously at
    ``t_star``, and callers relying on the equal-finish property (Theorem 2)
    should widen ``max_iter``/``tol`` instead of trusting ``b`` blindly.
    The rescale used to happen silently, masking non-convergence.
    """
    b: np.ndarray
    t_star: float
    converged: bool


def equal_finish_allocation(z_bits: Sequence[float], tcmp: Sequence[float],
                            channels: Optional[Sequence[UEChannel]],
                            total_bw: float,
                            *, tol: float = 1e-9, max_iter: int = 200,
                            t_hint: Optional[float] = None,
                            q: Optional[np.ndarray] = None
                            ) -> EqualFinishAllocation:
    """Split ``total_bw`` among the scheduled UEs so all finish at the same
    time T* (Theorem 2).  Returns ``EqualFinishAllocation(b, t_star,
    converged)``.

    T ↦ Σ_i b_i(T) is strictly decreasing, so bisect on T.

    ``t_hint`` warm-starts the bracket from a previous round's ``t_star``
    (the mobile loop re-solves per cell on every membership change, and T*
    drifts slowly between requeues): a feasible hint becomes the upper
    bracket, an infeasible one the lower — either way the bisection starts
    tight instead of doubling up from ``max(tcmp)``.  ``t_hint=None`` keeps
    the cold-start bracket bit-for-bit.

    Callers that already hold the per-UE SNR numerators may pass ``q``
    (= ``UEChannel.q`` per UE, same scalar-pow path-loss convention) and
    ``channels=None`` — the mobile loop's per-requeue realloc does, to skip
    building a throwaway list of channel objects.
    """
    z = np.asarray(z_bits, dtype=np.float64)
    tc = np.asarray(tcmp, dtype=np.float64)
    if q is None:
        q = np.array([ch.q for ch in channels], dtype=np.float64)
    else:
        q = np.asarray(q, dtype=np.float64)
    n = len(q)
    assert len(z) == len(tc) == n

    def need(t: float) -> float:
        # cumsum[-1] is the same sequential left-to-right addition a
        # python ``sum`` over the scalar calls performed (np.sum's pairwise
        # reduction would differ in the last ulps), so vectorizing the
        # bisection keeps t_star bit-for-bit
        return float(np.cumsum(bandwidths_for_time(z, t, tc, q))[-1])

    lo = float(tc.max()) * (1.0 + 1e-9) + 1e-12
    hi = max(lo * 2.0, 1e-6)
    warm = t_hint is not None and np.isfinite(t_hint) and t_hint > lo
    obs.CURRENT.add("bandwidth.warm_starts" if warm
                    else "bandwidth.cold_starts")
    if warm:
        if need(float(t_hint)) > total_bw:
            lo = float(t_hint)           # T* above the hint: raise the floor
            hi = max(hi, lo * 2.0)
        else:
            hi = float(t_hint)           # T* at or below the hint: cap
    while need(hi) > total_bw and hi < 1e12:
        hi *= 2.0
    met_tol = False
    iters = 0
    for _ in range(max_iter):
        iters += 1
        mid = 0.5 * (lo + hi)
        if need(mid) > total_bw:
            lo = mid
        else:
            hi = mid
        if hi - lo < tol * max(hi, 1.0):
            met_tol = True
            break
    obs.CURRENT.add("bandwidth.bisect_iters", iters)
    t_star = hi
    b = bandwidths_for_time(z, t_star, tc, q)
    # numerical guard: scale onto the simplex Σb = B — and *say so* when the
    # scale is material (then b no longer equalises finish times at t_star)
    s = b.sum()
    rescale_ok = bool(np.isfinite(s) and s > 0
                      and abs(s - total_bw) <= 1e-6 * total_bw)
    if np.isfinite(s) and s > 0:
        b = b * (total_bw / s)
    return EqualFinishAllocation(b, t_star, met_tol and rescale_ok)


def theorem4_lower_bound(z_bits: float, t_star: float, tcmp: float,
                         ch: UEChannel, eta_i: float) -> float:
    """The Γ-form lower bound of Eq. (33) for b_k^i (paper's closed form).

    With Γ = Z·N₀/((t*−Tcmp)·p·h·d^{−κ}) = (Z/t_com)/q this is
    η_i · (−q·Γ / (W₋₁(−Γe^{−Γ}) + Γ)) = η_i · Z / (t_com · −(W+Γ)) —
    i.e. η_i times the Theorem-4 closed-form bandwidth for rate Z/t_com
    (``bandwidth_for_rate``; pinned by ``tests/test_bandwidth.py``).  An
    earlier version multiplied *and divided* by ``total_bw · n_ues``,
    carrying two dead parameters through the formula.
    """
    t_com = t_star - tcmp
    if t_com <= 0:
        return float("inf")
    gamma = z_bits * ch.n0 / (t_com * ch.p * ch.h * ch.dist ** (-ch.kappa))
    w = float(lambertw(np.asarray(-gamma * np.exp(-gamma)), branch=-1))
    denom = w + gamma
    if denom >= 0:
        return float("inf")
    return eta_i * z_bits / (t_com * (-denom))


def weighted_equal_rate_allocation(eta: Sequence[float],
                                   channels: Sequence[UEChannel],
                                   total_bw: float, *, iters: int = 100
                                   ) -> np.ndarray:
    """The other extreme of Theorem 4: all n UEs share B with rates
    r_i/η_i equalised (fixed-point on the common rate scale)."""
    eta = np.asarray(eta, dtype=np.float64)
    n = len(channels)
    b = np.full(n, total_bw / n)
    for _ in range(iters):
        # current per-unit-eta rate implied by each b_i
        r = np.array([uplink_rate(b[i], channels[i]) for i in range(n)])
        scale = r / eta
        target = np.exp(np.mean(np.log(np.maximum(scale, 1e-30))))
        b_new = np.array([bandwidth_for_rate(target * eta[i], channels[i])
                          for i in range(n)])
        if not np.all(np.isfinite(b_new)):
            b_new = np.where(np.isfinite(b_new), b_new, b)
        b_new = b_new * (total_bw / b_new.sum())
        if np.max(np.abs(b_new - b)) < 1e-9 * total_bw:
            b = b_new
            break
        b = 0.5 * b + 0.5 * b_new
    return b


def optimal_bandwidth(z_bits: Sequence[float], tcmp: Sequence[float],
                      channels: Sequence[UEChannel], total_bw: float,
                      ) -> EqualFinishAllocation:
    """Public entry: Theorem-2 equal-finish allocation for one round's
    scheduled set; returns ``EqualFinishAllocation(b, round_time,
    converged)``."""
    return equal_finish_allocation(z_bits, tcmp, channels, total_bw)


# ---------------------------------------------------------------------------
# Footnote-1 extension: transmit power as a decision variable
# ---------------------------------------------------------------------------

def power_for_time(z_bits: float, t: float, tcmp: float, bandwidth_hz: float,
                   ch: UEChannel, p_max: float = float("inf")) -> float:
    """Minimum transmit power so the UE finishes Z bits in exactly t seconds
    at fixed bandwidth b (the paper's footnote-1 generalisation: "other
    decision variables such like transmit power can also be included").

    Invert Eq. 9 in p:  r = b·ln(1 + p·g/(b·N₀))  ⇒
        p = (e^{r/b} − 1)·b·N₀ / g,   g ≡ h·d^{−κ}.
    Returns +inf (infeasible) if p > p_max or t ≤ tcmp.
    """
    t_com = t - tcmp
    if t_com <= 0 or bandwidth_hz <= 0:
        return float("inf")
    rate_nats = z_bits * np.log(2.0) / t_com
    g = ch.h * ch.dist ** (-ch.kappa)
    p = (np.exp(rate_nats / bandwidth_hz) - 1.0) * bandwidth_hz * ch.n0 / g
    return float(p) if p <= p_max else float("inf")


def min_power_equal_finish(z_bits: Sequence[float], tcmp: Sequence[float],
                           bandwidths: Sequence[float],
                           channels: Sequence[UEChannel], t_star: float
                           ) -> np.ndarray:
    """Per-UE minimum powers hitting a common finish time t* at the given
    bandwidth split — the energy-efficient counterpart of Theorem 2."""
    return np.array([
        power_for_time(z_bits[i], t_star, tcmp[i], bandwidths[i], channels[i])
        for i in range(len(channels))])
