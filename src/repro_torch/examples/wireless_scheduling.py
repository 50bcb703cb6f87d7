"""The wireless side of the paper end-to-end: drop UEs in a cell, derive η
from their channels, build the Alg.-2 schedule, and compare bandwidth
allocation policies (Theorem 2/4 vs naive equal split).

    PYTHONPATH=src python -m repro_torch.examples.wireless_scheduling \
        [--device cpu]

Host numpy only, as in the JAX package: its output is the reference
example's, line for line.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np

from repro_torch.config import FLConfig, WirelessConfig
from repro_torch.core.bandwidth import (equal_finish_allocation, uplink_rate,
                                        weighted_equal_rate_allocation)
from repro_torch.core.convergence import (SmoothnessParams, gamma_F2,
                                          sigma_F2, smoothness_F)
from repro_torch.core.scheduler import (estimate_A_K, get_policy,
                                        greedy_schedule, schedule_period)
from repro_torch.fl.engine import resolve_device
from repro_torch.wireless.channel import EdgeNetwork

LN2 = np.log(2)


def main(argv=None):
    """Returns {"eta", "a_star", "k_star", "pi", "b_opt", "b_eq",
    "round_time_opt", "round_time_eq", "b_wer"}."""
    ap = argparse.ArgumentParser(description="wireless scheduling demo")
    ap.add_argument("--device", default="cuda",
                    help="checked only: every step here is host numpy")
    resolve_device(ap.parse_args(argv).device)

    # --- 1) drop 8 UEs in a 200 m cell --------------------------------------
    wcfg = WirelessConfig()
    net = EdgeNetwork.drop(wcfg, 8, seed=1)
    print("distances [m]:", net.distances.round(1))
    print("CPU freq [GHz]:", (net.cpu_freq / 1e9).round(2))

    # --- 2) rate-derived relative participation frequencies η ---------------
    policy = get_policy("rates")
    eta = policy.frequencies(8, net)
    print("\nη (rate-derived):", eta.round(3))

    # --- 3) theory → A*, K* (Eq. 42/43) -------------------------------------
    p = SmoothnessParams()
    fl = FLConfig(alpha=0.03, beta=0.05, staleness_bound=3)
    l_f = smoothness_F(p, fl.alpha)
    a_star, k_star = estimate_A_K(fl, eta=eta, epsilon=0.8, L_F=l_f,
                                  sigma_F2=sigma_F2(p, fl.alpha, 16, 16, 16),
                                  gamma_F2=gamma_F2(p, fl.alpha))
    print(f"A* = {a_star}, K* = {k_star}")

    # --- 4) Algorithm 2 greedy schedule (the policy's planner) --------------
    pi = policy.plan(eta, a_star, 12)
    print(f"\nΠ (first 12 rounds, period={schedule_period(pi)}):")
    print(pi)

    # --- 5) bandwidth allocation for a round's scheduled set ----------------
    # (use A=3 here so the allocation demo has a multi-UE round even if A*=1)
    pi3 = greedy_schedule(eta, max(a_star, 3), 12)
    sched = np.where(pi3[0] == 1)[0]
    h = net.sample_fading()
    chans = [net.channel(int(i), h[int(i)]) for i in sched]
    z = [4e5] * len(sched)
    tcmp = [wcfg.cpu_cycles_per_sample * 48 / net.cpu_freq[int(i)]
            for i in sched]

    b_opt, t_star, converged = equal_finish_allocation(
        z, tcmp, chans, wcfg.total_bandwidth_hz)
    if not converged:
        raise RuntimeError("Theorem-2 bisection did not converge")
    b_eq = np.full(len(sched), wcfg.total_bandwidth_hz / len(sched))

    def round_time(b):
        return max(tcmp[i] + z[i] * LN2 / uplink_rate(b[i], chans[i])
                   for i in range(len(sched)))

    print(f"\nscheduled UEs: {sched}")
    print(f"Theorem-2 equal-finish allocation [kHz]: {(b_opt/1e3).round(1)}")
    print(f"  round time: {round_time(b_opt)*1e3:.1f} ms (all UEs finish "
          f"together)")
    print(f"naive equal split: {round_time(b_eq)*1e3:.1f} ms")
    print(f"→ straggler saving: {round_time(b_eq)/round_time(b_opt):.2f}×")

    b_wer = weighted_equal_rate_allocation(eta, net.channels(h),
                                           wcfg.total_bandwidth_hz)
    print(f"\nTheorem-4 all-UE weighted-equal-rate extreme [kHz]: "
          f"{(b_wer/1e3).round(1)} (Σ={b_wer.sum()/1e6:.3f} MHz)")
    return {"eta": eta, "a_star": a_star, "k_star": k_star, "pi": pi,
            "b_opt": b_opt, "b_eq": b_eq,
            "round_time_opt": round_time(b_opt),
            "round_time_eq": round_time(b_eq), "b_wer": b_wer}


if __name__ == "__main__":
    main()
    sys.exit(0)
