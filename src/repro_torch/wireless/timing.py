"""Latency model — Eq. (10)–(12).

* ``compute_time``  Tcmp = c_i·d_i / ϑ_i         (Eq. 11)
* ``upload_time``   Tcom = Z / r_k^i             (Eq. 10), Z in bits
* ``round_time``    T_k  = max over scheduled UEs (C1.1)

``compute_times`` / ``upload_times`` are the vectorized counterparts used by
the unified event-loop driver (``fl/driver.py``) to price a whole requeue of
UEs in one shot.  They apply the exact same sequence of IEEE-754 operations
as the scalar forms, so a batched requeue is *bitwise identical* to the
legacy per-UE loop (pinned by ``tests/test_driver.py``).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.bandwidth import UEChannel, uplink_rate
from repro_torch.utils.tree import tree_leaves

LN2 = float(np.log(2.0))


def compute_time(cycles_per_sample: float, n_samples: int,
                 cpu_freq_hz: float) -> float:
    return cycles_per_sample * n_samples / cpu_freq_hz


def upload_time(z_bits: float, bandwidth_hz: float, ch: UEChannel) -> float:
    """Z bits over rate r(b) nats/s → seconds (bits × ln2 = nats)."""
    r = float(uplink_rate(bandwidth_hz, ch))
    if r <= 0:
        return float("inf")
    return z_bits * LN2 / r


def compute_times(cycles_per_sample: float, n_samples: np.ndarray,
                  cpu_freq_hz: np.ndarray) -> np.ndarray:
    """Vectorized Eq. (11): ``c·d_i / ϑ_i`` per UE — same op order as
    ``compute_time`` (multiply, then divide), hence bitwise identical."""
    return cycles_per_sample * np.asarray(n_samples) \
        / np.asarray(cpu_freq_hz, dtype=np.float64)


def upload_times(z_bits: float, bandwidth_hz: np.ndarray,
                 q: np.ndarray) -> np.ndarray:
    """Vectorized Eq. (10) over per-UE bandwidths and SNR numerators.

    ``q`` is ``UEChannel.q`` per UE (p·h·d^{−κ}/N₀); the rate expression is
    the same ufunc chain ``b·log1p(q/max(b, ε))`` that ``uplink_rate``
    applies to a scalar, so every lane is bitwise identical to the scalar
    path.  Non-positive rates yield +inf, matching ``upload_time``.
    """
    b = np.asarray(bandwidth_hz, dtype=np.float64)
    r = b * np.log1p(np.asarray(q, dtype=np.float64)
                     / np.maximum(b, 1e-12))
    out = np.full_like(r, np.inf)
    np.divide(z_bits * LN2, r, out=out, where=r > 0)
    return out


def finish_times(z_bits, bandwidths, channels, tcmp) -> np.ndarray:
    """Per-UE compute+upload finish time of a bandwidth allocation — the
    quantity Theorem 2 equalises.  ``z_bits`` may be a scalar (every UE
    uploads the same model) or per-UE; delegates to the one vectorized
    Eq. (10) implementation (``upload_times``), so allocation scoring in
    the Theorem-2 property suite can never drift from the driver's
    pricing."""
    n = len(channels)
    q = np.array([ch.q for ch in channels], dtype=np.float64)
    z = np.broadcast_to(np.asarray(z_bits, dtype=np.float64), (n,))
    return np.asarray(tcmp, dtype=np.float64) \
        + upload_times(z, np.asarray(bandwidths, dtype=np.float64), q)


def round_time(times: np.ndarray) -> float:
    """T_k = max_{i∈A_k} T_k^i.  An empty scheduled set (a hierarchical
    cell with no arrivals this round) takes no time, rather than letting
    ``np.max([])`` raise a bare ValueError."""
    times = np.asarray(times)
    if times.size == 0:
        return 0.0
    return float(np.max(times))


def model_bits(params, bits_per_param: int = 32) -> float:
    """Z — payload size for one gradient upload (16 = fp16 uploads)."""
    if bits_per_param <= 0:
        raise ValueError(f"bits_per_param must be positive, "
                         f"got {bits_per_param}")
    return float(sum(x.numel() for x in tree_leaves(params))) * bits_per_param
