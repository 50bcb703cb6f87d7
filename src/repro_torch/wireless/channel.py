"""Mobile-edge wireless model — Sec. III-A (Eq. 9) + Table I parameters.

UEs are dropped uniformly in a cell of radius R around the BS; uplink rates
follow OFDMA with per-UE bandwidth b:  r = b·ln(1 + p·h·d^{−κ} / (b·N₀)),
with Rayleigh small-scale fading h resampled per communication round.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.config import WirelessConfig
from repro_torch.core.bandwidth import UEChannel


def noise_w_per_hz(n0_dbm_per_hz: float) -> float:
    return 10.0 ** (n0_dbm_per_hz / 10.0) / 1000.0


_noise_w_per_hz = noise_w_per_hz      # historical private alias


# ---------------------------------------------------------------------------
# counter-based fading (``WirelessConfig.rng == "counter"``)
# ---------------------------------------------------------------------------
# The legacy stream prices a requeue of k UEs by drawing the full [k, n]
# Rayleigh matrix (to stay bitwise identical to the original per-UE loop,
# which drew the whole [n] vector per cycle) — O(k·n) host RNG work that
# dominates warm wall at 16k+ UEs.  The counter stream instead derives each
# lane's coefficient from (seed, ue, per-UE draw counter) with a splitmix64
# hash and the inverse Rayleigh CDF: O(k) per requeue, and the value a UE's
# j-th cycle sees is a pure function of (seed, ue, j) — independent of how
# the event loop batches its pricing calls.

_SM_GAMMA = np.uint64(0x9E3779B97F4A7C15)
_SM_MIX1 = np.uint64(0xBF58476D1CE4E5B9)
_SM_MIX2 = np.uint64(0x94D049BB133111EB)
_FADE_STREAM = np.uint64(0x66616465)          # "fade" — stream separation
_U53 = 2.0 ** -53


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (uint64 in, uint64 out)."""
    z = np.asarray(x, dtype=np.uint64) + _SM_GAMMA
    z = (z ^ (z >> np.uint64(30))) * _SM_MIX1
    z = (z ^ (z >> np.uint64(27))) * _SM_MIX2
    return z ^ (z >> np.uint64(31))


def counter_fading_seed(seed: int) -> np.uint64:
    """Per-network base key of the counter fading stream."""
    # hash through a length-1 array: numpy warns on *scalar* uint64
    # wraparound but wraps array lanes silently (wrapping is the point)
    s = np.asarray([np.int64(seed) & np.int64(0x7FFFFFFFFFFFFFFF)],
                   dtype=np.uint64)
    return splitmix64(s ^ _FADE_STREAM)[0]


def counter_rayleigh(base: np.uint64, ues: np.ndarray, counters: np.ndarray,
                     scale: float) -> np.ndarray:
    """Rayleigh(scale) draw for each (ue, counter) lane.

    Two chained splitmix64 rounds hash (base, ue, counter) to a uniform in
    [0, 1), which the inverse CDF h = σ·√(−2·ln(1 − u)) maps to Rayleigh —
    same marginal distribution as ``numpy.Generator.rayleigh``, different
    bitstream (moment/KS properties pinned in ``tests/test_counter_rng.py``).
    """
    ues = np.asarray(ues, dtype=np.uint64)
    counters = np.asarray(counters, dtype=np.uint64)
    z = splitmix64(np.asarray(base, np.uint64) ^ (ues * _SM_MIX1))
    z = splitmix64(z ^ counters)
    u = (z >> np.uint64(11)).astype(np.float64) * _U53
    return scale * np.sqrt(-2.0 * np.log1p(-u))


class CounterFadingMixin:
    """Counter-stream pricing shared by ``EdgeNetwork`` and
    ``MultiCellNetwork``.  Hosts the per-UE draw counters; ``fading_lanes``
    is the O(k) hot-path entry the driver uses when ``cfg.rng ==
    "counter"``."""

    def _init_counter_fading(self, seed: int, n_ues: int) -> None:
        self._fade_base = counter_fading_seed(seed)
        self._fade_count = np.zeros(n_ues, dtype=np.uint64)

    def fading_lanes(self, idx: np.ndarray) -> np.ndarray:
        """One Rayleigh coefficient per requeued lane, consuming each
        lane's private counter — O(k log k), no [k, n] matrix.

        A UE repeated within one call consumes successive counters, so the
        stream a UE sees depends only on its own draw count, never on how
        the event loop batches pricing calls (the driver never repeats a
        UE within a drain, but the contract holds regardless)."""
        idx = np.asarray(idx, dtype=np.int64)
        k = len(idx)
        if k == 0:
            return np.zeros(0)
        order = np.argsort(idx, kind="stable")
        s = idx[order]
        first = np.empty(k, dtype=bool)
        first[0] = True
        np.not_equal(s[1:], s[:-1], out=first[1:])
        starts = np.nonzero(first)[0]
        counts = np.diff(np.append(starts, k))
        # occurrence rank within each UE's run of the (stable-)sorted lanes
        rank = (np.arange(k) - np.repeat(starts, counts)).astype(np.uint64)
        ctr = self._fade_count[s] + rank
        self._fade_count[s[starts]] += counts.astype(np.uint64)
        out = np.empty(k, dtype=np.float64)
        out[order] = counter_rayleigh(self._fade_base, s, ctr,
                                      self.cfg.rayleigh_scale)
        return out


def validate_rng_mode(rng: str) -> str:
    if rng not in ("legacy", "counter"):
        raise ValueError(f"unknown fading rng mode {rng!r}; "
                         f"known: ['counter', 'legacy']")
    return rng


def pathloss_pow(distances: np.ndarray, kappa: float) -> np.ndarray:
    """``d^{−κ}`` per UE, computed with *python-scalar* pow.

    ``UEChannel.q`` evaluates ``dist ** (-kappa)`` on python floats; numpy's
    vectorized pow differs from libm's scalar pow by 1 ulp on a few percent
    of inputs, which would break the bitwise-reproduction pins on the event
    loop.  Distances only change when mobility re-associates, so the driver
    caches this per distances-array and the scalar loop stays off the
    per-requeue hot path.
    """
    return np.array([float(x) ** (-kappa) for x in np.asarray(distances)],
                    dtype=np.float64)


def make_channel(cfg: WirelessConfig, dist: float, h: float) -> UEChannel:
    """One UE's channel snapshot from config + geometry + fading — the one
    place Table-I parameters turn into a ``UEChannel`` (shared by the
    static ``EdgeNetwork`` and the mobile ``MultiCellNetwork``)."""
    return UEChannel(p=cfg.tx_power_w, h=float(h), dist=float(dist),
                     kappa=cfg.path_loss_exp,
                     n0=_noise_w_per_hz(cfg.noise_dbm_per_hz))


def mean_rates_for(cfg: WirelessConfig, distances: np.ndarray,
                   bandwidth_per_ue: Optional[float] = None) -> np.ndarray:
    """Expected uplink rate per UE at mean fading and equal-split bandwidth
    (the Sec. VI-A-4 η-derivation input)."""
    from repro_torch.core.bandwidth import uplink_rate
    n = len(distances)
    b = bandwidth_per_ue or cfg.total_bandwidth_hz / n
    h_mean = cfg.rayleigh_scale * np.sqrt(np.pi / 2.0)
    return np.array([
        float(uplink_rate(b, make_channel(cfg, distances[i], h_mean)))
        for i in range(n)])


@dataclass
class EdgeNetwork(CounterFadingMixin):
    """A drop of n UEs in the cell: static geometry + per-UE compute speeds."""
    cfg: WirelessConfig
    n_ues: int
    distances: np.ndarray          # [n] m
    cpu_freq: np.ndarray           # [n] Hz — heterogeneous CPUs (stragglers!)
    rng: np.random.Generator

    @classmethod
    def drop(cls, cfg: WirelessConfig, n_ues: int, seed: int = 0,
             uniform_distance: bool = False) -> "EdgeNetwork":
        validate_rng_mode(cfg.rng)
        rng = np.random.default_rng(seed)
        if uniform_distance:
            distances = np.full(n_ues, cfg.cell_radius_m / 2.0)
        else:
            # uniform in the disc → sqrt for radius; min 5 m
            distances = np.maximum(
                cfg.cell_radius_m * np.sqrt(rng.uniform(size=n_ues)), 5.0)
        # CPU frequencies log-uniform over the heterogeneity ratio
        ratio = max(cfg.cpu_hetero, 1.0)
        cpu = cfg.cpu_freq_hz * np.exp(
            rng.uniform(np.log(1.0 / ratio), 0.0, size=n_ues))
        net = cls(cfg=cfg, n_ues=n_ues, distances=distances, cpu_freq=cpu,
                  rng=rng)
        net._init_counter_fading(seed, n_ues)
        return net

    # ------------------------------------------------------------------
    def sample_fading(self) -> np.ndarray:
        """Rayleigh small-scale coefficients h_k^i for one round (Table I:
        scale parameter 40)."""
        return self.rng.rayleigh(scale=self.cfg.rayleigh_scale,
                                 size=self.n_ues)

    def sample_fading_batch(self, k: int) -> np.ndarray:
        """``k`` successive ``sample_fading()`` draws as ONE ``[k, n]`` RNG
        call — bitwise identical to the loop (numpy Generators fill arrays
        from the bitstream in C order), at a fraction of the call overhead.
        The unified driver prices a whole requeue per draw this way."""
        return self.rng.rayleigh(scale=self.cfg.rayleigh_scale,
                                 size=(k, self.n_ues))

    def channel(self, ue: int, h: Optional[float] = None) -> UEChannel:
        hval = float(h) if h is not None else float(self.sample_fading()[ue])
        return make_channel(self.cfg, self.distances[ue], hval)

    def channels(self, h: Optional[np.ndarray] = None) -> list:
        h = h if h is not None else self.sample_fading()
        return [self.channel(i, h[i]) for i in range(self.n_ues)]

    def mean_rates(self, bandwidth_per_ue: Optional[float] = None
                   ) -> np.ndarray:
        """Expected uplink rate per UE at equal-split bandwidth (used to
        derive distance-based η in Sec. VI-A-4)."""
        return mean_rates_for(self.cfg, self.distances, bandwidth_per_ue)


def sample_channels(cfg: WirelessConfig, n_ues: int, seed: int = 0):
    return EdgeNetwork.drop(cfg, n_ues, seed)
