"""The port's host-side numpy modules equal the JAX package's bitwise.

These modules were copied with their numpy draw schedules untouched, so on
the same seeds every array must match exactly: the wireless drop and both
fading streams, Eq. (10)–(11) requeue pricing, Theorem-4 bandwidth, the
scheduler's η, the non-iid partition and the synthetic data.
"""
import numpy as np
import pytest

import repro.core.bandwidth as ref_bw
import repro.core.scheduler as ref_sched
import repro.data.partition as ref_part
import repro.data.synthetic as ref_syn
import repro.fl.driver as ref_driver
import repro.wireless.channel as ref_chan
import repro.wireless.timing as ref_timing
import repro_torch.core.bandwidth as bw
import repro_torch.core.scheduler as sched
import repro_torch.data.partition as part
import repro_torch.data.synthetic as syn
import repro_torch.fl.driver as driver
import repro_torch.wireless.channel as chan
import repro_torch.wireless.timing as timing
from repro.config import WirelessConfig as RefWirelessConfig
from repro_torch.config import WirelessConfig


def _nets(n, seed, rng_mode="legacy", uniform=False):
    return (ref_chan.EdgeNetwork.drop(RefWirelessConfig(rng=rng_mode), n,
                                      seed=seed, uniform_distance=uniform),
            chan.EdgeNetwork.drop(WirelessConfig(rng=rng_mode), n, seed=seed,
                                  uniform_distance=uniform))


@pytest.mark.parametrize("uniform", [False, True])
def test_drop_and_legacy_fading_stream_bitwise(uniform):
    ref, port = _nets(64, seed=7, uniform=uniform)
    np.testing.assert_array_equal(port.distances, ref.distances)
    np.testing.assert_array_equal(port.cpu_freq, ref.cpu_freq)
    for k in (64, 5, 1, 17):
        np.testing.assert_array_equal(port.sample_fading_batch(k),
                                      ref.sample_fading_batch(k))


def test_counter_fading_stream_bitwise():
    ref, port = _nets(64, seed=3, rng_mode="counter")
    rng = np.random.default_rng(0)
    for k in (64, 5, 1, 17):
        idx = rng.choice(64, size=k, replace=k > 32)
        np.testing.assert_array_equal(port.fading_lanes(idx),
                                      ref.fading_lanes(idx))


class _Shim:
    def __init__(self, net, bw_hz):
        self.net, self.bw = net, bw_hz

    def bind_link_budget(self, z_bits, d_i):
        pass

    def pre_requeue(self, ues):
        pass


@pytest.mark.parametrize("rng_mode", ["legacy", "counter"])
def test_requeue_pricing_bitwise(rng_mode):
    ref_net, port_net = _nets(32, seed=1, rng_mode=rng_mode)
    wl = WirelessConfig(rng=rng_mode)
    bw_hz = np.full(32, wl.total_bandwidth_hz / 32)
    d_i = np.full(32, 24)
    z = 79_510 * 32.0
    ref_fn = ref_driver.make_cycle_duration_fn(
        _Shim(ref_net, bw_hz), RefWirelessConfig(rng=rng_mode), z, d_i)
    port_fn = driver.make_cycle_duration_fn(_Shim(port_net, bw_hz), wl, z,
                                            d_i)
    rng = np.random.default_rng(2)
    for k in (32, 3, 1, 9):
        ues = rng.choice(32, size=k, replace=False)
        np.testing.assert_array_equal(port_fn(ues), ref_fn(ues))


def test_theorem4_bandwidth_bitwise():
    ref_net, port_net = _nets(16, seed=5)
    wl = WirelessConfig()
    h = wl.rayleigh_scale * float(np.sqrt(np.pi / 2))
    eta = ref_sched.get_policy("distance").frequencies(16, ref_net)
    np.testing.assert_array_equal(
        sched.get_policy("distance").frequencies(16, port_net), eta)
    ref_ch = [ref_net.channel(i, h) for i in range(16)]
    port_ch = [port_net.channel(i, h) for i in range(16)]
    np.testing.assert_array_equal(
        bw.weighted_equal_rate_allocation(eta, port_ch, wl.total_bandwidth_hz),
        ref_bw.weighted_equal_rate_allocation(eta, ref_ch,
                                              wl.total_bandwidth_hz))
    tcmp = timing.compute_times(wl.cpu_cycles_per_sample, np.full(16, 24),
                                port_net.cpu_freq)
    np.testing.assert_array_equal(
        tcmp, ref_timing.compute_times(wl.cpu_cycles_per_sample,
                                       np.full(16, 24), ref_net.cpu_freq))
    got = bw.equal_finish_allocation(np.full(16, 2.5e6), tcmp, port_ch,
                                     wl.total_bandwidth_hz)
    want = ref_bw.equal_finish_allocation(np.full(16, 2.5e6), tcmp, ref_ch,
                                          wl.total_bandwidth_hz)
    np.testing.assert_array_equal(got.b, want.b)
    assert got.t_star == want.t_star and got.converged == want.converged
    x = np.linspace(-1 / np.e, 0, 50)[1:-1]
    for branch in (0, -1):
        np.testing.assert_array_equal(bw.lambertw(x, branch),
                                      ref_bw.lambertw(x, branch))


@pytest.mark.parametrize("mode", ["equal", "distance", "distance-proxy"])
def test_scheduler_eta_and_plan_bitwise(mode):
    ref_net, port_net = _nets(12, seed=9)
    eta = sched.get_policy(mode).frequencies(12, port_net)
    np.testing.assert_array_equal(
        eta, ref_sched.get_policy(mode).frequencies(12, ref_net))
    np.testing.assert_array_equal(sched.greedy_schedule(eta, 4, 10),
                                  ref_sched.greedy_schedule(eta, 4, 10))


def test_synthetic_mnist_and_partition_bitwise():
    data = syn.synthetic_mnist(n=700, seed=21)
    ref_data = ref_syn.synthetic_mnist(n=700, seed=21)
    for k in ref_data:
        np.testing.assert_array_equal(data[k], ref_data[k])
        assert data[k].dtype == ref_data[k].dtype
    got = part.partition_noniid(data, 9, n_labels=3, seed=4)
    want = ref_part.partition_noniid(ref_data, 9, n_labels=3, seed=4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.labels_held, w.labels_held)
        for split in ("data", "test"):
            for k in w.data:
                np.testing.assert_array_equal(getattr(g, split)[k],
                                              getattr(w, split)[k])
        # the private samplers sit at the same point of their streams
        tg, tw = g.sample_triplet(8, 8, 8), w.sample_triplet(8, 8, 8)
        for part_name in tw:
            for k in tw[part_name]:
                np.testing.assert_array_equal(tg[part_name][k],
                                              tw[part_name][k])
    many = part.sample_triplet_many(got[:4], 8, 8, 8)
    ref_many = ref_part.sample_triplet_many(want[:4], 8, 8, 8)
    for part_name in ref_many:
        for k in ref_many[part_name]:
            np.testing.assert_array_equal(many[part_name][k],
                                          ref_many[part_name][k])


def test_model_bits_counts_numel():
    import jax
    import torch

    from repro.configs import get_config as ref_get_config
    from repro.models import build_model as ref_build_model
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    want = ref_timing.model_bits(jax.eval_shape(
        ref_build_model(ref_get_config("mnist_dnn")).init,
        jax.random.PRNGKey(0)))
    params = build_model(get_config("mnist_dnn")).init(
        torch.Generator().manual_seed(0))
    assert timing.model_bits(params) == want == 79_510 * 32.0
    assert timing.model_bits(params, 16) == want / 2
