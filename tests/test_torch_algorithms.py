"""The paper's algorithm grid end to end, the port against the JAX reference.

{FedAvg, FedProx, PerFed} × {synchronous, semi-synchronous, asynchronous},
and pFedMe in the semi-synchronous and asynchronous modes, through
``run_simulation(..., device="cpu")`` on mnist_dnn (n 8, A 3, S 3, 5
rounds): host event math (times, Π, wait fraction, total time, dispatch
counts) bitwise, losses and final params within rtol 1e-5, atol 1e-6.
Also the Theorem-1 / Corollary-1 expressions of ``core/convergence.py``,
which must equal the reference's bit for bit.

The end-to-end knobs, each one case of one test through the same runner
(host event math bitwise, losses and params within rtol 1e-5, atol
1e-6): ``staleness_discount`` < 1, fedprox with ``local_epochs=2``,
``bits_per_param=16`` uploads, ``alpha_spread``, char_lstm on
``sequence_clients`` (the synthetic Shakespeare roles), n 40 with A 10,
and LeNet-5 on synthetic CIFAR, each 2 rounds at ``eval_every=2`` (the
LeNet-5 bound: its conv sums drift ~1e-6 of their scale from XLA's,
which a diverging run would amplify).
"""
import dataclasses

import pytest
from test_torch_mobility import hold_pair, run_pair
from test_torch_semi_sync import one_thread

from repro.core import convergence as ref_conv
from repro.data import partition_noniid as ref_partition_noniid
from repro.data import synthetic_cifar as ref_synthetic_cifar
from repro.data import synthetic_shakespeare as ref_synthetic_shakespeare
from repro.data.partition import sequence_clients as ref_sequence_clients
from repro_torch.core import convergence as conv
from repro_torch.core import fosp_bound, step_condition
from repro_torch.data import partition_noniid, synthetic_cifar
from repro_torch.data.partition import sequence_clients
from repro_torch.data.synthetic import synthetic_shakespeare

GRID = [(algo, mode) for algo in ("fedavg", "fedprox", "perfed")
        for mode in ("sync", "semi", "async")] + \
    [("pfedme", "semi"), ("pfedme", "async")]


@pytest.mark.parametrize("algo,mode", GRID,
                         ids=[f"{a}-{m}" for a, m in GRID])
def test_algorithm_grid_matches_reference(algo, mode):
    ref, ref_params, port = run_pair(8, 3, 3, data_n=600, algorithm=algo,
                                     mode=mode, max_rounds=5, eval_every=2,
                                     seed=0)
    hold_pair(ref, ref_params, port)
    assert port.pi.shape[0] == 5
    want_a = {"sync": 8, "semi": 3, "async": 1}[mode]
    assert set(port.pi.sum(1).tolist()) == {want_a}


def _shakespeare(n):
    return (ref_sequence_clients(ref_synthetic_shakespeare(n_roles=n), n),
            sequence_clients(synthetic_shakespeare(n_roles=n), n))


def _cifar(n):
    return (ref_partition_noniid(ref_synthetic_cifar(n=600), n, n_labels=4),
            partition_noniid(synthetic_cifar(n=600), n, n_labels=4))


# name: (n, A, S, run_pair keywords)
KNOBS = {
    "staleness_discount": (8, 3, 3, dict(
        cfg_kw=dict(staleness_discount=0.6))),
    "fedprox_local_epochs_2": (8, 3, 3, dict(
        algorithm="fedprox", cfg_kw=dict(local_epochs=2))),
    "bits_per_param_16": (8, 3, 3, dict(
        cfg_kw=dict(wireless=dict(bits_per_param=16)))),
    "alpha_spread": (8, 3, 3, dict(cfg_kw=dict(alpha_spread=0.5))),
    "char_lstm_sequence_clients": (4, 2, 3, dict(
        clients=_shakespeare(4), cfg_kw=dict(arch="char_lstm"))),
    "n40_a10": (40, 10, 3, dict(data_n=2000)),
    "lenet5": (4, 2, 3, dict(clients=_cifar(4), cfg_kw=dict(arch="lenet5"))),
}


@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_end_to_end_knob_matches_reference(knob):
    n, a, s, kw = KNOBS[knob]
    run = dict(dict(max_rounds=2, eval_every=2, seed=0), **kw)
    with one_thread():
        ref, ref_params, port = run_pair(n, a, s, **run)
    hold_pair(ref, ref_params, port)
    assert port.pi.shape[0] == run["max_rounds"]
    assert set(port.pi.sum(1).tolist()) == {a}


_SMOOTH = [ref_conv.SmoothnessParams(),
           ref_conv.SmoothnessParams(L=2.5, C=0.7, rho=3.1, sigma_G=0.4,
                                     sigma_H=1.9, gamma_G=0.05,
                                     gamma_H=0.8)]


@pytest.mark.parametrize("k", range(len(_SMOOTH)))
def test_convergence_bounds_match_reference_bitwise(k):
    ref_p = _SMOOTH[k]
    p = conv.SmoothnessParams(**dataclasses.asdict(ref_p))
    for alpha in (0.0, 0.03, 0.5):
        pairs = [
            (conv.smoothness_F(p, alpha), ref_conv.smoothness_F(ref_p, alpha)),
            (conv.sigma_F2(p, alpha, 8, 16, 4),
             ref_conv.sigma_F2(ref_p, alpha, 8, 16, 4)),
            (conv.gamma_F2(p, alpha), ref_conv.gamma_F2(ref_p, alpha)),
        ]
        for got, want in pairs:
            assert float(got).hex() == float(want).hex()
    l_f = conv.smoothness_F(p, 0.03)
    for beta, s in ((0.07, 3), (0.001, 12)):
        assert step_condition(l_f, beta, s) == \
            ref_conv.step_condition(l_f, beta, s)
        assert conv.max_feasible_beta(l_f, s) == \
            ref_conv.max_feasible_beta(l_f, s)
        kw = dict(loss_gap=2.3, beta=beta, k=100, a=5, s=s, l_f=l_f,
                  sig_f2=conv.sigma_F2(p, 0.03, 8, 8, 8),
                  gam_f2=conv.gamma_F2(p, 0.03))
        assert fosp_bound(**kw) == ref_conv.fosp_bound(**kw)
    assert conv.corollary1_rates(0.1) == ref_conv.corollary1_rates(0.1)
    assert step_condition(l_f, conv.max_feasible_beta(l_f, 3), 3) == \
        pytest.approx(1.0)
