"""The paper's algorithm grid end to end, the port against the JAX reference.

{FedAvg, FedProx, PerFed} × {synchronous, semi-synchronous, asynchronous},
and pFedMe in the semi-synchronous and asynchronous modes, through
``run_simulation(..., device="cpu")`` on mnist_dnn (n 8, A 3, S 3, 5
rounds): host event math (times, Π, wait fraction, total time, dispatch
counts) bitwise, losses and final params within rtol 1e-5, atol 1e-6.
Also the Theorem-1 / Corollary-1 expressions of ``core/convergence.py``,
which must equal the reference's bit for bit.
"""
import dataclasses

import pytest
from test_torch_mobility import hold_pair, run_pair

from repro.core import convergence as ref_conv
from repro_torch.core import convergence as conv
from repro_torch.core import fosp_bound, step_condition

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
