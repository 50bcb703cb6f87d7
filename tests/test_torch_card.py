"""The port's CUDA kernels on the card, each against its plain version.

Imports no JAX, so it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_card.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX.)

Without a CUDA card every test skips.  Tolerance: 1e-6·(1 + max|p|), since
nvcc contracts the kernel's multiply-adds into FMAs.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import stale_aggregate as agg


def _inputs(c, n, seed):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=n).astype(np.float32)
    buf = rng.normal(size=(c, n)).astype(np.float32)
    mask = rng.choice([0.0, 1.0, 0.5, 0.7 ** 3], size=c).astype(np.float32)
    mask[0] = 1.0
    return (torch.from_numpy(x).cuda() for x in (p, buf, mask))


@pytest.mark.parametrize("c,n", [(1, 79_510), (5, 79_510), (8, 79_510),
                                 (128, 79_510), (16, 1_000_003), (3, 7)])
def test_stale_aggregate_kernel_matches_plain(c, n):
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs a card")
    p, buf, mask = _inputs(c, n, seed=c + n)
    before = agg.LAUNCHES
    got = agg.stale_aggregate_flat(p, buf, mask, beta=0.07)
    torch.cuda.synchronize()
    assert agg.LAUNCHES == before + 1
    want = agg.stale_aggregate_plain(p, buf, mask, beta=0.07)
    err = float((got - want).abs().max())
    assert err <= 1e-6 * (1 + float(p.abs().max()))


def test_stale_aggregate_kernel_rejects_bad_inputs_on_card():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernel needs a card")
    p, buf, mask = _inputs(4, 64, seed=0)
    with pytest.raises(ValueError):
        agg.stale_aggregate_flat(p, buf.cpu(), mask, beta=0.1)
    with pytest.raises(TypeError):
        agg.stale_aggregate_flat(p.half(), buf, mask, beta=0.1)
