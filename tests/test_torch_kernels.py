"""Eq.-8 aggregation of the PyTorch port vs the JAX reference.

On the CPU the port's ``stale_aggregate_flat`` runs its plain torch version
(the c-ordered f32 loop the CUDA kernel computes).  It is held against the
reference's Pallas kernel in interpret mode and its ``jnp`` backend at
atol/rtol 1e-6: the sum order differs from XLA's dot.  The CUDA kernel
itself runs only on a card (``tests/test_torch_card.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import stale_aggregate as ref_agg
from repro_torch.kernels import stale_aggregate as agg

TOL = dict(rtol=1e-6, atol=1e-6)


def _inputs(c, n, seed, mask_kind="mixed"):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=n).astype(np.float32)
    buf = rng.normal(size=(c, n)).astype(np.float32)
    if mask_kind == "zeros":
        mask = np.zeros(c, np.float32)
    else:
        # zeros (padded lanes) and fractional λ^τ-style weights
        mask = rng.choice([0.0, 1.0, 0.5, 0.7 ** 3], size=c).astype(
            np.float32)
        mask[0] = 1.0
    return p, buf, mask


def _t(x):
    return torch.from_numpy(x.copy())


@pytest.mark.parametrize("c", [1, 2, 5, 128, 256])
@pytest.mark.parametrize("n", [79_510, 7, 1_001, 1])
def test_plain_matches_reference_flat(c, n):
    p, buf, mask = _inputs(c, n, seed=c * 1000 + n)
    got = agg.stale_aggregate_flat(_t(p), _t(buf), _t(mask), beta=0.07)
    assert got.dtype == torch.float32 and got.shape == (n,)
    jp, jb, jm = jnp.asarray(p), jnp.asarray(buf), jnp.asarray(mask)
    want_jnp = ref_agg.stale_aggregate_update(jp, jb, jm, beta=0.07,
                                              backend="jnp")
    np.testing.assert_allclose(got.numpy(), np.asarray(want_jnp), **TOL)
    want_pl = ref_agg.stale_aggregate_flat(jp, jb, jm, beta=0.07,
                                           interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_pl), **TOL)


def test_no_rows_gives_params():
    """C = 0: A clamps to 1 and the output is p (the Pallas reference
    takes no C = 0; its jnp backend does)."""
    p, _, _ = _inputs(1, 11, seed=4)
    buf, mask = np.zeros((0, 11), np.float32), np.zeros(0, np.float32)
    got = agg.stale_aggregate_flat(_t(p), _t(buf), _t(mask), beta=0.5)
    np.testing.assert_array_equal(got.numpy(), p)
    want = ref_agg.stale_aggregate_update(jnp.asarray(p), jnp.asarray(buf),
                                          jnp.asarray(mask), beta=0.5,
                                          backend="jnp")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,want", [(79_510, 2), (1_000_003, 1),
                                    (1_000_000, 4), (6, 2), (1, 1)])
def test_vector_width_is_the_widest_that_divides_n(n, want):
    """The kernel's V: rows of a [C, N] buffer stay V-aligned only if V
    divides N (mnist_dnn's N = 79,510 takes 2)."""
    t = torch.zeros(n + 1)
    assert agg.vector_width(n, t, t) == want
    assert agg.vector_width(n, t, t[1:]) == 1     # a pointer 4 bytes off


def test_all_zero_mask_clamps_a_to_one():
    p, buf, mask = _inputs(5, 7, seed=3, mask_kind="zeros")
    got = agg.stale_aggregate_flat(_t(p), _t(buf), _t(mask), beta=0.5)
    np.testing.assert_array_equal(got.numpy(), p)
    want = ref_agg.stale_aggregate_flat(jnp.asarray(p), jnp.asarray(buf),
                                        jnp.asarray(mask), beta=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _trees(c, seed):
    rng = np.random.default_rng(seed)
    params = {"fc1": {"dense_w": rng.normal(size=(6, 4)),
                      "dense_b": rng.normal(size=4)},
              "fc2": {"dense_w": rng.normal(size=(4, 3)),
                      "dense_b": rng.normal(size=3)}}
    params = {k: {n: v.astype(np.float32) for n, v in d.items()}
              for k, d in params.items()}
    payloads = [{k: {n: rng.normal(size=v.shape).astype(np.float32)
                     for n, v in d.items()} for k, d in params.items()}
                for _ in range(c)]
    mask = np.array([1.0, 0.0, 0.5, 0.343, 1.0][:c], np.float32)
    return params, payloads, mask


def _torch_tree(t):
    return {k: _torch_tree(v) if isinstance(v, dict) else _t(v)
            for k, v in t.items()}


def _jax_tree(t):
    return {k: _jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in t.items()}


def _stack(trees, fn):
    return {k: _stack([t[k] for t in trees], fn) if isinstance(trees[0][k],
                                                                dict)
            else fn([t[k] for t in trees]) for k in trees[0]}


def _assert_tree_close(got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        if isinstance(got[k], dict):
            _assert_tree_close(got[k], want[k])
        else:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       **TOL)


@pytest.mark.parametrize("stacked", [False, True], ids=["list", "stacked"])
def test_stale_aggregate_tree_matches_reference(stacked):
    params, payloads, mask = _trees(5, seed=11)
    if stacked:
        tp = _stack([_torch_tree(x) for x in payloads], torch.stack)
        jp = _stack([_jax_tree(x) for x in payloads], jnp.stack)
    else:
        tp = [_torch_tree(x) for x in payloads]
        jp = [_jax_tree(x) for x in payloads]
    got = agg.stale_aggregate_tree(_torch_tree(params), tp, _t(mask),
                                   beta=0.07)
    for backend in ("jnp", "pallas"):
        want = ref_agg.stale_aggregate_tree(_jax_tree(params), jp,
                                            jnp.asarray(mask), beta=0.07,
                                            backend=backend)
        _assert_tree_close(got, want)


@pytest.mark.parametrize("stacked", [False, True], ids=["list", "stacked"])
def test_masked_aggregate_tree_matches_reference(stacked):
    _, payloads, mask = _trees(5, seed=12)
    if stacked:
        tp = _stack([_torch_tree(x) for x in payloads], torch.stack)
        jp = _stack([_jax_tree(x) for x in payloads], jnp.stack)
    else:
        tp = [_torch_tree(x) for x in payloads]
        jp = [_jax_tree(x) for x in payloads]
    got = agg.masked_aggregate_tree(tp, _t(mask))
    _assert_tree_close(got, ref_agg.masked_aggregate_tree(jp,
                                                          jnp.asarray(mask)))


def test_cpu_wrapper_uses_plain_version_and_counts_no_launch():
    p, buf, mask = _inputs(5, 7, seed=5)
    before = agg.LAUNCHES
    got = agg.stale_aggregate_flat(_t(p), _t(buf), _t(mask), beta=0.07)
    want = agg.stale_aggregate_plain(_t(p), _t(buf), _t(mask), beta=0.07)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert agg.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "contiguous", "shape", "backend"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    p, buf, mask = (_t(x) for x in _inputs(4, 8, seed=6))
    if bad == "dtype":
        with pytest.raises(TypeError):
            agg.stale_aggregate_flat(p.double(), buf, mask, beta=0.1)
    elif bad == "contiguous":
        with pytest.raises(ValueError):
            agg.stale_aggregate_flat(p, buf.t().contiguous().t(), mask,
                                     beta=0.1)
    elif bad == "shape":
        with pytest.raises(ValueError):
            agg.stale_aggregate_flat(p, buf[:, :7].contiguous(), mask,
                                     beta=0.1)
    else:
        with pytest.raises(ValueError):
            agg.stale_aggregate_update(p, buf, mask, beta=0.1,
                                       backend="pallas")

