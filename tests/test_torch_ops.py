"""``repro_torch.kernels.ops``, ``kernels.ref`` and ``utils.hypofallback``
against the JAX reference.

* ``ops.*`` on CPU tensors (each wrapper's plain version) against the
  reference's ``ops.*`` (Pallas in interpret mode) on the same numpy
  inputs: flash attention in model layout (f32, 2e-5, the tolerance of
  ``tests/test_torch_attention.py``), the chunked SSD scan (1e-5 of the
  output's scale, ``tests/test_torch_ssm.py``'s), the tree fused Adam with
  a bf16 gradient cast to f32 (1e-6, ``tests/test_torch_optim.py``'s), and
  the aggregation passthroughs.
* The five ``ref.*`` oracles against the reference's ``ref.*`` at f32
  tolerance; ``ref.ssd_chunk_ref`` also against the port's chunked form.
* ``hypofallback``: each strategy's drawn examples equal the reference
  shim's, and ``given``/``settings`` run the same examples in both.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.utils import hypofallback as ref_hypo
from repro_torch.kernels import fused_adam, ops, ref, ssd_scan
from repro_torch.utils import hypofallback as hypo

F32 = dict(rtol=2e-5, atol=2e-5)


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def test_ops_exports_and_interpret_flag():
    assert ops.__all__ == ref_ops.__all__
    assert ops.INTERPRET is True
    assert ops.ref is ref
    assert set(ref.__all__) == {n for n, f in vars(ref_ref).items()
                                if n.endswith("_ref") and callable(f)}
    for name in ref.__all__:          # the reference's signatures
        want = inspect.signature(getattr(ref_ref, name)).parameters
        assert list(inspect.signature(getattr(ref, name)).parameters) \
            == list(want)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24),
                                           (False, 0)])
def test_flash_attention_model_layout_matches_reference(causal, window):
    q, k, v = _normal(7, (2, 64, 4, 32), (2, 64, 2, 32), (2, 64, 2, 32))
    got = ops.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              causal=causal, window=window)
    want = ref_ops.flash_attention(*map(jnp.asarray, (q, k, v)),
                                   causal=causal, window=window)
    assert got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def _ssd_inputs(seed, b=2, sl=32, h=3, p=4, n=5):
    x, dt, bb, cc = _normal(seed, (b, sl, h, p), (b, sl, h), (b, sl, n),
                            (b, sl, n))
    dt = np.log1p(np.exp(dt)).astype(np.float32)         # softplus
    a = -np.linspace(1.0, 4.0, h).astype(np.float32)
    return x, dt, a, bb, cc


def test_ssd_chunked_matches_reference_ops():
    x, dt, a, b, c = _ssd_inputs(11)
    launches = ssd_scan.LAUNCHES
    y, s = ops.ssd_chunked(*map(torch.from_numpy, (x, dt, a, b, c)), 8)
    assert ssd_scan.LAUNCHES == launches        # the CPU's plain version
    wy, ws = ref_ops.ssd_chunked(*map(jnp.asarray, (x, dt, a, b, c)), 8)
    for got, want in ((y, wy), (s, ws)):
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale
    with pytest.raises(ValueError):
        ops.ssd_chunked(*map(torch.from_numpy, (x, dt, a, b, c)), 7)


def test_fused_adam_tree_casts_g_like_reference():
    p, m, v, g = _normal(13, (6, 5), (6, 5), (6, 5), (6, 5))
    m, v = m * 1e-2, np.square(v) * 1e-4
    q, gq = _normal(14, (7,), (7,))
    tree = {"w": p, "b": q}
    moms = ({"w": m, "b": np.zeros(7, np.float32)},
            {"w": v, "b": np.zeros(7, np.float32)})
    grads = {"w": g, "b": gq}

    def to_t(d, dt=torch.float32):
        return {k: torch.from_numpy(x).to(dt) for k, x in d.items()}

    g_bf16 = to_t(grads, torch.bfloat16)
    got = ops.fused_adam_tree(to_t(tree), *map(to_t, moms), g_bf16,
                              lr=1e-2, t=3)
    g_f32 = {k: jnp.asarray(x.float().numpy()) for k, x in g_bf16.items()}
    want = ref_ops.fused_adam_tree(
        {k: jnp.asarray(x) for k, x in tree.items()},
        *({k: jnp.asarray(x) for k, x in mo.items()} for mo in moms),
        g_f32, lr=1e-2, t=3)
    for got_t, want_t in zip(got, want):
        for k in tree:
            np.testing.assert_allclose(got_t[k].numpy(),
                                       np.asarray(want_t[k]), rtol=1e-6,
                                       atol=1e-7)
    # the port's own tree function reads g in its own dtype: not the same
    own = fused_adam.fused_adam_tree(to_t(tree), *map(to_t, moms), g_bf16,
                                     lr=1e-2, t=3)
    assert own[1]["w"].dtype == torch.float32


def test_aggregation_passthroughs_match_reference():
    p, b0, b1, b2 = _normal(17, (4, 3), (4, 3), (4, 3), (4, 3))
    mask = np.array([1.0, 0.0, 1.0], np.float32)
    bufs = np.stack([b0, b1, b2])
    got = ops.stale_aggregate_tree({"w": torch.from_numpy(p)},
                                   {"w": torch.from_numpy(bufs)},
                                   torch.from_numpy(mask), beta=0.3)
    want = ref_ops.stale_aggregate_tree({"w": jnp.asarray(p)},
                                        {"w": jnp.asarray(bufs)},
                                        jnp.asarray(mask), beta=0.3)
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               **F32)
    got = ops.masked_aggregate_tree({"w": torch.from_numpy(bufs)},
                                    torch.from_numpy(mask))
    want = ref_ops.masked_aggregate_tree({"w": jnp.asarray(bufs)},
                                         jnp.asarray(mask))
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]),
                               **F32)
    flat = ops.stale_aggregate_flat(torch.from_numpy(p.reshape(-1)),
                                    torch.from_numpy(bufs.reshape(3, -1)),
                                    torch.from_numpy(mask), beta=0.3)
    want = ref_ops.stale_aggregate_flat(
        jnp.asarray(p.reshape(-1)), jnp.asarray(bufs.reshape(3, -1)),
        jnp.asarray(mask), beta=0.3, interpret=True)
    np.testing.assert_allclose(flat.numpy(), np.asarray(want), **F32)


def test_ref_oracles_match_reference():
    q, k, v = _normal(19, (1, 4, 16, 8), (1, 2, 16, 8), (1, 2, 16, 8))
    np.testing.assert_allclose(
        ref.attention_ref(*map(torch.from_numpy, (q, k, v)), window=5)
        .numpy(), np.asarray(ref_ref.attention_ref(
            *map(jnp.asarray, (q, k, v)), window=5)), **F32)
    dq, dk, dv = _normal(20, (2, 4, 8), (2, 2, 12, 8), (2, 2, 12, 8))
    pos = np.tile(np.arange(12, dtype=np.int32) - 2, (2, 1))
    q_pos = np.array([5, 9], np.int32)
    np.testing.assert_allclose(
        ref.decode_attention_ref(*map(torch.from_numpy,
                                      (dq, dk, dv, pos, q_pos))).numpy(),
        np.asarray(ref_ref.decode_attention_ref(
            *map(jnp.asarray, (dq, dk, dv, pos, q_pos)))), **F32)
    x, dt, a, b, c = _ssd_inputs(21, sl=8)
    got = ref.ssd_chunk_ref(*map(torch.from_numpy, (x, dt, a, b, c)))
    want = ref_ref.ssd_chunk_ref(*map(jnp.asarray, (x, dt, a, b, c)))
    chunked = ssd_scan.ssd_chunk_plain(
        *(torch.from_numpy(t)[:, None] if t.ndim > 1 else torch.from_numpy(t)
          for t in (x, dt, a, b, c)))
    for g, w, ch in zip(got, want, (chunked[0][:, 0], chunked[1][:, 0],
                                    chunked[2][:, 0])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)
        np.testing.assert_allclose(g.numpy(), ch.numpy(), **F32)
    p, m, v, g = _normal(22, (9,), (9,), (9,), (9,))
    v = np.square(v)
    kw = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, t=4)
    for got_t, want_t in zip(ref.adam_ref(*map(torch.from_numpy,
                                               (p, m, v, g)), **kw),
                             ref_ref.adam_ref(*map(jnp.asarray,
                                                   (p, m, v, g)), **kw)):
        np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t),
                                   rtol=1e-6, atol=1e-7)
    bufs = np.stack(_normal(23, (3, 4), (3, 4)))
    mask = np.array([1.0, 1.0], np.float32)
    np.testing.assert_allclose(
        ref.stale_aggregate_ref(torch.from_numpy(p[:4].reshape(1, 4)
                                                 .repeat(3, 0)),
                                torch.from_numpy(bufs),
                                torch.from_numpy(mask), beta=0.5).numpy(),
        np.asarray(ref_ref.stale_aggregate_ref(
            jnp.asarray(p[:4].reshape(1, 4).repeat(3, 0)),
            jnp.asarray(bufs), jnp.asarray(mask), beta=0.5)), **F32)


# ----------------------------------------------------------------------
# hypofallback: the same draws as the reference's shim
# ----------------------------------------------------------------------
def _strategies(st):
    @st.composite
    def pair(draw, hi):
        a = draw(st.integers(0, hi))
        return a, draw(st.floats(0.0, float(a) + 1.0))

    return {
        "integers": st.integers(-5, 17),
        "floats": st.floats(-2.5, 3.0),
        "booleans": st.booleans(),
        "sampled_from": st.sampled_from(["a", "b", "c", "d"]),
        "lists": st.lists(st.integers(0, 9), min_size=1, max_size=6),
        "composite": pair(12),
        "map": st.integers(0, 50).map(lambda x: x * 3),
        "filter": st.integers(0, 50).filter(lambda x: x % 4 == 1),
    }


@pytest.mark.parametrize("name", sorted(_strategies(hypo.strategies)))
def test_hypofallback_draws_match_reference(name):
    ours = _strategies(hypo.strategies)[name]
    theirs = _strategies(ref_hypo.strategies)[name]
    rng_a, rng_b = np.random.default_rng(5), np.random.default_rng(5)
    got = [ours.example(rng_a) for _ in range(40)]
    want = [theirs.example(rng_b) for _ in range(40)]
    assert got == want
    assert rng_a.bit_generator.state == rng_b.bit_generator.state


def test_hypofallback_given_runs_the_reference_examples():
    assert hypo.__all__ == ref_hypo.__all__
    seen = {}
    for mod in (hypo, ref_hypo):
        out = seen.setdefault(mod.__name__, [])
        st = mod.strategies

        @mod.settings(max_examples=7, deadline=None,
                      suppress_health_check=[mod.HealthCheck.too_slow])
        @mod.given(st.integers(0, 100), x=st.floats(0.0, 1.0))
        def prop(n, x):
            out.append((n, x))

        prop()
    assert len(seen["repro_torch.utils.hypofallback"]) == 7
    assert seen["repro_torch.utils.hypofallback"] == \
        seen["repro.utils.hypofallback"]
