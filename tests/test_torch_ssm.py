"""The port's Mamba-2 (models/ssm.py) and SSD chunk kernel vs the JAX
reference.

* ``ssd_chunk_plain`` (the CUDA kernel's plain version, which a CPU tensor
  takes) vs ``ssd_chunk_pallas`` in interpret mode at the three shapes of
  ``tests/test_kernels.py``: y and states at rtol/atol 2e-4, the decays at
  rtol 1e-5 / atol 1e-6, as the reference's own test holds them;
* the port's ``kernels/ssd_scan.ssd_chunked`` vs ``ops.ssd_chunked`` and
  ``models.ssm.ssd_chunked`` (B 2, L 128, H 3, P 8, N 16, chunk 32) at atol
  2e-4, and at an L that is not a multiple of the chunk vs
  ``models.ssm.ssd_chunked`` (which pads; ``ops.ssd_chunked`` asserts);
* reduced mamba2 in float32 from the reference's own params (``model.init``
  under ``jax.threefry_partitionable(False)``, carried across as numpy):
  ``forward`` logits and ``loss`` under ``attn_impl`` "xla" and "pallas",
  ``prefill`` logits and cache, then 5 ``decode_step``s, all at 2e-4;
* the full-width layout on the meta device vs ``jax.eval_shape`` of the
  reference's init: 12 leaves, 419,825,152 parameters;
* ``launch.serve`` serves reduced mamba2 on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels import ops as ref_ops
from repro.kernels.ssd_scan import ssd_chunk_pallas
from repro.models import build_model as ref_build_model
from repro.models import ssm as ref_ssm
from repro_torch.configs import get_config
from repro_torch.kernels import ssd_scan
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import ssm
from repro_torch.utils.tree import from_numpy_tree, tree_leaves, tree_paths

TOL = dict(rtol=2e-4, atol=2e-4)
MAMBA2_370M_PARAMS = 419_825_152

SSD_SHAPES = [
    (1, 2, 32, 2, 8, 16),
    (2, 3, 64, 4, 16, 8),
    (1, 1, 16, 1, 4, 4),
]


def _softplus(x):
    return np.logaddexp(x, 0.0).astype(np.float32)


def _ssd_inputs(rng, lead, h, p, n):
    """x, dt (> 0), a (< 0), b, c as float32 numpy, made from ``rng``."""
    x = rng.normal(size=lead + (h, p)).astype(np.float32)
    dt = _softplus(rng.normal(size=lead + (h,)).astype(np.float32))
    a = (-np.exp(rng.normal(size=(h,)) * 0.5)).astype(np.float32)
    b = rng.normal(size=lead + (n,)).astype(np.float32)
    c = rng.normal(size=lead + (n,)).astype(np.float32)
    return x, dt, a, b, c


@pytest.mark.parametrize("b,nc,q,h,p,n", SSD_SHAPES)
def test_ssd_chunk_plain_matches_pallas_kernel(b, nc, q, h, p, n):
    args = _ssd_inputs(np.random.default_rng(q + h), (b, nc, q), h, p, n)
    want = ssd_chunk_pallas(*(jnp.asarray(t) for t in args), interpret=True)
    before = ssd_scan.LAUNCHES
    got = ssd_scan.ssd_chunk(*(torch.from_numpy(t) for t in args))
    assert ssd_scan.LAUNCHES == before      # the CPU takes the plain version
    names = ("y_intra", "states", "chunk_decay", "in_decay")
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == w.shape, name
        tol = TOL if name in ("y_intra", "states") else dict(rtol=1e-5,
                                                              atol=1e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol,
                                   err_msg=name)


def test_ssd_chunked_matches_ops_and_model_implementation():
    bs, sl, h, p, n = 2, 128, 3, 8, 16
    args = _ssd_inputs(np.random.default_rng(7), (bs, sl), h, p, n)
    y1, s1 = ref_ssm.ssd_chunked(*(jnp.asarray(t) for t in args), 32)
    y2, s2 = ref_ops.ssd_chunked(*(jnp.asarray(t) for t in args), 32)
    targs = [torch.from_numpy(t) for t in args]
    got_y, got_s = ssd_scan.ssd_chunked(*targs, 32)
    plain_y, plain_s = ssm.ssd_chunked(*targs, 32)
    for y, s in ((y1, s1), (y2, s2)):
        np.testing.assert_allclose(got_y.numpy(), np.asarray(y), atol=2e-4)
        np.testing.assert_allclose(got_s.numpy(), np.asarray(s), atol=2e-4)
        np.testing.assert_allclose(plain_y.numpy(), np.asarray(y), atol=2e-4)
        np.testing.assert_allclose(plain_s.numpy(), np.asarray(s), atol=2e-4)


def test_ssd_chunked_pads_a_ragged_length_like_the_model():
    bs, sl, h, p, n = 2, 77, 3, 8, 16
    args = _ssd_inputs(np.random.default_rng(8), (bs, sl), h, p, n)
    s0 = np.random.default_rng(9).normal(size=(bs, h, p, n)) \
        .astype(np.float32)
    want_y, want_s = ref_ssm.ssd_chunked(*(jnp.asarray(t) for t in args), 32,
                                         jnp.asarray(s0))
    targs = [torch.from_numpy(t) for t in args]
    for fn in (ssd_scan.ssd_chunked, ssm.ssd_chunked):
        y, s = fn(*targs, 32, torch.from_numpy(s0))
        assert tuple(y.shape) == (bs, sl, h, p)
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=2e-4)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), atol=2e-4)


def test_ssd_step_matches_reference():
    rng = np.random.default_rng(3)
    bs, h, p, n = 2, 3, 4, 5
    state = rng.normal(size=(bs, h, p, n)).astype(np.float32)
    x, dt, a, b, c = _ssd_inputs(rng, (bs,), h, p, n)
    want = ref_ssm.ssd_step(*(jnp.asarray(t) for t in (state, x, dt, a, b,
                                                       c)))
    got = ssm.ssd_step(*(torch.from_numpy(t) for t in (state, x, dt, a, b,
                                                       c)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def _carried(seed=0, **kw):
    ref_cfg = dataclasses.replace(ref_get_config("mamba2_370m").reduced(),
                                  dtype="float32", **kw)
    port_cfg = dataclasses.replace(get_config("mamba2_370m").reduced(),
                                   dtype="float32", **kw)
    assert dataclasses.asdict(ref_cfg) == dataclasses.asdict(port_cfg)
    ref = ref_build_model(ref_cfg)
    with jax.threefry_partitionable(False):
        params = jax.tree.map(np.asarray,
                              jax.jit(ref.init)(jax.random.PRNGKey(seed)))
    return ref, build_model(port_cfg), params


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=shape) \
        .astype(np.int32)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_and_loss_match_reference(impl):
    ref, port, params = _carried(attn_impl=impl)
    # 71 tokens: two full chunks of 32 and a padded third
    toks = _tokens((2, 72), ref.cfg.vocab_size, seed=1)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    tparams = from_numpy_tree(params, "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    want, _, _ = jax.jit(ref.forward)(params, batch["tokens"])
    before = ssd_scan.LAUNCHES
    logits, cache, aux = port.forward(tparams, tbatch["tokens"])
    assert cache is None and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(port.predict(tparams, tbatch).numpy(),
                               np.asarray(want), **TOL)
    loss, aux = port.loss(tparams, tbatch)
    assert ssd_scan.LAUNCHES == before      # the CPU takes the plain version
    want_loss, want_aux = jax.jit(ref.loss)(params, batch)
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    assert sorted(aux) == sorted(want_aux)


def test_kernel_route_has_no_backward():
    """A CUDA tensor's route is the kernel, which has no backward (neither
    has the reference kernel); it raises rather than differentiate the
    plain version."""
    with pytest.raises(NotImplementedError, match="attn_impl='xla'"):
        ssd_scan._SSDChunk.backward(None, torch.zeros(1))


def test_prefill_and_decode_match_reference():
    ref, port, params = _carried(seed=1)
    tparams = from_numpy_tree(params, "cpu")
    prompt = 40
    toks = _tokens((2, prompt + 5), ref.cfg.vocab_size, seed=4)
    want, want_cache = jax.jit(lambda p, t: ref.prefill(p, t, 0))(
        params, toks[:, :prompt])
    got, cache = port.prefill(tparams, torch.from_numpy(toks[:, :prompt]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    empty = port.init_cache(2, device="cpu")
    for name in ("conv", "state"):
        assert empty[name].shape == cache[name].shape == \
            ref.init_cache(2)[name].shape
        assert float(empty[name].abs().max()) == 0.0
        assert cache[name].dtype == torch.float32
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(want_cache[name]), **TOL)
    ref_decode = jax.jit(ref.decode_step)
    for i in range(5):
        pos = prompt + i
        step = toks[:, pos:pos + 1]
        want, want_cache = ref_decode(params, want_cache, step,
                                      jnp.int32(pos))
        got, cache = port.decode_step(tparams, cache, torch.from_numpy(step),
                                      pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(cache["state"].numpy(),
                                   np.asarray(want_cache["state"]), **TOL)


def test_full_width_layout_matches_reference():
    ref = ref_build_model(ref_get_config("mamba2_370m"))
    want = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
    mine = build_model(get_config("mamba2_370m")).init(None, device="meta")
    want_leaves = jax.tree.leaves(want)
    assert len(tree_leaves(mine)) == len(want_leaves) == 12
    for got, w in zip(tree_leaves(mine), want_leaves):
        assert tuple(got.shape) == w.shape
        assert str(got.dtype).removeprefix("torch.") == str(w.dtype)
    assert tree_paths(mine) == tree_paths(want)
    assert sum(x.numel() for x in tree_leaves(mine)) == MAMBA2_370M_PARAMS


def test_serve_entry_point_runs_reduced_mamba2_on_cpu():
    res = serve.run(["--arch", "mamba2_370m", "--batch", "2",
                     "--prompt-len", "40", "--gen", "4", "--device", "cpu"])
    assert tuple(res.tokens.shape) == (2, 4)
    assert res.cache["state"].shape[0] == res.cfg.num_layers
    assert bool(((res.tokens >= 0) & (res.tokens < res.cfg.vocab_size))
                .all())
