"""The port's RecurrentGemma hybrid (RG-LRU + local attention) vs the JAX
reference.

Reduced recurrentgemma_2b in float32 with 8 layers (two (rec, rec, attn)
groups and two tail recurrent layers, as the full model's 26 = 8 x 3 + 2),
an attention window of 64 and MQA (4 query heads, 1 kv head).  The JAX
package's params (``model.init`` under ``jax.threefry_partitionable(False)``,
as the slice-1 harness pins) are carried across as numpy through
``utils.tree.from_numpy_tree``, and both packages see the same numpy
tokens.

* the RG-LRU core: ``rglru_scan`` (with and without ``h0``, at lengths that
  are and are not powers of two) and ``rglru_step`` against the
  reference's at 1e-5 relative (the log-depth scan multiplies the decays
  in another order than ``associative_scan``);
* scoring: ``forward`` logits and ``loss`` under ``attn_impl`` "xla" and
  "pallas" (the reference's flash kernel in interpret mode; the port's
  flash wrapper on the CPU, its plain version) on tokens [2, 96], longer
  than the window, at 2e-4 as in ``tests/test_pallas_model_integration.py``;
* serving: ``prefill`` then stepwise ``decode_step`` against the
  reference's (logits at 2e-4; conv tails, states and the ring's k/v at
  2e-4, its positions exactly), and against the port's own full forward
  (teacher forcing) at the reference's 5e-2 of the logits' scale
  (``tests/test_decode_consistency.py``);
* cache and param layouts at full width on the meta device against
  ``jax.eval_shape`` of the reference's ``init_cache`` and ``init``;
* the serve entry point on the CPU;
* three semi-synchronous rounds (the fused Eq.-8 route) of the reduced
  config (one (rec, rec, attn) group) against the reference's step: the
  RG-LRU scan's and the local attention's gradients and Hessian-vector
  products (``test_torch_semi_sync.hold_semi_sync_rounds``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import hybrid as ref_hybrid
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.models import build_model, hybrid
from repro_torch.utils.tree import from_numpy_tree, tree_leaves, tree_paths
from test_torch_semi_sync import hold_semi_sync_rounds

TOL = dict(rtol=2e-4, atol=2e-4)
SCAN_TOL = dict(rtol=1e-5, atol=1e-6)
N_LAYERS = 8


def _cfgs(**kw):
    ref = dataclasses.replace(ref_get_config("recurrentgemma_2b").reduced(),
                              dtype="float32", num_layers=N_LAYERS, **kw)
    port = dataclasses.replace(get_config("recurrentgemma_2b").reduced(),
                               dtype="float32", num_layers=N_LAYERS, **kw)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    return ref, port


def _carried(seed=0, **kw):
    ref_cfg, port_cfg = _cfgs(**kw)
    ref = ref_build_model(ref_cfg)
    with jax.threefry_partitionable(False):
        params = jax.tree.map(np.asarray,
                              jax.jit(ref.init)(jax.random.PRNGKey(seed)))
    return ref, build_model(port_cfg), params


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=shape) \
        .astype(np.int32)


def _lru_inputs(seed, b, sl, w):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(b, sl, w)).astype(np.float32)
    r = 1 / (1 + np.exp(-rng.normal(size=(b, sl, w))))
    lam = rng.normal(size=w)
    log_a = (-8.0 * np.logaddexp(lam, 0) * r).astype(np.float32)
    gate = (1 / (1 + np.exp(-rng.normal(size=(b, sl, w))))).astype(
        np.float32)
    h0 = rng.normal(size=(b, w)).astype(np.float32)
    return u, log_a, gate, h0


@pytest.mark.parametrize("sl", [1, 37, 64])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero", "h0"])
def test_rglru_scan_matches_reference(sl, with_h0):
    u, log_a, gate, h0 = _lru_inputs(sl, 2, sl, 24)
    h0 = h0 if with_h0 else None
    got, got_last = hybrid.rglru_scan(
        *map(torch.from_numpy, (u, log_a, gate)),
        h0=None if h0 is None else torch.from_numpy(h0))
    want, want_last = ref_hybrid.rglru_scan(
        *map(jnp.asarray, (u, log_a, gate)),
        h0=None if h0 is None else jnp.asarray(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)
    np.testing.assert_allclose(got_last.numpy(), np.asarray(want_last),
                               **SCAN_TOL)
    # the recurrence itself, one step at a time
    h = torch.zeros(2, 24) if h0 is None else torch.from_numpy(h0)
    for t in range(sl):
        h = hybrid.rglru_step(h, *(torch.from_numpy(x[:, t])
                                   for x in (u, log_a, gate)))
    np.testing.assert_allclose(h.numpy(), np.asarray(want_last), **SCAN_TOL)


def test_rglru_step_matches_reference():
    u, log_a, gate, h = _lru_inputs(5, 3, 1, 40)
    got = hybrid.rglru_step(*map(torch.from_numpy,
                                 (h, u[:, 0], log_a[:, 0], gate[:, 0])))
    want = ref_hybrid.rglru_step(*map(jnp.asarray,
                                      (h, u[:, 0], log_a[:, 0], gate[:, 0])))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_and_loss_match_reference(impl):
    ref, port, params = _carried(attn_impl=impl)
    assert (port.n_groups, port.n_tail) == (2, 2)
    toks = _tokens((2, 97), ref.cfg.vocab_size, seed=7)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    tparams = from_numpy_tree(params, "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    logits, cache, aux = port.forward(tparams, tbatch["tokens"])
    want, _, _ = jax.jit(ref.forward)(params, batch["tokens"])
    assert cache is None and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(port.predict(tparams, tbatch).numpy(),
                               np.asarray(want), **TOL)

    before = fa.LAUNCHES
    loss, metrics = port.loss(tparams, tbatch)
    assert fa.LAUNCHES == before            # the CPU takes the plain version
    want_loss, want_metrics = jax.jit(ref.loss)(params, batch)
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    assert sorted(metrics) == sorted(want_metrics)


def test_pallas_scoring_calls_flash_once_per_attention_block():
    _, port, params = _carried(attn_impl="pallas")
    calls = []
    flash = fa.flash_attention

    def recording(q, k, v, *, causal=True, window=0):
        calls.append((tuple(q.shape), tuple(k.shape), causal, window))
        return flash(q, k, v, causal=causal, window=window)

    toks = torch.from_numpy(_tokens((2, 80), 512, seed=1))
    fa.flash_attention = recording
    try:
        port.forward(from_numpy_tree(params, "cpu"), toks)
    finally:
        fa.flash_attention = flash
    assert calls == [((2, 80, 4, 64), (2, 80, 1, 64), True, 64)] * 2


@pytest.mark.parametrize("prompt,cache_len", [(70, 128), (40, 32)],
                         ids=["prefill-past-window", "ring-shorter"])
def test_prefill_and_decode_match_reference(prompt, cache_len):
    ref, port, params = _carried(seed=1)
    tparams = from_numpy_tree(params, "cpu")
    n_dec = 6
    toks = _tokens((2, prompt + n_dec), ref.cfg.vocab_size, seed=prompt)

    ref_prefill = jax.jit(lambda p, t: ref.prefill(p, t, cache_len))
    ref_decode = jax.jit(ref.decode_step)
    want, want_cache = ref_prefill(params, toks[:, :prompt])
    got, cache = port.prefill(tparams, torch.from_numpy(toks[:, :prompt]),
                              cache_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    steps = [got]

    def same_cache():
        for name in ("conv", "h"):
            np.testing.assert_allclose(cache[name].numpy(),
                                       np.asarray(want_cache[name]), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(cache["attn"][name].numpy(),
                                       np.asarray(want_cache["attn"][name]),
                                       **TOL)
        np.testing.assert_array_equal(cache["attn"]["pos"].numpy(),
                                      np.asarray(want_cache["attn"]["pos"]))

    same_cache()
    for i in range(n_dec - 1):
        pos = prompt + i
        step = toks[:, pos:pos + 1]
        want, want_cache = ref_decode(params, want_cache, step,
                                      jnp.int32(pos))
        got, cache = port.decode_step(tparams, cache, torch.from_numpy(step),
                                      pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        steps.append(got)
    same_cache()
    assert int(cache["attn"]["pos"].max()) == prompt + n_dec - 2

    if cache_len >= port.cfg.hybrid.attention_window:
        # teacher forcing: the full forward over the same tokens
        full, _, _ = port.forward(tparams, torch.from_numpy(toks[:, :-1]))
        want = full[:, prompt - 1:]
        err = float((torch.cat(steps, 1) - want).abs().max())
        assert err / (float(want.abs().max()) + 1e-6) < 5e-2


def test_cache_and_params_layout_at_full_width():
    ref = ref_build_model(ref_get_config("recurrentgemma_2b"))
    port = build_model(get_config("recurrentgemma_2b"))
    assert (port.n_groups, port.n_tail) == (8, 2)
    want = jax.eval_shape(lambda: ref.init_cache(4, 4096))
    mine = port.init_cache(4, 4096, device="meta")
    assert tree_paths(mine) == tree_paths(want)
    assert [(tuple(x.shape), str(x.dtype)[6:]) for x in tree_leaves(mine)] \
        == [(tuple(x.shape), str(x.dtype)) for x in tree_leaves(want)]
    assert tuple(mine["attn"]["k"].shape) == (8, 4, 2048, 1, 256)

    want = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
    mine = port.init(None, device="meta")
    assert tree_paths(mine) == tree_paths(want)
    assert [(tuple(x.shape), str(x.dtype)[6:]) for x in tree_leaves(mine)] \
        == [(tuple(x.shape), str(x.dtype)) for x in tree_leaves(want)]
    assert tuple(mine["rec_layers"]["lru_in"].shape) == (8, 2, 2560, 2560)
    assert tuple(mine["tail_layers"]["lru_out"].shape) == (2, 2560, 2560)


def test_stacked_draws_are_independent():
    """Each block of the (group, block) stack gets its own draw."""
    port = build_model(dataclasses.replace(
        get_config("recurrentgemma_2b").reduced(), num_layers=N_LAYERS))
    p = port.init(torch.Generator().manual_seed(0))
    w = p["rec_layers"]["lru_in"]
    assert not torch.equal(w[0, 0], w[0, 1])
    assert not torch.equal(w[0, 1], w[1, 0])
    assert not torch.equal(p["rec_layers"]["conv_w"][0, 0],
                           p["rec_layers"]["conv_w"][0, 1])


def test_serve_entry_runs_on_the_cpu(capsys):
    argv = ["--arch", "recurrentgemma_2b", "--reduce", "--batch", "2",
            "--prompt-len", "12", "--gen", "5", "--cache-len", "16",
            "--device", "cpu"]
    assert serve.main(argv) == 0
    assert "sample tokens:" in capsys.readouterr().out
    res = serve.run(argv)
    assert res.tokens.shape == (2, 5)
    assert tuple(res.logits.shape) == (2, 5, res.cfg.vocab_size)
    assert torch.equal(res.tokens, torch.argmax(res.logits, -1).int())
    assert int(res.cache["attn"]["pos"].max()) == 12 + 5 - 2
    assert res.cache["h"].device.type == "cpu"


def test_serve_entry_in_float32_matches_teacher_forcing():
    """``--dtype float32`` serves the same seed's params unrounded; with
    the state kept in f32 between steps, decode through a wrapped ring
    matches the full forward over prompt + generated tokens at 1e-4 of
    each token row."""
    argv = ["--arch", "recurrentgemma_2b", "--reduce", "--batch", "2",
            "--prompt-len", "70", "--gen", "5", "--cache-len", "128",
            "--device", "cpu"]
    res = serve.run(argv + ["--dtype", "float32"])
    bf16 = serve.run(argv)
    assert res.cfg.dtype == "float32"
    emb = res.params["embedding"]["tok_embed"]
    assert emb.dtype == res.cache["h"].dtype == torch.float32
    assert torch.equal(emb.to(torch.bfloat16),
                       bf16.params["embedding"]["tok_embed"])
    assert res.cache["attn"]["k"].shape[2] == 64    # the window's ring
    toks = torch.cat([res.prompts, res.tokens[:, :-1]], dim=1)
    with torch.inference_mode():
        want = build_model(res.cfg).forward(res.params, toks)[0][:, 69:]
    rel = (res.logits - want).norm(dim=-1) / want.norm(dim=-1)
    assert float(rel.max()) < 1e-4


def test_semi_sync_rounds_match_reference():
    """The fused Eq.-8 route (β-SGD, no clipping)."""
    _, state = hold_semi_sync_rounds("recurrentgemma_2b", 0.0)
    # every leaf's gradient reached cohort 2's buffer row (refreshed last)
    assert all(bool(x[2].any()) for x in tree_leaves(state.buffers))
