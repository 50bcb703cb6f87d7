"""The port's audio family (MusicGen-Large's multi-codebook decoder) vs the
JAX reference.

Float32 at the reference's own 2e-4, with the reference's params carried
across as numpy (``tests/test_torch_moe.py``'s helpers); tokens are [B, L,
K], one per codebook, logits [B, L, K, V].

* the codebook embedding sum in bf16, bitwise: the reference adds the K
  embeddings one after another, rounding to bf16 after each add, and a
  sum over K in float32 would round once (it differs here, and is shown
  to);
* reduced ``forward``, ``predict`` and ``loss`` (with a mask over [B,
  L], which the loss spreads over the codebooks) under
  ``attn_impl`` "xla" and "pallas" (the reference's flash kernel in
  interpret mode, the port's plain version);
* prefill and a ring-wrapping decode against the reference, and against
  the port's own full forward;
* full-width param and cache layouts on ``meta`` (3,254,978,560
  parameters); serve (prompts and tokens [B, L, K]) and ``launch.train
  --mode scale`` on the CPU.
"""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve, train
from repro_torch.utils.tree import from_numpy_tree
from test_torch_moe import (TOL, carried, hold_full_width_layout,
                            hold_prefill_and_decode, run_serve, tokens)

ARCH = "musicgen_large"
MUSICGEN_PARAMS = 3_254_978_560


@functools.lru_cache(maxsize=None)
def models(impl="xla"):
    """(reference, port, the reference's params as numpy, its jitted
    (predict, loss)), built once per ``attn_impl`` for the file."""
    ref, port, params = carried(ARCH, seed=0, attn_impl=impl)
    return ref, port, params, jax.jit(
        lambda p, b: (ref.predict(p, b), ref.loss(p, b)))


def test_codebook_embedding_sum_is_bitwise_in_bf16():
    ref, port, _, _ = models()
    k, v, d = port.k_cb, port.cfg.vocab_size, port.cfg.d_model
    rng = np.random.default_rng(1)
    emb = rng.normal(size=(k, v, d)).astype(ml_dtypes.bfloat16)
    toks = tokens((2, 33, k), v, seed=2)
    want = np.asarray(jax.jit(ref._embed)(
        {"embedding": {"tok_embed": jnp.asarray(emb)}}, toks))
    assert want.dtype == ml_dtypes.bfloat16
    tparams = from_numpy_tree({"embedding": {"tok_embed": emb}}, "cpu")
    got = port._embed(tparams, torch.from_numpy(toks))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  want.view(np.int16))
    # one rounding at the end of an f32 sum is another result
    table = tparams["embedding"]["tok_embed"]
    once = sum(table[i][torch.from_numpy(toks[..., i]).long()].float()
               for i in range(k)).to(torch.bfloat16)
    assert not torch.equal(once, got)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_and_loss_match_reference(impl):
    ref, port, params, scores = models(impl)
    toks = tokens((2, 65, port.k_cb), ref.cfg.vocab_size, seed=5)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:],
             "mask": (np.random.default_rng(6).random((2, 64)) < 0.7)
             .astype(np.float32)}
    tparams = from_numpy_tree(params, "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    before = fa.LAUNCHES
    got = port.predict(tparams, tbatch)
    assert tuple(got.shape) == (2, 64, port.k_cb, ref.cfg.vocab_size)
    want, (want_loss, want_metrics) = scores(params, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    loss, metrics = port.loss(tparams, tbatch)
    assert fa.LAUNCHES == before            # the CPU takes the plain version
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    np.testing.assert_allclose(float(metrics["ce"]),
                               float(want_metrics["ce"]), **TOL)
    logits, cache, aux = port.forward(tparams, tbatch["tokens"])
    assert cache is None and float(aux) == 0.0 and torch.equal(logits, got)


def test_prefill_and_ring_decode_match_reference():
    """40 prompt tokens into a 32-slot ring (the prefill drops 8 writes),
    then 6 steps that wrap it, against the reference; then the port alone
    with a cache that holds every token, against its own full forward
    (teacher forcing, as ``tests/test_decode_consistency.py``)."""
    ref, port, params, _ = models()
    prompt, cache_len, n_dec = 40, 32, 6
    toks = tokens((2, prompt + n_dec, port.k_cb), ref.cfg.vocab_size,
                  seed=prompt)
    hold_prefill_and_decode(ref, port, params, toks, prompt, cache_len,
                            n_dec=n_dec)
    assert prompt + n_dec > cache_len + 1     # the ring wrapped

    tparams = from_numpy_tree(params, "cpu")
    toks = torch.from_numpy(toks)
    logits, cache = port.prefill(tparams, toks[:, :prompt], 64)
    assert tuple(logits.shape) == (2, 1, port.k_cb, ref.cfg.vocab_size)
    steps = [logits]
    for pos in range(prompt, prompt + n_dec - 1):
        logits, cache = port.decode_step(tparams, cache,
                                         toks[:, pos:pos + 1], pos)
        steps.append(logits)
    full = port.predict(tparams, {"tokens": toks[:, :-1]})
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(),
                               full[:, prompt - 1:].numpy(), **TOL)


def test_full_width_layout_matches_reference():
    hold_full_width_layout(ARCH, MUSICGEN_PARAMS)


def test_serve_entry_runs_on_the_cpu(capsys):
    res = run_serve(ARCH, capsys)
    again = serve.run(["--arch", ARCH, "--batch", "2", "--prompt-len", "12",
                       "--gen", "3", "--cache-len", "16", "--device", "cpu",
                       "--personalize", "--dtype", "float32"])
    assert "personalized" in capsys.readouterr().out
    assert again.logits.dtype == torch.float32
    assert again.tokens.shape[:2] == (2, 3)
    k, v = res.cfg.num_audio_codebooks, res.cfg.vocab_size
    assert tuple(res.prompts.shape) == (2, 12, k)
    assert tuple(res.logits.shape) == (2, 5, k, v)
    assert torch.equal(res.tokens, res.logits.argmax(-1).to(torch.int32))


def test_train_scale_runs_on_the_cpu(capsys):
    state, metrics = train.run(["--mode", "scale", "--arch", ARCH,
                                "--reduce", "--steps", "2", "--device",
                                "cpu"])
    assert np.isfinite(float(metrics["loss"]))
    assert tuple(state.params["embedding"]["lm_head"].shape) == \
        (4, 256, 512)
    assert "step    1 loss=" in capsys.readouterr().out
