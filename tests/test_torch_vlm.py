"""The port's vlm family (Llama-3.2-11B-Vision's gated cross-attention
decoder) vs the JAX reference.

Float32 throughout, at the reference's own 2e-4, with the reference's
params carried across as numpy (``tests/test_torch_moe.py``'s helpers).
The reduced config has 4 layers here (2 groups of 2 self layers and one
cross layer each), so the interleave's order is held.  A cross layer's
gate is zero at init, and ``tanh(0) * out`` hides any fault in the
cross-attention, so every parity case sets the gates to nonzero values
drawn from a seeded generator, in the params both packages get; a planted
fault (RoPE on the cross queries, or a causal mask on the cross scores)
must fail the parity check with them and pass it with the gates at zero.

* ``attention_apply`` with ``kv_input`` (GQA, one block and the chunked
  path over ``SDPA_CHUNK`` queries); ``stub_image_embeds``;
* reduced ``forward``, ``predict`` and ``loss`` under ``attn_impl`` "xla"
  (image embeddings given, and stubbed) and "pallas" (stubbed; the
  reference's flash kernel in interpret mode, the port's plain version);
* with the gates at zero, a cross layer returns x bitwise and the model
  is the dense transformer over the same self layers, bitwise;
* prefill and a ring-wrapping decode against the reference, and against
  the port's own full forward;
* full-width param and cache layouts on ``meta`` (10,110,734,344
  parameters); serve and ``launch.train --mode scale`` on the CPU.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro.models import layers as RL
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve, train
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.utils.tree import from_numpy_tree, tree_map
from test_torch_moe import (TOL, carried, cfgs, hold_full_width_layout,
                            hold_prefill_and_decode, run_serve, tokens)

ARCH = "llama32_vision_11b"
VISION_PARAMS = 10_110_734_344


@functools.lru_cache(maxsize=None)
def models(impl="xla"):
    """(reference, port, the reference's jitted (predict, loss)) at 4
    layers (2 groups), built once per ``attn_impl`` for the file."""
    ref_cfg, port_cfg = cfgs(ARCH, num_layers=4, attn_impl=impl)
    ref = ref_build_model(ref_cfg)
    return ref, build_model(port_cfg), jax.jit(
        lambda p, b: (ref.predict(p, b), ref.loss(p, b)))


@functools.lru_cache(maxsize=None)
def _gated_params():
    _, port, params = carried(ARCH, seed=0, num_layers=4)
    assert port.n_cross == 2
    gate = params["cross_layers"]["gate_cross"]
    assert not gate.any()
    params["cross_layers"]["gate_cross"] = np.random.default_rng(
        100).uniform(0.5, 1.5, size=gate.shape).astype(gate.dtype)
    return params


def gated():
    """A copy of the reference's params at 4 layers, the cross layers'
    gates drawn nonzero; both packages get these."""
    return jax.tree.map(np.copy, _gated_params())


def _batch(vocab, seed=5):
    toks = tokens((2, 65), vocab, seed=seed)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _image(cfg, b, seed):
    return (np.random.default_rng(seed).normal(
        size=(b, cfg.num_image_tokens, cfg.d_model)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("lq", [9, L.SDPA_CHUNK + 76],
                         ids=["one-block", "chunked"])
def test_cross_attention_apply_matches_reference(lq):
    ref_cfg, port_cfg = cfgs(ARCH, num_kv_heads=2)          # GQA group 2
    with jax.threefry_partitionable(False):
        params = jax.tree.map(np.asarray, RL.attention_init(
            jax.random.PRNGKey(1), ref_cfg, cross=True))
    rng = np.random.default_rng(lq)
    x = rng.normal(size=(2, lq, ref_cfg.d_model)).astype(np.float32)
    kv = rng.normal(size=(2, 16, ref_cfg.d_model)).astype(np.float32)
    pos = np.zeros((1,), np.int32)
    want, _ = RL.attention_apply(params, jnp.asarray(x), cfg=ref_cfg,
                                 positions=jnp.asarray(pos),
                                 kv_input=jnp.asarray(kv), causal=False)
    got, cache = L.attention_apply(
        from_numpy_tree(params, "cpu"), torch.from_numpy(x), cfg=port_cfg,
        positions=torch.from_numpy(pos), kv_input=torch.from_numpy(kv),
        causal=False)
    assert cache is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stub_image_embeds_matches_reference(dtype):
    """At full width (1,601 x 4,096): the sin of the same float32
    arguments, within 2 float32 ulps of the values' scale (0.02) in
    float32 (the two packages' sin differ in the last bit); in bf16
    bitwise but for the few values that such a bit moves across a rounding
    edge, one bf16 ulp (2^-7 relative at most) away."""
    ref = ref_build_model(ref_get_config(ARCH))
    port = build_model(get_config(ARCH))
    want = np.asarray(ref.stub_image_embeds(2, jnp.dtype(dtype)))
    got = port.stub_image_embeds(2, getattr(torch, dtype), device="cpu")
    assert tuple(got.shape) == want.shape == (2, 1601, 4096)
    got = got.float().numpy()
    want = want.astype(np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * 2.0 ** -29)
    else:
        assert (got != want).mean() < 1e-4
        np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)


@pytest.mark.parametrize("impl,image", [("xla", "given"), ("xla", "stub"),
                                        ("pallas", "stub")])
def test_forward_and_loss_match_reference(impl, image):
    ref, port, scores = models(impl)
    params = gated()
    batch = _batch(ref.cfg.vocab_size)
    if image == "given":
        batch["image_embeds"] = _image(ref.cfg, 2, seed=6)
    tparams = from_numpy_tree(params, "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    before = fa.LAUNCHES
    got = port.predict(tparams, tbatch)
    want, (want_loss, _) = scores(params, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    loss, metrics = port.loss(tparams, tbatch)
    assert fa.LAUNCHES == before            # the CPU takes the plain version
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    assert float(metrics["aux"]) == 0.0
    if image == "given":
        logits, cache, _ = port.forward(tparams, tbatch["tokens"],
                                        image_embeds=tbatch["image_embeds"])
        assert cache is None and torch.equal(logits, got)


def _cross_fault(kind):
    """Wraps ``L.sdpa`` so that the cross-attention calls (the ones without
    a causal mask) get RoPE on their queries at the token positions, or a
    causal mask by index over the image tokens."""
    sdpa = L.sdpa

    def faulty(q, k, v, *, q_pos, k_pos, causal, window, **kw):
        if not causal:
            b, lq, lk = q.shape[0], q.shape[1], k.shape[1]
            rows = torch.arange(lq, dtype=torch.int32).expand(b, lq)
            if kind == "rope":
                q = L.apply_rope(q, rows, 5e5)
            else:
                q_pos = rows
                k_pos = torch.arange(lk, dtype=torch.int32).expand(b, lk)
                causal = True
        return sdpa(q, k, v, q_pos=q_pos, k_pos=k_pos, causal=causal,
                    window=window, **kw)
    return faulty


@pytest.mark.parametrize("kind", ["rope", "causal"])
def test_planted_cross_fault_is_caught_with_nonzero_gates(kind,
                                                          monkeypatch):
    ref, port, scores = models()
    params = gated()
    batch = _batch(ref.cfg.vocab_size, seed=7)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = np.asarray(scores(params, batch)[0])
    monkeypatch.setattr(L, "sdpa", _cross_fault(kind))
    got = port.predict(from_numpy_tree(params, "cpu"), tbatch).numpy()
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(got, want, **TOL)

    # with the gates at zero the same fault passes unseen
    params["cross_layers"]["gate_cross"][:] = 0
    want = np.asarray(scores(params, batch)[0])
    got = port.predict(from_numpy_tree(params, "cpu"), tbatch).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_zero_gates_make_cross_layers_the_identity_bitwise():
    _, port, _ = models()
    params = gated()
    params["cross_layers"]["gate_cross"][:] = 0
    tparams = from_numpy_tree(params, "cpu")
    toks = torch.from_numpy(tokens((2, 24), port.cfg.vocab_size, seed=8))
    x = torch.randn(2, 24, port.cfg.d_model,
                    generator=torch.Generator().manual_seed(0))
    img = port.stub_image_embeds(2, device="cpu")
    cp = tree_map(lambda a: a[1], tparams["cross_layers"])
    assert float(cp["gate_cross"]) == 0.0
    assert torch.equal(port._cross_apply(cp, x, img), x)

    dense = build_model(dataclasses.replace(port.cfg, family="dense",
                                            cross_attn_every=0))
    self_only = {k: v for k, v in tparams.items() if k != "cross_layers"}
    want, _, _ = dense.forward(self_only, toks)
    got, _, _ = port.forward(tparams, toks, image_embeds=img)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="image_embeds"):
        port.forward(tparams, toks)


def test_prefill_and_ring_decode_match_reference():
    """40 prompt tokens into a 32-slot ring (the prefill drops 8 writes),
    then 6 steps that wrap it, against the reference; then the port alone
    with a cache that holds every token, against its own full forward
    (teacher forcing, as ``tests/test_decode_consistency.py``)."""
    ref, port, _ = models()
    params = gated()
    prompt, cache_len, n_dec = 40, 32, 6
    toks = tokens((2, prompt + n_dec), ref.cfg.vocab_size, seed=prompt)
    hold_prefill_and_decode(ref, port, params, toks, prompt, cache_len,
                            n_dec=n_dec)
    assert prompt + n_dec > cache_len + 1     # the ring wrapped

    tparams = from_numpy_tree(params, "cpu")
    toks = torch.from_numpy(toks)
    logits, cache = port.prefill(tparams, toks[:, :prompt], 64)
    steps = [logits]
    for pos in range(prompt, prompt + n_dec - 1):
        logits, cache = port.decode_step(tparams, cache,
                                         toks[:, pos:pos + 1], pos)
        steps.append(logits)
    full = port.predict(tparams, {"tokens": toks[:, :-1]})
    np.testing.assert_allclose(torch.cat(steps, 1).numpy(),
                               full[:, prompt - 1:].numpy(), **TOL)


def test_full_width_layout_matches_reference():
    hold_full_width_layout(ARCH, VISION_PARAMS)


def test_serve_entry_runs_on_the_cpu(capsys):
    run_serve(ARCH, capsys)
    again = serve.run(["--arch", ARCH, "--batch", "2", "--prompt-len", "12",
                       "--gen", "3", "--cache-len", "16", "--device", "cpu",
                       "--personalize", "--dtype", "float32"])
    assert "personalized" in capsys.readouterr().out
    assert again.logits.dtype == torch.float32
    assert "cross_layers" in again.params and again.tokens.shape == (2, 3)


def test_train_scale_runs_on_the_cpu(capsys):
    state, metrics = train.run(["--mode", "scale", "--arch", ARCH,
                                "--reduce", "--steps", "2", "--device",
                                "cpu"])
    assert np.isfinite(float(metrics["loss"]))
    assert "cross_layers" in state.params
    assert "step    1 loss=" in capsys.readouterr().out
