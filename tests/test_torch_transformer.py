"""The port's dense transformer (yi-6b) vs the JAX reference.

Reduced yi_6b in float32 with GQA (2 kv heads) and MQA (1 kv head) — the
reduced config alone keeps 4 kv heads for 4 query heads, so the group
broadcast would go untested.  The JAX package's params (``model.init``
under ``jax.threefry_partitionable(False)``, as the slice-1 harness pins)
are carried across as numpy through ``utils.tree.from_numpy_tree``, and
both packages see the same numpy tokens.

* scoring: ``forward`` logits and ``loss`` under ``attn_impl`` "xla" and
  "pallas" (the reference's flash kernel in interpret mode; the port's
  flash wrapper on the CPU) on tokens [2, 96], at 2e-4 as in
  ``tests/test_pallas_model_integration.py``;
* serving: ``prefill`` logits and the filled ring cache, then 6
  ``decode_step``s with a cache shorter than prompt plus generation, so the
  ring drops and wraps; logits at 2e-4, cache positions exactly equal;
* full width without allocating: the port's param paths and shapes on the
  meta device equal ``jax.eval_shape`` of the reference's init;
* the serve entry point on the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.utils.tree import from_numpy_tree, tree_leaves, tree_paths

TOL = dict(rtol=2e-4, atol=2e-4)
YI_6B_PARAMS = 6_061_035_520


def _cfgs(kv, **kw):
    ref = dataclasses.replace(ref_get_config("yi_6b").reduced(),
                              dtype="float32", num_kv_heads=kv, **kw)
    port = dataclasses.replace(get_config("yi_6b").reduced(),
                               dtype="float32", num_kv_heads=kv, **kw)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    return ref, port


def _carried(kv, seed=0, **kw):
    ref_cfg, port_cfg = _cfgs(kv, **kw)
    ref = ref_build_model(ref_cfg)
    with jax.threefry_partitionable(False):
        params = jax.tree.map(np.asarray,
                              jax.jit(ref.init)(jax.random.PRNGKey(seed)))
    return ref, build_model(port_cfg), params


def _tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=shape) \
        .astype(np.int32)


@pytest.mark.parametrize("kv", [2, 1], ids=["gqa", "mqa"])
@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_and_loss_match_reference(kv, impl):
    ref, port, params = _carried(kv, attn_impl=impl)
    toks = _tokens((2, 97), ref.cfg.vocab_size, seed=kv)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    tparams = from_numpy_tree(params, "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    logits, cache, aux = port.forward(tparams, tbatch["tokens"])
    want, _, _ = jax.jit(ref.forward)(params, batch["tokens"])
    assert cache is None and float(aux) == 0.0
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               **TOL)
    np.testing.assert_allclose(port.predict(tparams, tbatch).detach().numpy(),
                               np.asarray(want), **TOL)

    before = fa.LAUNCHES
    loss, aux = port.loss(tparams, tbatch)
    assert fa.LAUNCHES == before            # the CPU takes the plain version
    want_loss, want_aux = jax.jit(ref.loss)(params, batch)
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    assert sorted(aux) == sorted(want_aux)


@pytest.mark.parametrize("arch", ["starcoder2_15b", "nemotron4_15b",
                                  "deepseek_67b"])
def test_dense_zoo_reduced_loss_matches_reference(arch):
    """The dense remainder of the zoo (gelu, squared-ReLU and silu MLPs)
    at ``.reduced()`` sizes in float32; loss and logits at 2e-4."""
    ref_cfg = dataclasses.replace(ref_get_config(arch).reduced(),
                                  dtype="float32")
    port_cfg = dataclasses.replace(get_config(arch).reduced(),
                                   dtype="float32")
    ref = ref_build_model(ref_cfg)
    with jax.threefry_partitionable(False):
        params = jax.tree.map(np.asarray,
                              jax.jit(ref.init)(jax.random.PRNGKey(0)))
    port = build_model(port_cfg)
    toks = _tokens((2, 65), ref_cfg.vocab_size, seed=len(arch))
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    tparams = from_numpy_tree(params, "cpu")
    loss, _ = port.loss(tparams, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    want, _ = jax.jit(ref.loss)(params, batch)
    np.testing.assert_allclose(float(loss), float(want), **TOL)
    logits, _, _ = port.forward(tparams, torch.from_numpy(batch["tokens"]))
    want, _, _ = jax.jit(ref.forward)(params, batch["tokens"])
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)


def test_pallas_scoring_has_no_backward():
    _, port, params = _carried(2, attn_impl="pallas")
    tparams = from_numpy_tree(params, "cpu")
    for leaf in tree_leaves(tparams):
        leaf.requires_grad_()
    toks = torch.from_numpy(_tokens((1, 17), 512, seed=3))
    loss, _ = port.loss(tparams, {"tokens": toks[:, :-1],
                                  "targets": toks[:, 1:]})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        loss.backward()


@pytest.mark.parametrize("kv", [2, 1], ids=["gqa", "mqa"])
@pytest.mark.parametrize("prompt,cache_len", [(40, 32), (28, 32)],
                         ids=["prefill-drops", "decode-wraps"])
def test_prefill_and_ring_decode_match_reference(kv, prompt, cache_len):
    ref, port, params = _carried(kv, seed=1)
    tparams = from_numpy_tree(params, "cpu")
    toks = _tokens((2, prompt + 6), ref.cfg.vocab_size, seed=prompt + kv)

    ref_prefill = jax.jit(lambda p, t: ref.prefill(p, t, cache_len))
    ref_decode = jax.jit(ref.decode_step)
    want, want_cache = ref_prefill(params, toks[:, :prompt])
    got, cache = port.prefill(tparams, torch.from_numpy(toks[:, :prompt]),
                              cache_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(),
                                   np.asarray(want_cache[name]), **TOL)
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(want_cache["pos"]))

    for i in range(6):
        pos = prompt + i
        step = toks[:, pos:pos + 1]
        want, want_cache = ref_decode(params, want_cache, step,
                                      jnp.int32(pos))
        got, cache = port.decode_step(tparams, cache,
                                      torch.from_numpy(step), pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_array_equal(cache["pos"].numpy(),
                                      np.asarray(want_cache["pos"]))
    assert int(cache["pos"].max()) == prompt + 5
    assert prompt + 6 > cache_len          # the ring wrapped


def test_full_width_layout_matches_reference():
    ref = ref_build_model(ref_get_config("yi_6b"))
    want = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
    mine = build_model(get_config("yi_6b")).init(None, device="meta")
    assert tree_paths(mine) == tree_paths(want)
    assert [tuple(x.shape) for x in tree_leaves(mine)] == \
        [tuple(x.shape) for x in tree_leaves(want)]
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(mine))
    assert sum(x.numel() for x in tree_leaves(mine)) == YI_6B_PARAMS
    assert sum(int(np.prod(x.shape)) for x in tree_leaves(want)) == \
        YI_6B_PARAMS


def test_bf16_params_carry_across_bit_for_bit():
    ref_cfg = dataclasses.replace(ref_get_config("yi_6b").reduced(),
                                  num_layers=1)
    params = jax.tree.map(np.asarray, ref_build_model(ref_cfg).init(
        jax.random.PRNGKey(2)))
    mine = from_numpy_tree(params, "cpu")
    for got, want in zip(tree_leaves(mine), tree_leaves(params)):
        assert want.dtype == ml_dtypes.bfloat16
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    as_f32 = from_numpy_tree(params, "cpu", dtype=torch.float32)
    assert all(x.dtype == torch.float32 for x in tree_leaves(as_f32))


@pytest.mark.parametrize("extra", [[], ["--personalize"]],
                         ids=["plain", "personalize"])
def test_serve_entry_runs_on_the_cpu(extra, capsys):
    argv = ["--arch", "yi_6b", "--batch", "2", "--prompt-len", "12",
            "--gen", "5", "--cache-len", "16", "--device", "cpu", *extra]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert "sample tokens:" in out and "decode:" in out
    assert ("personalized" in out) == bool(extra)
    res = serve.run(argv)
    assert res.tokens.shape == (2, 5)
    assert int(res.cache["pos"].max()) == 12 + 5 - 2


def test_serve_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the no-card contract is moot")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--batch", "1", "--gen", "2"])


def test_unported_parts_of_the_dense_stack_raise():
    """Nothing of the stack is left unported: ``moe_impl="ep"`` builds,
    and without a mesh its loss is the gather MoE's, bitwise."""
    _, port_cfg = _cfgs(2)
    moe_cfg = dataclasses.replace(port_cfg, moe=get_config(
        "mixtral_8x22b").reduced().moe)
    gen = torch.Generator().manual_seed(0)
    ep, gather = (build_model(moe_cfg, moe_impl=m) for m in ("ep", "gather"))
    params = gather.init(gen)
    tok = torch.randint(0, moe_cfg.vocab_size, (2, 8), generator=gen)
    batch = {"tokens": tok, "targets": tok}
    assert torch.equal(ep.loss(params, batch)[0],
                       gather.loss(params, batch)[0])
