"""The port's multi-head latent attention (DeepSeek-V2) vs the JAX
reference.

Float32 at the reference's 2e-4 unless stated, the reference's params
carried across as numpy, as in ``tests/test_torch_moe.py`` (whose helpers
this file imports; every routing the port runs is checked for a top-k gap
above 1e-5 on the test's own inputs):

* reduced DeepSeek-V2 ``forward`` and ``loss`` under ``attn_impl`` "xla"
  and "pallas" (MLA runs ``sdpa`` under both, as in the reference), and
  with ``q_lora_rank > 0``, the full config's low-rank queries, which
  ``reduced()`` turns off;
* prefill and a ring-wrapping decode through the absorbed form against
  the latent cache;
* one absorbed decode step in bfloat16, where the reference's casts
  decide the numbers, with and without a window: within 1e-3 of the
  reference, row by row;
* full-width param and latent-cache layouts on ``meta``; serve on the
  CPU;
* three semi-synchronous rounds (the fused Eq.-8 route) against the
  reference's step, through MLA, the routing, the shared expert and the
  aux loss (``test_torch_moe.hold_moe_semi_sync``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro_torch.models import layers as L
from repro_torch.utils.tree import from_numpy_tree, tree_leaves
from test_torch_moe import (DEEPSEEK_V2_PARAMS, MIN_GAP, TOL, carried, cfgs,
                            hold_full_width_layout, hold_moe_semi_sync,
                            hold_prefill_and_decode, run_serve, tokens)
from test_torch_moe import route_gaps  # noqa: F401  (a fixture)


@pytest.mark.parametrize("impl,q_lora", [("xla", 0), ("pallas", 0),
                                         ("xla", 48)],
                         ids=["xla", "pallas", "q-lora"])
def test_deepseek_forward_and_loss_match_reference(impl, q_lora, route_gaps):
    ref, port, params = carried("deepseek_v2_236b", attn_impl=impl)
    if q_lora:
        mla = dict(q_lora_rank=q_lora)
        ref, port, params = carried(
            "deepseek_v2_236b", attn_impl=impl,
            mla=dataclasses.replace(ref.cfg.mla, **mla))
        assert {"w_dq", "w_uq", "norm_q"} <= set(params["layers"]["attn"])
    toks = tokens((2, 97), ref.cfg.vocab_size, seed=9 + q_lora)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    tparams = from_numpy_tree(params, "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    logits, _, aux = port.forward(tparams, tbatch["tokens"])
    want, _, want_aux = jax.jit(ref.forward)(params, batch["tokens"])
    assert min(route_gaps) > MIN_GAP
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    loss, _ = port.loss(tparams, tbatch)
    want_loss, _ = jax.jit(ref.loss)(params, batch)
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)


@pytest.mark.parametrize("prompt,cache_len", [(40, 32), (28, 32)],
                         ids=["prefill-drops", "decode-wraps"])
def test_deepseek_prefill_and_absorbed_decode_match_reference(
        prompt, cache_len, route_gaps):
    ref, port, params = carried("deepseek_v2_236b", seed=10)
    toks = tokens((2, prompt + 6), ref.cfg.vocab_size, seed=prompt + 1)
    cache = hold_prefill_and_decode(ref, port, params, toks, prompt,
                                    cache_len)
    assert sorted(cache) == ["ckv", "kr", "pos"]
    assert min(route_gaps) > MIN_GAP
    assert prompt + 6 > cache_len          # the ring wrapped


@pytest.mark.parametrize("window", [0, 16])
def test_absorbed_decode_matches_reference_in_bf16(window):
    """One absorbed decode step of ``mla_apply`` in bfloat16 against a
    latent cache of 24 filled slots out of 32, with and without a window;
    the output rows within 1e-3 relative of the reference's (they read 0
    on the CPU; dropping the cast of q_lat to the cache's dtype moves them
    by 2.9e-3), the cache written bitwise.
    ``attn_cast_f32=False`` is not held: the reference cannot run it in
    bf16 on the CPU (XLA's CPU dot has no bf16 x bf16 -> f32)."""
    cfg, port_cfg = cfgs("deepseek_v2_236b", dtype="bfloat16")
    with jax.threefry_partitionable(False):
        p = jax.tree.map(np.asarray, RL.mla_init(jax.random.PRNGKey(11), cfg))
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    cache = {"ckv": rng.normal(size=(2, 32, cfg.mla.kv_lora_rank)),
             "kr": rng.normal(size=(2, 32, cfg.mla.qk_rope_head_dim))}
    cache = {k: jnp.asarray(v, jnp.bfloat16) for k, v in cache.items()}
    cache["pos"] = jnp.asarray(np.where(np.arange(32) < 24, np.arange(32),
                                        -1)[None].repeat(2, 0), jnp.int32)
    pos = jnp.asarray([24], jnp.int32)
    want, want_cache = jax.jit(lambda p, x, c: RL.mla_apply(
        p, x, cfg=cfg, positions=pos, cache=c, window=window))(
            p, jnp.asarray(x, jnp.bfloat16), cache)
    tcache = {k: from_numpy_tree({"a": np.asarray(v)}, "cpu")["a"]
              for k, v in cache.items()}
    got, got_cache = L.mla_apply(
        from_numpy_tree(p, "cpu"), torch.from_numpy(x).to(torch.bfloat16),
        cfg=port_cfg, positions=torch.tensor([24], dtype=torch.int32),
        cache=tcache, window=window)
    want = np.asarray(want, np.float32)
    rel = np.linalg.norm(got.float().numpy() - want, axis=-1) \
        / np.linalg.norm(want, axis=-1)
    assert float(rel.max()) <= 1e-3
    np.testing.assert_array_equal(got_cache["pos"].numpy(),
                                  np.asarray(want_cache["pos"]))
    np.testing.assert_array_equal(
        got_cache["ckv"].float().numpy(),
        np.asarray(want_cache["ckv"], np.float32))


def test_deepseek_full_width_layout_matches_reference():
    hold_full_width_layout("deepseek_v2_236b", DEEPSEEK_V2_PARAMS)


def test_deepseek_serve_entry_runs_on_the_cpu(capsys):
    res = run_serve("deepseek_v2_236b", capsys)
    assert sorted(res.cache) == ["ckv", "kr", "pos"]


def test_semi_sync_rounds_match_reference(route_gaps):
    """The fused Eq.-8 route (β-SGD, no clipping)."""
    _, state = hold_moe_semi_sync("deepseek_v2_236b", 0.0, route_gaps)
    assert all(bool(x[2].any()) for x in tree_leaves(
        state.buffers["layers"]))
