"""The port's mixture of experts (Mixtral-8x22B) vs the JAX reference.

Float32 throughout, at the reference's own 2e-4.  The JAX package's params
(``model.init`` under ``jax.threefry_partitionable(False)``) are carried
across as numpy through ``utils.tree.from_numpy_tree``, and both packages
see the same numpy inputs.  Wherever routing enters, the test also asserts
on its own inputs that every token's k-th and (k+1)-th router
probabilities differ by more than 1e-5, so a failure cannot be a tie
flipped by rounding; the all-ties case checks the tie order itself.

* ``_route`` (probs, experts, aux loss): random router, the zero router
  (every expert tied: the lower index first, as ``jax.lax.top_k``) and a
  collapsed router;
* ``moe_apply_gather`` at capacity factor 16 (dropless) and 0.25 (drops),
  with and without a shared expert: output, aux, and the dropped (token,
  slot) pairs equal to the reference's;
* reduced Mixtral ``forward`` and ``loss`` under ``attn_impl`` "xla" and
  "pallas" (the reference's flash kernel in interpret mode, the port's
  plain version), the aux loss summed over the layers, and the
  sliding-window case of ``tests/test_pallas_model_integration.py``;
* prefill and a ring-wrapping decode against the reference;
* full-width param and cache layouts on ``meta``; serve on the CPU;
  ``moe_impl="ep"`` without a mesh is the gather MoE;
* three semi-synchronous rounds (masked mean + clipping + β-SGD) against
  the reference's step (``test_torch_semi_sync.hold_semi_sync_rounds``):
  gradients and Hessian-vector products through routing, the expert
  gather and the Switch aux loss, whose value (and the cross entropy) at
  each round's new params is compared too; each round's routings, in the
  step and in that check, keep their top-k gap above 1e-5.
"""
import dataclasses

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
from repro_torch.launch import serve
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.utils.tree import (from_numpy_tree, tree_leaves, tree_map,
                                    tree_paths)
from test_torch_semi_sync import hold_semi_sync_rounds

TOL = dict(rtol=2e-4, atol=2e-4)
MIN_GAP = 1e-5
MIXTRAL_PARAMS = 140_630_071_296
DEEPSEEK_V2_PARAMS = 239_375_569_920


def cfgs(arch, **kw):
    """The reference's and the port's reduced config (float32 unless
    ``kw`` says otherwise), equal."""
    kw = {"dtype": "float32", **kw}
    ref = dataclasses.replace(ref_get_config(arch).reduced(), **kw)
    port = dataclasses.replace(get_config(arch).reduced(), **kw)
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    return ref, port


def carried(arch, seed=0, **kw):
    """(reference model, port model, the reference's params as numpy)."""
    ref_cfg, port_cfg = cfgs(arch, **kw)
    ref = ref_build_model(ref_cfg)
    with jax.threefry_partitionable(False):
        params = jax.tree.map(np.asarray,
                              jax.jit(ref.init)(jax.random.PRNGKey(seed)))
    return ref, build_model(port_cfg), params


def tokens(shape, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, size=shape) \
        .astype(np.int32)


def top_gap(router, xf, k):
    """Smallest gap between a token's k-th and (k+1)-th router
    probability (float64, from the same f32 inputs)."""
    logits = np.asarray(xf, np.float64) @ np.asarray(router, np.float64)
    full = np.exp(logits - logits.max(-1, keepdims=True))
    full /= full.sum(-1, keepdims=True)
    srt = -np.sort(-full, axis=-1)
    return float((srt[:, k - 1] - srt[:, k]).min())


@pytest.fixture
def route_gaps(monkeypatch):
    """Records ``top_gap`` of every routing the port runs."""
    gaps = []
    route = L._route

    def recording(params, xf, e):
        gaps.append(top_gap(params["router"].detach().numpy(),
                            xf.detach().numpy(), e.experts_per_token))
        return route(params, xf, e)

    monkeypatch.setattr(L, "_route", recording)
    return gaps


def _moe_cfgs(cf, shared):
    ref, port = cfgs("mixtral_8x22b")
    moe = dict(capacity_factor=cf, num_shared_experts=shared)
    return (dataclasses.replace(ref, moe=dataclasses.replace(ref.moe, **moe)),
            dataclasses.replace(port,
                                moe=dataclasses.replace(port.moe, **moe)))


def _moe_params(ref_cfg, seed):
    with jax.threefry_partitionable(False):
        return jax.tree.map(np.asarray, RL.moe_init(jax.random.PRNGKey(seed),
                                                    ref_cfg))


@pytest.mark.parametrize("router", ["random", "zero", "collapsed"])
def test_route_matches_reference(router):
    ref_cfg, port_cfg = _moe_cfgs(1.25, 0)
    e = ref_cfg.moe
    params = _moe_params(ref_cfg, seed=1)
    rng = np.random.default_rng(2)
    xf = np.abs(rng.normal(size=(512, ref_cfg.d_model))).astype(np.float32) \
        + 0.1
    if router == "zero":              # every expert tied for every token
        params["router"] = np.zeros_like(params["router"])
    elif router == "collapsed":
        params["router"] = np.zeros_like(params["router"])
        params["router"][:, 0] = 20.0
    else:
        xf = rng.normal(size=xf.shape).astype(np.float32)
        assert top_gap(params["router"], xf, e.experts_per_token) > MIN_GAP
    want = [np.asarray(a) for a in RL._route(params, jnp.asarray(xf), e)]
    got = [a.numpy() for a in L._route(from_numpy_tree(params, "cpu"),
                                       torch.from_numpy(xf), port_cfg.moe)]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[2], want[2], **TOL)
    if router == "zero":
        assert (got[1] == np.arange(e.experts_per_token)).all()


def _ref_dropped(idx, cap, num_experts):
    """The reference's capacity buckets, in its own jnp steps
    (``moe_apply_gather``): the (token, slot) pairs it drops."""
    t, k = idx.shape
    e_flat = jnp.asarray(idx).reshape(-1)
    order = jnp.argsort(e_flat, stable=True)
    se = e_flat[order]
    starts = jnp.searchsorted(se, jnp.arange(num_experts))
    slot = jnp.arange(t * k) - starts[se]
    pairs = np.asarray(order)[np.asarray(slot >= cap)]
    return sorted((int(p) // k, int(p) % k) for p in pairs)


@pytest.mark.parametrize("shared", [0, 1], ids=["routed", "shared"])
@pytest.mark.parametrize("cf", [16.0, 0.25], ids=["dropless", "drops"])
def test_moe_apply_gather_matches_reference(cf, shared):
    ref_cfg, port_cfg = _moe_cfgs(cf, shared)
    e = ref_cfg.moe
    params = _moe_params(ref_cfg, seed=3)
    x = np.random.default_rng(4).normal(
        size=(2, 64, ref_cfg.d_model)).astype(np.float32)
    xf = x.reshape(-1, x.shape[-1])
    assert top_gap(params["router"], xf, e.experts_per_token) > MIN_GAP
    want, want_aux = RL.moe_apply_gather(params, jnp.asarray(x), ref_cfg)
    tparams = from_numpy_tree(params, "cpu")
    got, aux = L.moe_apply(tparams, torch.from_numpy(x), port_cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)

    _, idx, _ = L._route(tparams, torch.from_numpy(xf), port_cfg.moe)
    _, ref_idx, _ = RL._route(params, jnp.asarray(xf), e)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    cap = L.moe_capacity(xf.shape[0], port_cfg.moe)
    dst = L.moe_dispatch(idx, e.num_experts, cap).numpy()
    dropped = [(int(t), int(j))
               for t, j in zip(*np.nonzero(dst == e.num_experts * cap))]
    assert dropped == _ref_dropped(np.asarray(ref_idx), cap, e.num_experts)
    assert bool(dropped) == (cf < 1)
    if cf < 1 and not shared:         # a token with every pair dropped: 0
        gone = [t for t in range(xf.shape[0])
                if (dst[t] == e.num_experts * cap).all()]
        assert gone and not got.reshape(xf.shape)[gone].any()


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_mixtral_forward_and_loss_match_reference(impl, route_gaps):
    ref, port, params = carried("mixtral_8x22b", attn_impl=impl)
    toks = tokens((2, 97), ref.cfg.vocab_size, seed=5)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    tparams = from_numpy_tree(params, "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    logits, cache, aux = port.forward(tparams, tbatch["tokens"])
    want, _, want_aux = jax.jit(ref.forward)(params, batch["tokens"])
    assert cache is None and len(route_gaps) == ref.cfg.num_layers
    assert min(route_gaps) > MIN_GAP
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)
    assert float(aux) > 0                   # summed over the layers

    before = fa.LAUNCHES
    loss, metrics = port.loss(tparams, tbatch)
    assert fa.LAUNCHES == before            # the CPU takes the plain version
    want_loss, want_metrics = jax.jit(ref.loss)(params, batch)
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    for name in ("ce", "aux"):
        np.testing.assert_allclose(float(metrics[name]),
                                   float(want_metrics[name]), **TOL)


def test_mixtral_sliding_window_in_model(route_gaps):
    """``tests/test_pallas_model_integration.py``'s SWA case: 128 tokens
    over the reduced config's 64-key window, pallas against the
    reference's xla forward."""
    ref, port, params = carried("mixtral_8x22b", seed=6, attn_impl="pallas")
    assert 0 < port.cfg.sliding_window < 128
    toks = tokens((1, 128), ref.cfg.vocab_size, seed=7)
    ref_x = ref_build_model(dataclasses.replace(ref.cfg, attn_impl="xla"))
    want, _, _ = jax.jit(ref_x.forward)(params, toks)
    got, _, _ = port.forward(from_numpy_tree(params, "cpu"),
                             torch.from_numpy(toks))
    assert min(route_gaps) > MIN_GAP
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def hold_prefill_and_decode(ref, port, params, toks, prompt, cache_len,
                            n_dec=6):
    """Prefill ``prompt`` tokens, then ``n_dec`` decode steps, each step's
    logits against the reference's at 2e-4; every cache leaf too (floats
    at 2e-4, positions exactly)."""
    tparams = from_numpy_tree(params, "cpu")
    ref_prefill = jax.jit(lambda p, t: ref.prefill(p, t, cache_len))
    ref_decode = jax.jit(ref.decode_step)
    want, want_cache = ref_prefill(params, toks[:, :prompt])
    got, cache = port.prefill(tparams, torch.from_numpy(toks[:, :prompt]),
                              cache_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for i in range(n_dec):
        pos = prompt + i
        step = toks[:, pos:pos + 1]
        want, want_cache = ref_decode(params, want_cache, step,
                                      jnp.int32(pos))
        got, cache = port.decode_step(tparams, cache,
                                      torch.from_numpy(step), pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert sorted(cache) == sorted(want_cache)
    for name in cache:
        if name == "pos":
            np.testing.assert_array_equal(cache[name].numpy(),
                                          np.asarray(want_cache[name]))
        else:
            np.testing.assert_allclose(cache[name].numpy(),
                                       np.asarray(want_cache[name]), **TOL)
    assert int(cache["pos"].max()) == prompt + n_dec - 1
    return cache


@pytest.mark.parametrize("prompt,cache_len", [(40, 32), (28, 32)],
                         ids=["prefill-drops", "decode-wraps"])
def test_mixtral_prefill_and_ring_decode_match_reference(prompt, cache_len,
                                                         route_gaps):
    ref, port, params = carried("mixtral_8x22b", seed=8)
    toks = tokens((2, prompt + 6), ref.cfg.vocab_size, seed=prompt)
    hold_prefill_and_decode(ref, port, params, toks, prompt, cache_len)
    assert min(route_gaps) > MIN_GAP
    assert prompt + 6 > cache_len          # the ring wrapped


def hold_full_width_layout(arch, n_params):
    """Param and cache paths, shapes and dtypes on ``meta`` against
    ``jax.eval_shape`` of the reference's (nothing is allocated)."""
    ref = ref_build_model(ref_get_config(arch))
    want = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
    model = build_model(get_config(arch))
    mine = model.init(None, device="meta")
    assert tree_paths(mine) == tree_paths(want)
    assert [(tuple(x.shape), str(x.dtype)[6:]) for x in tree_leaves(mine)] \
        == [(tuple(x.shape), str(x.dtype)) for x in tree_leaves(want)]
    assert sum(x.numel() for x in tree_leaves(mine)) == n_params
    if "moe" in mine["layers"]:
        assert mine["layers"]["moe"]["router"].dtype == torch.float32
    want_cache = jax.eval_shape(lambda: ref.init_cache(4, 4096))
    cache = model.init_cache(4, 4096, device="meta")
    assert tree_paths(cache) == tree_paths(want_cache)
    assert [(tuple(x.shape), str(x.dtype)[6:]) for x in tree_leaves(cache)] \
        == [(tuple(x.shape), str(x.dtype)) for x in tree_leaves(want_cache)]


def test_mixtral_full_width_layout_matches_reference():
    hold_full_width_layout("mixtral_8x22b", MIXTRAL_PARAMS)


def run_serve(arch, capsys):
    argv = ["--arch", arch, "--batch", "2", "--prompt-len", "12", "--gen",
            "5", "--cache-len", "16", "--device", "cpu"]
    assert serve.main(argv) == 0
    out = capsys.readouterr().out
    assert f"arch={get_config(arch).name}-smoke" in out
    assert "sample tokens:" in out and "decode:" in out
    res = serve.run(argv)
    assert res.tokens.shape[:2] == (2, 5)
    assert int(res.cache["pos"].max()) == 12 + 5 - 2
    return res


def test_mixtral_serve_entry_runs_on_the_cpu(capsys):
    res = run_serve("mixtral_8x22b", capsys)
    assert sorted(res.cache) == ["k", "pos", "v"]


def test_expert_parallel_moe_without_a_mesh_is_gather():
    """``moe_impl="ep"`` builds; without a mesh it is the gather MoE, as
    in the reference (``tests/test_torch_spmd.py`` holds it on a mesh).
    What still raises is an expert count the model axis cannot split."""
    _, port_cfg = cfgs("mixtral_8x22b")
    assert build_model(port_cfg, moe_impl="ep").moe_impl == "ep"
    params = L.moe_init(torch.Generator().manual_seed(0), port_cfg)
    x = torch.randn(2, 4, port_cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    got = L.moe_apply(params, x, port_cfg, impl="ep")
    want = L.moe_apply_gather(params, x, port_cfg)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def hold_moe_semi_sync(arch, grad_clip, gaps):
    """``hold_semi_sync_rounds`` for an MoE ``arch``; after each round the
    loss's cross entropy and aux at the new params on cohort 0's outer
    batch against the reference's (the aux is part of the step's loss in
    both), and every routing of the round with a top-k gap above 1e-5."""
    jitted = {}

    def on_round(k, ref, port, ref_state, state, batches):
        loss = jitted.setdefault("loss", jax.jit(ref.loss))
        outer = tree_map(lambda x: x[0], batches["outer"])
        _, want = loss(ref_state.params, outer)
        with torch.no_grad():
            _, got = port.loss(state.params,
                               tree_map(torch.from_numpy, outer))
        assert float(got["aux"]) > 0
        for name in ("ce", "aux"):
            np.testing.assert_allclose(float(got[name]), float(want[name]),
                                       rtol=1e-5, err_msg=f"round {k} {name}")
        assert gaps and min(gaps) > MIN_GAP, (k, min(gaps))
        gaps.clear()

    return hold_semi_sync_rounds(arch, grad_clip, on_round=on_round)


def test_semi_sync_rounds_match_reference(route_gaps):
    """The clipped route (masked mean, clipping, β-SGD)."""
    _, state = hold_moe_semi_sync("mixtral_8x22b", 1.0, route_gaps)
    # the router's and every expert bank's gradients reached the buffers
    assert all(bool(x[2].any()) for x in tree_leaves(
        state.buffers["layers"]["moe"]))
