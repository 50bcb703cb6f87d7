"""The port's optimizers, schedules and fused Adam vs the JAX reference.

* ``fused_adam_plain`` (the CUDA kernel's plain version, which a CPU tensor
  takes through ``fused_adam_flat``) vs the reference's ``fused_adam_flat``
  in interpret mode, for n in {100, 4096, 5000} and t in {1, 10}, atol 1e-6
  (the reference's own tolerance against its oracle);
* bf16 p keeps its dtype; bias corrections and lr may be device tensors;
* ``fused_adam_tree`` vs the reference's ``optim.adam`` on a small tree;
* ``sgd``, ``momentum`` (plain and Nesterov), ``adam`` (with and without
  weight decay), ``clip_by_global_norm``, ``constant`` and
  ``warmup_cosine`` vs the reference, over three steps, at 1e-6.

Inputs are made with numpy from a seed and handed to both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.fused_adam import fused_adam_flat as ref_fused_adam_flat
from repro.optim import make_optimizer as ref_make_optimizer
from repro.optim import clip_by_global_norm as ref_clip
from repro.optim import constant as ref_constant
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro_torch.kernels import fused_adam as fa
from repro_torch.optim import (clip_by_global_norm, constant, make_optimizer,
                               warmup_cosine)
from repro_torch.utils.tree import tree_leaves, tree_map

ATOL = 1e-6


def _adam_inputs(n, seed):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=n).astype(np.float32)
    m = (rng.normal(size=n) * 0.1).astype(np.float32)
    v = (np.abs(rng.normal(size=n)) * 0.01).astype(np.float32)
    g = rng.normal(size=n).astype(np.float32)
    return p, m, v, g


@pytest.mark.parametrize("n", [100, 4096, 5000])
@pytest.mark.parametrize("t", [1, 10])
def test_fused_adam_plain_matches_pallas_kernel(n, t):
    args = _adam_inputs(n, seed=n + t)
    want = ref_fused_adam_flat(*(jnp.asarray(x) for x in args), lr=3e-3,
                               t=t, interpret=True)
    before = fa.LAUNCHES
    got = fa.fused_adam_flat(*(torch.from_numpy(x) for x in args), lr=3e-3,
                             t=t)
    assert fa.LAUNCHES == before            # the CPU takes the plain version
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_fused_adam_bf16_params_keep_their_dtype():
    p, m, v, g = _adam_inputs(512, seed=1)
    pb = torch.from_numpy(p).to(torch.bfloat16)
    # lr and t as tensors (as the optimizer passes them): no host sync
    new_p, new_m, new_v = fa.fused_adam_flat(
        pb, torch.zeros(512), torch.zeros(512), torch.from_numpy(g),
        lr=torch.tensor(1e-2), t=torch.tensor(1, dtype=torch.int32))
    assert new_p.dtype == torch.bfloat16
    assert new_m.dtype == new_v.dtype == torch.float32
    want = ref_fused_adam_flat(jnp.asarray(p).astype(jnp.bfloat16),
                               jnp.zeros(512), jnp.zeros(512), jnp.asarray(g),
                               lr=1e-2, t=1, interpret=True)
    np.testing.assert_array_equal(new_p.float().numpy(),
                                  np.asarray(want[0]).astype(np.float32))
    np.testing.assert_allclose(new_m.numpy(), np.asarray(want[1]), atol=ATOL)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=(64, 8)).astype(np.float32),
            "b": {"c": rng.normal(size=(100,)).astype(np.float32)}}


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    return tree_map(torch.from_numpy, tree)


def _assert_trees_close(got, want, atol=ATOL):
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol)


def test_fused_adam_tree_matches_reference_optimizer():
    params = _tree(0)
    grads = tree_map(lambda x: np.full_like(x, 0.1), params)
    ref_opt = ref_make_optimizer("adam")
    st = ref_opt.init(_to_jax(params))
    want, _ = ref_opt.update(_to_jax(grads), st, _to_jax(params), 1e-2)
    tp = _to_torch(params)
    zeros = tree_map(torch.zeros_like, tp)
    got, m, v = fa.fused_adam_tree(tp, zeros, zeros, _to_torch(grads),
                                   lr=1e-2, t=1)
    _assert_trees_close(got, want)
    want_k, _, _ = ref_ops.fused_adam_tree(_to_jax(params), st["m"], st["v"],
                                           _to_jax(grads), lr=1e-2, t=1)
    _assert_trees_close(got, want_k)


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}),
    ("momentum", {}),
    ("momentum", {"nesterov": True}),
    ("adam", {}),
    ("adam", {"weight_decay": 0.1}),
], ids=["sgd", "momentum", "nesterov", "adam", "adamw"])
def test_optimizers_match_reference_over_three_steps(name, kw):
    params = _tree(1)
    ref_opt, opt = ref_make_optimizer(name, **kw), make_optimizer(name, **kw)
    rp, tp = _to_jax(params), _to_torch(params)
    rs, ts = ref_opt.init(rp), opt.init(tp)
    for k in range(3):
        grads = _tree(10 + k)
        rp, rs = ref_opt.update(_to_jax(grads), rs, rp, 3e-2)
        tp, ts = opt.update(_to_torch(grads), ts, tp, 3e-2)
        _assert_trees_close(tp, rp)
    if name == "adam":
        assert int(ts["t"]) == int(rs["t"]) == 3
        _assert_trees_close(ts["m"], rs["m"])
        _assert_trees_close(ts["v"], rs["v"])


def test_clip_by_global_norm_matches_reference():
    grads = _tree(2)
    for max_norm in (0.5, 1e3):
        want, want_norm = ref_clip(_to_jax(grads), max_norm)
        got, norm = clip_by_global_norm(_to_torch(grads), max_norm)
        np.testing.assert_allclose(float(norm), float(want_norm), rtol=1e-6)
        _assert_trees_close(got, want)


def test_schedules_match_reference():
    for step in (0, 1, 5, 50, 99, 150):
        assert float(constant(3e-4)(step)) == float(ref_constant(3e-4)(step))
        want = ref_warmup_cosine(1e-3, 10, 100)(step)
        got = warmup_cosine(1e-3, 10, 100)(step)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    got = warmup_cosine(1e-3, 10, 100)(torch.tensor(20))
    assert got.dtype == torch.float32
