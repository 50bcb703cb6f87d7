"""Per-FedAvg math of the port vs the JAX reference.

Same params (drawn from a seed, carried as numpy), same numpy batches:
``adapt``, ``hvp``, ``perfed_grad``, every algorithm's payload and
``personalized_eval`` agree at rtol 1e-4 / atol 1e-6 (float32 autodiff,
different op order; LeNet-5's conv is held to its leaves' scale).  The
port's ``perfed_grad`` also equals its own autodiff oracle
``perfed_grad_exact`` on identical batches, as in ``tests/test_perfed.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.config import FLConfig as RefFLConfig
from repro.configs import get_config as ref_get_config
from repro.core import perfed as ref_perfed
from repro.fl import client as ref_client
from repro.models import build_model as ref_build_model
from repro_torch.config import FLConfig
from repro_torch.configs import get_config
from repro_torch.core import perfed
from repro_torch.fl import client
from repro_torch.models import build_model
from repro_torch.utils.tree import (from_numpy_tree, to_numpy_tree,
                                    tree_leaves, tree_map)

TOL = dict(rtol=1e-4, atol=1e-6)
ALPHA = 0.03


def _batch(name, rng, b):
    if name == "mnist_dnn":
        return {"x": rng.normal(size=(b, 28, 28)).astype(np.float32),
                "y": rng.integers(0, 10, size=b).astype(np.int32)}
    if name == "lenet5":
        return {"x": rng.normal(size=(b, 32, 32, 3)).astype(np.float32),
                "y": rng.integers(0, 100, size=b).astype(np.int32)}
    toks = rng.integers(0, 80, size=(b, 7)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _setup(name, seed, b=4):
    port = build_model(get_config(name))
    params = to_numpy_tree(port.init(torch.Generator().manual_seed(seed)))
    rng = np.random.default_rng(seed)
    batches = {k: _batch(name, rng, b) for k in ("inner", "outer", "hessian")}
    return ref_build_model(ref_get_config(name)), port, params, batches


def _t(tree):
    return tree_map(lambda x: torch.as_tensor(np.asarray(x)), tree)


def _close(got, want):
    for g, w in zip(tree_leaves(got), tree_leaves(
            jax.tree.map(np.asarray, want))):
        np.testing.assert_allclose(g.detach().numpy(), w, **TOL)


def test_adapt_and_hvp_match_reference():
    ref, port, params, batches = _setup("mnist_dnn", seed=0)
    tp = from_numpy_tree(params, "cpu")
    _close(perfed.adapt(port.loss, tp, _t(batches["inner"]), ALPHA),
           jax.jit(lambda p, b: ref_perfed.adapt(ref.loss, p, b, ALPHA))(
               params, batches["inner"]))
    rng = np.random.default_rng(1)
    vec = jax.tree.map(
        lambda x: (0.01 * rng.normal(size=x.shape)).astype(np.float32), params)
    _close(perfed.hvp(port.loss, tp, _t(batches["hessian"]), _t(vec)),
           jax.jit(lambda p, b, v: ref_perfed.hvp(ref.loss, p, b, v))(
               params, batches["hessian"], vec))


@pytest.mark.parametrize("name,first_order", [
    ("mnist_dnn", False), ("mnist_dnn", True), ("lenet5", False),
    ("char_lstm", False)])
def test_perfed_grad_matches_reference(name, first_order):
    ref, port, params, batches = _setup(name, seed=2, b=3)
    got = perfed.perfed_grad(port.loss, from_numpy_tree(params, "cpu"),
                             _t(batches), ALPHA, first_order=first_order)
    want = jax.jit(lambda p, b: ref_perfed.perfed_grad(
        ref.loss, p, b, ALPHA, first_order=first_order))(params, batches)
    if name == "lenet5":
        # the conv's second-order term sums in another order than XLA's
        # convolution: hold each leaf to 1e-5 of its own scale instead
        for g, w in zip(tree_leaves(got), tree_leaves(
                jax.tree.map(np.asarray, want))):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                       atol=1e-5 * np.abs(w).max())
    else:
        _close(got, want)
    got_l = perfed.perfed_loss(port.loss, from_numpy_tree(params, "cpu"),
                               _t(batches), ALPHA)
    want_l = jax.jit(lambda p, b: ref_perfed.perfed_loss(
        ref.loss, p, b, ALPHA))(params, batches)
    np.testing.assert_allclose(float(got_l), float(want_l), **TOL)


def test_perfed_grad_equals_exact_on_identical_batches():
    _, port, params, batches = _setup("mnist_dnn", seed=3)
    tp = from_numpy_tree(params, "cpu")
    b = _t(batches["inner"])
    got = perfed.perfed_grad(port.loss, tp, {"inner": b, "outer": b,
                                             "hessian": b}, ALPHA)
    want = perfed.perfed_grad_exact(port.loss, tp, b, ALPHA)
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("algorithm", ["perfed", "fedavg", "fedprox",
                                       "pfedme"])
def test_payloads_match_reference(algorithm):
    ref, port, params, batches = _setup("mnist_dnn", seed=4)
    kw = dict(alpha=ALPHA, local_epochs=2, pfedme_steps=3)
    want = ref_client.make_payload_fn(ref, RefFLConfig(**kw), algorithm)(
        params, batches, jax.random.PRNGKey(0), ALPHA)
    got = client.make_payload_fn(port, FLConfig(**kw), algorithm)(
        from_numpy_tree(params, "cpu"), _t(batches),
        torch.tensor(ALPHA, dtype=torch.float32))
    _close(got, want)


def test_personalized_eval_matches_reference():
    ref, port, params, batches = _setup("mnist_dnn", seed=5)
    fl = FLConfig(alpha=ALPHA)
    got, got_aux = client.personalized_eval(
        port, fl, from_numpy_tree(params, "cpu"), _t(batches))
    ref_fl = RefFLConfig(**dataclasses.asdict(fl))
    want, want_aux = jax.jit(lambda p, b: ref_client.personalized_eval(
        ref, ref_fl, p, b))(params, batches)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    assert float(got_aux["acc"]) == float(want_aux["acc"])
    g_loss, _ = client.global_eval(port, from_numpy_tree(params, "cpu"),
                                   _t(batches["outer"]))
    w_loss, _ = jax.jit(lambda p, b: ref_client.global_eval(ref, p, b))(
        params, batches["outer"])
    np.testing.assert_allclose(float(g_loss), float(w_loss), **TOL)
