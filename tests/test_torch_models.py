"""The port's small models vs the JAX reference on carried weights.

Weights are drawn once from a seed, carried between the packages as numpy
(``to_numpy_tree`` / ``from_numpy_tree``), and both packages evaluate the
same numpy batch: logits and loss agree to atol 1e-5 (float32, different
summation order).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.utils.tree import (from_numpy_tree, to_numpy_tree,
                                    tree_leaves, tree_paths)

ATOL = 1e-5


def _batch(name, seed):
    rng = np.random.default_rng(seed)
    if name == "mnist_dnn":
        return {"x": rng.normal(size=(4, 28, 28)).astype(np.float32),
                "y": rng.integers(0, 10, size=4).astype(np.int32)}
    if name == "lenet5":
        return {"x": rng.normal(size=(3, 32, 32, 3)).astype(np.float32),
                "y": rng.integers(0, 100, size=3).astype(np.int32)}
    toks = rng.integers(0, 80, size=(2, 9)).astype(np.int32)
    return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}


def _carried(name, seed):
    port = build_model(get_config(name))
    params = to_numpy_tree(port.init(torch.Generator().manual_seed(seed)))
    return ref_build_model(ref_get_config(name)), port, params


@pytest.mark.parametrize("name", ["mnist_dnn", "lenet5", "char_lstm"])
def test_logits_and_loss_match_reference(name):
    ref, port, params = _carried(name, seed=1)
    batch = _batch(name, seed=2)
    tparams = from_numpy_tree(params, "cpu")
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    np.testing.assert_allclose(port.predict(tparams, tbatch).numpy(),
                               np.asarray(jax.jit(ref.predict)(params, batch)),
                               atol=ATOL, rtol=0)
    got_loss, got_aux = port.loss(tparams, tbatch)
    want_loss, want_aux = jax.jit(ref.loss)(params, batch)
    np.testing.assert_allclose(float(got_loss), float(want_loss), atol=ATOL,
                               rtol=0)
    assert sorted(got_aux) == sorted(want_aux)
    if "acc" in want_aux:
        assert float(got_aux["acc"]) == float(want_aux["acc"])


@pytest.mark.parametrize("name", ["mnist_dnn", "lenet5", "char_lstm"])
def test_init_has_reference_names_and_layouts(name):
    ref = ref_build_model(ref_get_config(name))
    want = jax.eval_shape(ref.init, jax.random.PRNGKey(0))
    mine = build_model(get_config(name)).init(
        torch.Generator().manual_seed(0))
    assert tree_paths(mine) == tree_paths(want)
    assert [tuple(x.shape) for x in tree_leaves(mine)] == \
        [tuple(x.shape) for x in tree_leaves(want)]
    assert all(x.dtype == torch.float32 for x in tree_leaves(mine))


def test_mnist_dnn_full_width():
    port = build_model(get_config("mnist_dnn"))
    params = port.init(torch.Generator().manual_seed(0))
    assert sum(x.numel() for x in tree_leaves(params)) == 79_510


def test_numpy_tree_round_trip():
    _, _, params = _carried("lenet5", seed=4)
    back = to_numpy_tree(from_numpy_tree(params, "cpu"))
    assert tree_paths(back) == tree_paths(params)
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    # the flat "/"-keyed form an .npz holds maps onto the same tree
    flat = dict(zip(tree_paths(params), tree_leaves(params)))
    again = to_numpy_tree(from_numpy_tree(flat, "cpu"))
    for a, b in zip(tree_leaves(again), tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ["yi_6b", "mamba2_370m", "starcoder2_15b",
                                  "nemotron4_15b", "deepseek_67b",
                                  "recurrentgemma_2b", "mixtral_8x22b",
                                  "deepseek_v2_236b"])
def test_lm_configs_are_literal_copies(arch):
    want = dataclasses.asdict(ref_get_config(arch))
    assert dataclasses.asdict(get_config(arch)) == want
    assert dataclasses.asdict(get_config(want["name"])) == want


def test_unported_families_name_the_roadmap_queue():
    for arch in ("llama32_vision_11b", "musicgen_large"):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
            get_config(arch)
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
            build_model(ref_get_config(arch))
