"""The port's package-level API against the JAX reference's.

For every subpackage (and every module) of the reference that declares
``__all__``, the port exports each name that is ported, and its own
``__all__`` lists exactly those.  ``MISSING`` names what is not ported
yet; a later slice that ports a name moves it out of this list, and the
test fails until it does.
"""
import importlib

import pytest

# name -> reference names the port does not export yet (ROADMAP queue 1)
MISSING = {
    "repro.analysis": ["Baseline", "BaselineEntry", "Finding", "LintReport",
                       "lint_text", "run_paths"],
    "repro.analysis.core": None,        # whole module: static analysis
    "repro.analysis.rules": None,
    "repro.kernels.ops": None,          # the reference's jit wrappers
    "repro.utils.hypofallback": None,   # the reference's test support
}

MODULES = ["repro.analysis", "repro.analysis.core", "repro.analysis.rules",
           "repro.checkpoint", "repro.core", "repro.data", "repro.fl",
           "repro.fl.engine", "repro.fl.mobile", "repro.fl.scenario",
           "repro.fl.simulation", "repro.kernels.ops", "repro.mobility",
           "repro.models", "repro.obs", "repro.obs.trace", "repro.optim",
           "repro.utils", "repro.utils.hypofallback", "repro.wireless"]


def _port(name):
    try:
        return importlib.import_module("repro_torch" + name[len("repro"):])
    except ModuleNotFoundError:
        return None


@pytest.mark.parametrize("name", MODULES)
def test_port_exports_the_reference_names(name):
    ref_all = list(importlib.import_module(name).__all__)
    port = _port(name)
    missing = MISSING.get(name, [])
    if port is None:                    # only a wholly unported module
        assert missing is None or sorted(missing) == sorted(ref_all), \
            f"{name} has no counterpart in the port"
        return
    assert missing is not None, f"{name} is ported now: list what is not"
    ported = [x for x in ref_all if x not in missing]
    for x in ported:
        assert hasattr(port, x), f"{name}.{x} is not exported by the port"
    for x in missing:
        assert x in ref_all, f"{x} is no longer in {name}.__all__"
        assert not hasattr(port, x), \
            f"{name}.{x} is ported now: take it out of MISSING"
    assert set(getattr(port, "__all__", [])) >= set(ported)


def test_reference_usage_imports_from_the_port():
    """The imports the README and examples write for the reference."""
    from repro_torch.core import fosp_bound, greedy_schedule  # noqa: F401
    from repro_torch.data import synthetic_cifar  # noqa: F401
    from repro_torch.fl import SimResult, run_simulation  # noqa: F401
    from repro_torch.mobility import MultiCellNetwork  # noqa: F401
    from repro_torch.models import MODEL_FAMILIES
    from repro_torch.obs import Tracer  # noqa: F401
    from repro_torch.utils import tree_add, tree_size  # noqa: F401
    from repro_torch.wireless import EdgeNetwork  # noqa: F401
    assert sorted(MODEL_FAMILIES) == ["audio", "dense", "hybrid", "moe",
                                      "small", "ssm", "vlm"]


def test_tree_helpers_match_reference():
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.utils import tree as ref_tree
    from repro_torch.utils import tree as tree
    a = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
         "b": {"x": np.array([1.5, -2.0], np.float32),
               "i": np.array([3, 4], np.int32)}}
    b = {"w": np.full((2, 3), 0.5, np.float32),
         "b": {"x": np.array([2.0, 4.0], np.float32),
               "i": np.array([1, 1], np.int32)}}
    ta = {k: (torch.as_tensor(v) if not isinstance(v, dict) else
              {k2: torch.as_tensor(v2) for k2, v2 in v.items()})
          for k, v in a.items()}
    tb = {k: (torch.as_tensor(v) if not isinstance(v, dict) else
              {k2: torch.as_tensor(v2) for k2, v2 in v.items()})
          for k, v in b.items()}
    ja = {"w": jnp.asarray(a["w"]), "b": {k: jnp.asarray(v)
                                          for k, v in a["b"].items()}}
    jb = {"w": jnp.asarray(b["w"]), "b": {k: jnp.asarray(v)
                                          for k, v in b["b"].items()}}
    assert tree.tree_size(ta) == ref_tree.tree_size(ja) == 10
    assert tree.tree_bytes(ta) == ref_tree.tree_bytes(ja) == 40
    fa = {"w": ta["w"], "b": {"x": ta["b"]["x"]}}
    fb = {"w": tb["w"], "b": {"x": tb["b"]["x"]}}
    jfa = {"w": ja["w"], "b": {"x": ja["b"]["x"]}}
    jfb = {"w": jb["w"], "b": {"x": jb["b"]["x"]}}
    assert float(tree.tree_dot(fa, fb)) == float(ref_tree.tree_dot(jfa, jfb))
    for got, want in zip(tree.tree_leaves(tree.tree_add(ta, tb)),
                         [ref_tree.tree_add(ja, jb)["b"]["i"],
                          ref_tree.tree_add(ja, jb)["b"]["x"],
                          ref_tree.tree_add(ja, jb)["w"]]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cast = tree.tree_cast(ta, torch.bfloat16)
    assert cast["w"].dtype == torch.bfloat16
    assert cast["b"]["i"].dtype == torch.int32
    zeros = tree.tree_zeros_like(ta)
    assert all(float(x.abs().sum()) == 0 for x in tree.tree_leaves(zeros))
