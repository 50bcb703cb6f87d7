"""The port's sharding rules and specs (``repro_torch.sharding``,
``launch/specs.py``, ``launch/mesh.py``) against the JAX reference's.

For every arch of the zoo, at both production meshes, the reference's
``arch_rules``, ``param_specs``, ``cache_shardings`` (decode_32k) and
``state_shardings`` (the semi-sync state on the multi-pod mesh, the train
state on the single pod) must equal the port's per-dim mesh axes exactly.
The reference resolves on ``jax.eval_shape`` params over an
``AbstractMesh`` (no devices, no compile); the port on ``meta`` params over
a DeviceMesh of a ``"fake"`` process group of 256 or 512 ranks.  The
port's placements are read back per dim with ``placements_spec``.  Also:
the ``("pod", "data")`` shard order (pod major) pinned on the rows a rank
holds, and ``constrain`` the identity without a mesh.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro import sharding as ref_sharding
from repro.configs import get_config as ref_get_config
from repro.core import semi_sync as ref_semi_sync
from repro.launch import specs as ref_specs
from repro.models import build_model as ref_build_model
from repro.optim import make_optimizer as ref_make_optimizer
from repro_torch import sharding
from repro_torch.configs import SHAPES, get_config, get_shape
from repro_torch.core import semi_sync
from repro_torch.launch import specs
from repro_torch.launch.dryrun import ASSIGNED
from repro_torch.launch.mesh import fake_world, make_mesh, \
    make_production_mesh
from repro_torch.models import build_model
from repro_torch.optim import make_optimizer
from repro_torch.utils.tree import tree_leaves, tree_paths

MESHES = {"single_pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}


def _norm(entry):
    """A spec entry as the port writes it: a 1-tuple is its name."""
    if isinstance(entry, tuple):
        return entry[0] if len(entry) == 1 else entry
    return entry


def _ref_spec(s):
    s = s.spec if isinstance(s, NamedSharding) else s
    return tuple(_norm(e) for e in s)


def _ref_flat(tree):
    return {ref_sharding._path_str(p): _ref_spec(s) for p, s in
            jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, (P, NamedSharding)))}


def _port_flat(placements, abstract, mesh):
    return {path: sharding.placements_spec(pl, mesh, x.ndim)
            for path, pl, x in zip(tree_paths(abstract),
                                   tree_leaves(placements),
                                   tree_leaves(abstract))}


@functools.lru_cache(maxsize=None)
def _ref_case(arch, mesh_name):
    """The reference's rules, param specs, cache and state specs (flat
    dicts by path) at a production mesh shape."""
    cfg = ref_get_config(arch)
    mesh = AbstractMesh(*MESHES[mesh_name])
    model = ref_build_model(cfg)
    rules = ref_specs.arch_rules(cfg, mesh)
    params = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    pspecs = ref_sharding.param_specs(params, mesh, rules)
    psh = jax.tree.map(lambda s: NamedSharding(mesh, s), pspecs,
                       is_leaf=lambda s: isinstance(s, P))
    shape = get_shape("decode_32k")
    cache = jax.eval_shape(functools.partial(
        model.init_cache, shape.global_batch, ref_specs._cache_len(
            dataclasses.replace(cfg, max_seq_len=shape.seq_len), shape)))
    csh = ref_specs.cache_shardings(cache, mesh, shape.global_batch)
    opt = ref_make_optimizer("sgd")
    if mesh_name == "multi_pod":
        state = jax.eval_shape(functools.partial(
            ref_semi_sync.init_state, model, optimizer=opt, n_cohorts=2),
            jax.random.PRNGKey(0))
        ssh = ref_specs.state_shardings(state, psh, mesh)
        st = {"buffers": _ref_flat(ssh.buffers),
              "staleness": _ref_spec(ssh.staleness),
              "step": _ref_spec(ssh.step)}
    else:
        state = jax.eval_shape(functools.partial(
            ref_semi_sync.init_train_state, model, optimizer=opt),
            jax.random.PRNGKey(0))
        ssh = ref_specs.state_shardings(state, psh, mesh)
        st = {"step": _ref_spec(ssh.step)}
    return (dict(rules.rules), _ref_flat(pspecs), _ref_flat(csh),
            _ref_flat(ssh.params), st)


@pytest.mark.parametrize("arch", ASSIGNED)
def test_specs_match_reference_at_production_meshes(arch):
    for mesh_name in MESHES:
        rules_r, params_r, cache_r, state_params_r, state_r = \
            _ref_case(arch, mesh_name)
        cfg = get_config(arch)
        multi = mesh_name == "multi_pod"
        with fake_world(512 if multi else 256):
            mesh = make_production_mesh(multi_pod=multi)
            rules = specs.arch_rules(cfg, mesh)
            assert rules.rules == rules_r, (arch, mesh_name)
            model = build_model(cfg)
            params = model.init(None, device="meta")
            got = {p: s for p, s in zip(
                tree_paths(params),
                tree_leaves(sharding.param_specs(params, mesh, rules)))}
            assert got == params_r, (arch, mesh_name)
            pl = sharding.param_placements(params, mesh, rules)
            assert _port_flat(pl, params, mesh) == params_r

            shape = get_shape("decode_32k")
            cache = model.init_cache(shape.global_batch, specs._cache_len(
                dataclasses.replace(cfg, max_seq_len=shape.seq_len), shape),
                device="meta")
            csh = specs.cache_shardings(cache, mesh, shape.global_batch)
            assert _port_flat(csh, cache, mesh) == cache_r, (arch,
                                                              mesh_name)

            opt = make_optimizer("sgd")
            if multi:
                state = semi_sync.init_state(model, None, opt, 2,
                                             device="meta")
                ssh = specs.state_shardings(state, pl, mesh)
                assert _port_flat(ssh.buffers, state.buffers, mesh) == \
                    state_r["buffers"]
                assert sharding.placements_spec(ssh.staleness, mesh, 1) \
                    == state_r["staleness"]
            else:
                state = semi_sync.init_train_state(model, None, opt,
                                                   device="meta")
                ssh = specs.state_shardings(state, pl, mesh)
            assert _port_flat(ssh.params, state.params, mesh) == \
                state_params_r
            assert sharding.placements_spec(ssh.step, mesh, 0) == \
                state_r["step"]


def test_logical_spec_resolution_matches_reference():
    """The reference's own ``tests/test_sharding.py`` cases, plus a
    multi-axis batch, on both packages."""
    cases = [(("batch", None, "heads"), None),
             (("experts", "embed", "ffn"), None),
             (("experts", "embed", "ffn"), {"experts": ()}),
             (("batch", "clients", "vocab"), None),
             (("clients", "batch", None), None)]
    with fake_world(8):
        mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
        ref_mesh = AbstractMesh((2, 2, 2), ("pod", "data", "model"))
        for names, over in cases:
            rules, ref_rules = sharding.AxisRules(), ref_sharding.AxisRules()
            if over:
                rules = rules.with_overrides(**over)
                ref_rules = ref_rules.with_overrides(**over)
            assert sharding.logical_spec(names, mesh, rules) == _ref_spec(
                ref_sharding.logical_spec(names, ref_mesh, ref_rules))
    assert sharding.logical_spec(("batch", "heads"), None) == (None, None)


def test_pod_data_shard_order_is_pod_major():
    """A dim split over ("pod", "data") gives rank (p, d, m) the rows of
    block p * D + d, as JAX's PartitionSpec does: a transposed order would
    give the same shapes with the wrong rows."""
    rows = np.arange(16 * 3).reshape(16, 3)
    for rank in range(8):
        with fake_world(8, rank=rank):
            mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
            pl = sharding.placements_for(("batch", None), mesh)
            x = sharding.distribute(torch.from_numpy(rows), pl, mesh)
            p, d, _ = mesh.get_coordinate()
            block = p * 2 + d
            np.testing.assert_array_equal(x.to_local().numpy(),
                                          rows[block * 4:(block + 1) * 4])
            assert sharding.placements_spec(pl, mesh, 2) == \
                (("pod", "data"), None)


def test_constrain_is_identity_without_a_mesh():
    x = torch.ones(4, 4)
    assert sharding.constrain(x, "batch", None) is x
    with sharding.use_mesh(None):
        assert sharding.constrain(x, "batch", None) is x
    assert sharding.param_shardings({"w": x}) == {"w": x}


def test_shapes_are_the_reference_shapes():
    from repro.configs import SHAPES as REF_SHAPES
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in REF_SHAPES.items()}
