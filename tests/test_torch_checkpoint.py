"""The port's checkpoints against the JAX reference's, in both directions.

Both packages write one ``np.savez_compressed`` archive with a ``__meta__``
JSON (sorted keys, step, extra, dtypes), '/'-joined key paths and bf16
stored as its uint16 bit view, so a file written by one loads in the
other.  Trees are made with numpy from a seed and hold float32, bfloat16
and int32 leaves, nested dicts and a list; every comparison is bitwise.
The training launchers' ``--ckpt-dir`` writes a file that loads back (and
loads in the reference, into the reference model's own params).  The MoE
family's reduced params (Mixtral, DeepSeek-V2: nested ``moe`` dicts, a
float32 router beside bfloat16 expert banks) cross both ways bitwise.
"""
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro import checkpoint as ref_ckpt
from repro.configs import get_config as ref_get_config
from repro.models import build_model as ref_build_model
from repro_torch import checkpoint as ckpt
from repro_torch.configs import get_config
from repro_torch.launch import train, train_e2e
from repro_torch.models import build_model


def _numpy_tree(seed):
    rng = np.random.default_rng(seed)
    return {
        "embedding": {"tok_embed": rng.normal(size=(11, 6)).astype(
            ml_dtypes.bfloat16)},
        "layers": {"w": rng.normal(size=(2, 6, 6)).astype(np.float32),
                   "scale": rng.normal(size=(2, 6)).astype(ml_dtypes.bfloat16)},
        "step": np.array(7, np.int32),
        "stack": [rng.normal(size=(3,)).astype(np.float32),
                  rng.integers(0, 9, size=(2, 2)).astype(np.int32)],
    }


def _jax_tree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch_leaf(x):
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch_tree(v) for v in tree]
    return _torch_leaf(tree)


def _bits(x):
    """A leaf's dtype name and raw bits, whichever package made it."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return "bfloat16", x.view(torch.int16).numpy().tobytes()
        return str(x.dtype)[6:], x.numpy().tobytes()
    x = np.asarray(x)
    return str(x.dtype), x.tobytes()


def _same_bits(got, want):
    got, want = jax.tree.leaves(got), jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(np.shape(g)) == tuple(np.shape(w))
        assert _bits(g) == _bits(w)


def _meta(fname):
    with np.load(fname) as z:
        return json.loads(str(z["__meta__"]))


def _flat(tree):
    """The nested-dict form of a list-holding tree, as loading without
    ``like`` returns it ('#i' keys for sequence indices)."""
    if isinstance(tree, list):
        tree = {f"#{i}": v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {k: _flat(v) for k, v in tree.items()}
    return tree


def test_reference_files_load_in_the_port(tmp_path):
    tree = _numpy_tree(0)
    fname = ref_ckpt.save_checkpoint(str(tmp_path), _jax_tree(tree), step=3,
                                     extra={"round": 3})
    # without a template: a nested dict of CPU tensors, bf16 as bf16
    got = ckpt.load_checkpoint(fname)
    _same_bits(got, _flat(tree))
    assert got["embedding"]["tok_embed"].dtype == torch.bfloat16
    # into a template: its structure (the list stays a list) and dtypes
    like = _torch_tree(_numpy_tree(1))
    got = ckpt.load_checkpoint(fname, like=like)
    assert isinstance(got["stack"], list)
    _same_bits(got, tree)


def test_port_files_load_in_the_reference(tmp_path):
    tree = _numpy_tree(2)
    fname = ckpt.save_checkpoint(str(tmp_path / "port"), _torch_tree(tree),
                                 step=3, extra={"round": 3})
    got = ref_ckpt.load_checkpoint(fname)
    _same_bits(_torch_tree(jax.tree.map(np.asarray, got)), _flat(tree))
    got = ref_ckpt.load_checkpoint(fname, like=_jax_tree(_numpy_tree(4)))
    assert got["layers"]["scale"].dtype == jnp.bfloat16
    _same_bits(_torch_tree(jax.tree.map(np.asarray, got)), tree)
    # the same tree written by the reference: the same metadata
    ref_name = ref_ckpt.save_checkpoint(str(tmp_path / "ref"),
                                        _jax_tree(tree), step=3,
                                        extra={"round": 3})
    assert _meta(fname) == _meta(ref_name)
    assert _meta(fname)["dtypes"] == {"embedding/tok_embed": "bfloat16",
                                      "layers/scale": "bfloat16"}


def test_load_into_a_template_checks_shapes_and_casts(tmp_path):
    tree = _torch_tree(_numpy_tree(5))
    fname = ckpt.save_checkpoint(str(tmp_path), tree)
    like = _torch_tree(_numpy_tree(6))
    like["layers"]["w"] = like["layers"]["w"].double()
    got = ckpt.load_checkpoint(fname, like=like)
    assert got["layers"]["w"].dtype == torch.float64
    assert torch.equal(got["layers"]["w"], tree["layers"]["w"].double())
    like["layers"]["w"] = torch.zeros(2, 6, 5)
    with pytest.raises(ValueError, match="shape mismatch at layers/w"):
        ckpt.load_checkpoint(fname, like=like)
    with pytest.raises(ValueError, match="missing keys"):
        ckpt.load_checkpoint(fname, like={**like, "extra": torch.zeros(1)})


@pytest.mark.parametrize("names,want", [
    (["ckpt.npz"], "ckpt.npz"),
    (["ckpt_00000002.npz", "ckpt_00000010.npz", "ckpt.npz"],
     "ckpt_00000010.npz"),
    ([], None),
], ids=["unnumbered", "highest-step", "empty"])
def test_latest_checkpoint_agrees_with_reference(tmp_path, names, want):
    for n in names:
        (tmp_path / n).write_bytes(b"")
    got = ckpt.latest_checkpoint(str(tmp_path))
    assert got == ref_ckpt.latest_checkpoint(str(tmp_path))
    assert got == (None if want is None else str(tmp_path / want))
    assert ckpt.latest_checkpoint(str(tmp_path / "absent")) is None


def test_train_ckpt_dir_writes_a_file_that_loads_back(tmp_path):
    state, _ = train.run(["--mode", "scale", "--arch", "yi_6b", "--reduce",
                          "--steps", "1", "--device", "cpu",
                          "--ckpt-dir", str(tmp_path)])
    fname = ckpt.latest_checkpoint(str(tmp_path))
    assert fname.endswith("ckpt_00000001.npz")
    back = ckpt.load_checkpoint(fname, like=state.params)
    _same_bits(back, state.params)
    # and into the reference model's own params, bf16 leaves and all
    ref_model = ref_build_model(ref_get_config("yi_6b").reduced())
    like = ref_model.init(jax.random.PRNGKey(0))
    got = ref_ckpt.load_checkpoint(fname, like=like)
    _same_bits(state.params, got)


def test_train_e2e_ckpt_dir_writes_a_file_that_loads_back(tmp_path, capsys):
    assert train_e2e.main(["--device", "cpu", "--rounds", "1",
                           "--cohorts", "2", "--participants", "1",
                           "--batch", "1", "--seq", "8",
                           "--ckpt-dir", str(tmp_path)]) == 0
    fname = ckpt.latest_checkpoint(str(tmp_path))
    assert fname.endswith("ckpt_00000001.npz")
    assert f"saved {fname}" in capsys.readouterr().out
    assert _meta(fname)["step"] == 1
    back = ckpt.load_checkpoint(fname)
    assert back["embedding"]["tok_embed"].dtype == torch.bfloat16
    assert tuple(back["layers"]["attn"]["w_q"].shape) == (4, 256, 256)


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "deepseek_v2_236b"])
def test_moe_params_cross_both_ways_bitwise(tmp_path, arch):
    ref_model = ref_build_model(ref_get_config(arch).reduced())
    port_model = build_model(get_config(arch).reduced())
    ref_params = ref_model.init(jax.random.PRNGKey(3))
    port_params = port_model.init(torch.Generator().manual_seed(3))
    for tree in (ref_params, port_params):
        moe = tree["layers"]["moe"]
        assert str(moe["router"].dtype).endswith("float32")
        assert str(moe["moe_gate"].dtype).endswith("bfloat16")

    fname = ref_ckpt.save_checkpoint(str(tmp_path / "ref"), ref_params,
                                     step=1)
    _same_bits(ckpt.load_checkpoint(fname), ref_params)
    got = ckpt.load_checkpoint(fname, like=port_params)
    assert got["layers"]["moe"]["router"].dtype == torch.float32
    _same_bits(got, ref_params)

    fname = ckpt.save_checkpoint(str(tmp_path / "port"), port_params, step=1)
    _same_bits(ref_ckpt.load_checkpoint(fname, like=ref_params), port_params)
    _same_bits(ckpt.load_checkpoint(fname, like=port_params), port_params)
