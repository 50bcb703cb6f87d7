"""The port's dry run (``launch/dryrun.py``) on small meshes of a ``"fake"``
process group, against the reference's spec arithmetic.

The ten reduced cases of the reference's own ``tests/test_dryrun_small.py``
(train on (data 2, model 4) for four archs; the multi-pod semi-sync step on
(pod 2, data 2, model 2) for two; decode for three; prefill for one), each
run once in this process on meta DTensors over 8 fake ranks.  Each must end
with FLOPs > 0, collectives counted, and rank 0's param bytes equal to
what the reference's ``param_specs`` (on an ``AbstractMesh`` of the same
shape) give: the product over dims of ceil(size / ranks splitting it),
times the item size, and a peak at least the argument bytes.  Also: the
roofline's axis pricing, the ``no_remat`` lever (accepted; it turns
``cfg.remat`` off and raises a plain gradient step's peak), the CLI's
refusal of levers that mean nothing in torch, and the collective counts
against torch's ``CommDebugMode``.
"""
import dataclasses
import math

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from repro import sharding as ref_sharding
from repro.configs import get_config as ref_get_config
from repro.launch import specs as ref_specs
from repro.models import build_model as ref_build_model
from repro_torch.config import FLConfig, ShapeConfig
from repro_torch.configs import get_config
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.launch.specs import arch_rules

SHAPES = {
    "train": ShapeConfig("t", seq_len=64, global_batch=8, kind="train"),
    "prefill": ShapeConfig("p", seq_len=128, global_batch=8, kind="prefill"),
    "decode": ShapeConfig("d", seq_len=128, global_batch=8, kind="decode"),
}
MESHES = {"single": ((2, 4), ("data", "model")),
          "multi": ((2, 2, 2), ("pod", "data", "model"))}
CASES = ([(a, "train", "single") for a in ("yi_6b", "mixtral_8x22b",
                                           "mamba2_370m", "recurrentgemma_2b")]
         + [(a, "train", "multi") for a in ("yi_6b", "deepseek_v2_236b")]
         + [(a, "decode", "single") for a in ("yi_6b", "musicgen_large",
                                              "llama32_vision_11b")]
         + [("starcoder2_15b", "prefill", "single")])


def _ref_param_bytes(arch, mesh_name):
    cfg = ref_get_config(arch).reduced()
    mesh = AbstractMesh(*MESHES[mesh_name])
    params = jax.eval_shape(ref_build_model(cfg).init,
                            jax.random.PRNGKey(0))
    specs = ref_sharding.param_specs(params, mesh,
                                     ref_specs.arch_rules(cfg, mesh))
    total = 0
    is_spec = lambda s: isinstance(s, jax.sharding.PartitionSpec)  # noqa
    for leaf, spec in zip(jax.tree.leaves(params),
                          jax.tree.leaves(specs, is_leaf=is_spec)):
        n = 1
        for d, size in enumerate(leaf.shape):
            ax = spec[d] if d < len(spec) else None
            axes = () if ax is None else ((ax,) if isinstance(ax, str)
                                          else tuple(ax))
            k = math.prod(mesh.shape[a] for a in axes)
            n *= -(-size // k)
        total += n * np.dtype(leaf.dtype).itemsize
    return total


@pytest.mark.parametrize("arch,kind,mesh_name", CASES,
                         ids=[f"{a}-{k}-{m}" for a, k, m in CASES])
def test_reduced_case_runs_and_param_bytes_match_reference(arch, kind,
                                                            mesh_name):
    cfg = get_config(arch).reduced()
    with fake_world(8):
        mesh = make_mesh(*MESHES[mesh_name])
        cohorts = 2 if (mesh_name == "multi" and kind == "train") else None
        rec = dryrun.lower(cfg, SHAPES[kind], mesh,
                           rules=arch_rules(cfg, mesh),
                           semi_sync_cohorts=cohorts)
    assert rec["flops"] > 0
    assert rec["collectives"]["total_bytes"] > 0
    assert rec["memory"]["param_bytes"] == _ref_param_bytes(arch, mesh_name)
    mem = rec["memory"]
    assert mem["argument_bytes"] >= mem["param_bytes"]
    assert mem["peak_bytes"] >= mem["argument_bytes"] + mem["temp_bytes"]
    assert mem["temp_bytes"] == max(mem["peak_bytes"] - mem["argument_bytes"]
                                    - mem["output_bytes"], 0)
    assert "compile_s" not in rec                   # absent, not 0
    assert set(rec["roofline"]) >= {"compute_s", "memory_s", "collective_s",
                                    "dominant"}
    if cohorts:
        assert rec["name"].endswith(":semi_sync")


def test_collective_counts_match_comm_debug_mode():
    """The dry run's collective counts by kind are CommDebugMode's (torch's
    own count of the c10d functional ops dispatched)."""
    from torch.distributed.tensor.debug import CommDebugMode
    cfg = get_config("yi_6b").reduced()
    with fake_world(8):
        mesh = make_mesh(*MESHES["single"])
        with CommDebugMode() as comm:
            rec = dryrun.lower(cfg, SHAPES["decode"], mesh,
                               rules=arch_rules(cfg, mesh))
    kinds = {"all_gather_into_tensor": "all-gather",
             "all_reduce": "all-reduce",
             "reduce_scatter_tensor": "reduce-scatter"}
    want = {}
    for op, n in comm.get_comm_counts().items():
        kind = kinds[op.__name__]
        want[kind] = want.get(kind, 0) + n
    assert rec["collectives"]["count_by_kind"] == want


def test_roofline_prices_axes_by_node():
    rates = roofline.axis_rates((2, 16, 16), ("pod", "data", "model"))
    assert set(rates.values()) == {roofline.INTER_NODE_BW}
    rates = roofline.axis_rates((2, 4), ("data", "model"))
    assert rates == {"data": roofline.NVLINK_BW, "model": roofline.NVLINK_BW}
    rates = roofline.axis_rates((4, 4), ("data", "model"))
    assert rates == {"data": roofline.INTER_NODE_BW,
                     "model": roofline.NVLINK_BW}
    rec = {"mesh_shape": {"data": 4, "model": 4}, "flops": 989e12,
           "bytes_accessed": 0.0,
           "collectives": {"bytes_by_axis": {"data": 50e9, "model": 900e9}}}
    rf = roofline.roofline_report(rec)
    assert rf["compute_s"] == pytest.approx(1.0)
    assert rf["collective_s"] == pytest.approx(2.0)
    assert rf["dominant"] == "collective_s"


def test_no_remat_lever_sets_remat_off_and_raises_the_peak():
    """``no_remat`` turns ``cfg.remat`` off; on a plain gradient step (where
    checkpointing frees the layers' activations) the peak is then at
    least as high, and the records agree but for the recomputation."""
    cfg = get_config("yi_6b").reduced()
    on, _, _ = dryrun.apply_levers(dataclasses.replace(cfg, remat=True),
                                   FLConfig(), "gather", ())
    off, _, _ = dryrun.apply_levers(on, FLConfig(), "gather", ("no_remat",))
    assert on.remat and not off.remat
    recs = {}
    for c in (on, off):
        with fake_world(8):
            mesh = make_mesh(*MESHES["single"])
            recs[c.remat] = dryrun.lower(c, SHAPES["train"], mesh,
                                         rules=arch_rules(c, mesh),
                                         perfed_step=False)
    mem_on, mem_off = recs[True]["memory"], recs[False]["memory"]
    assert mem_off["peak_bytes"] >= mem_on["peak_bytes"]
    assert mem_on["peak_bytes"] >= mem_on["argument_bytes"]
    assert mem_on["argument_bytes"] == mem_off["argument_bytes"]
    assert recs[True]["flops"] > recs[False]["flops"]     # recomputation


def test_peak_bytes_follow_storage_liveness():
    """``op_analysis`` counts each storage from the op that makes it until
    it is freed, views and in-place results once: here the arguments,
    ``a`` and ``b`` are live at once (``a`` dies before ``c`` is made)."""
    import torch

    from repro_torch.launch.op_analysis import analyze

    def step(x):
        a = x * 2                     # 4 KiB
        b = (a + 1).view(32, 32)      # 4 KiB, a view adds nothing
        b.add_(1)                     # in place: nothing new
        del a
        return b * 3                  # 4 KiB, with x and b live

    x = torch.empty(1024, device="meta")
    _, rec = analyze(step, (x,), None)
    assert rec["peak_bytes"] == 3 * 4096


def test_cli_accepts_no_remat(monkeypatch, tmp_path):
    seen = []

    def stub(arch, shape, *, multi_pod, moe_impl, opts):
        seen.append(opts)
        return {"status": "fail", "error": "stub", "total_s": 0.0}

    monkeypatch.setattr(dryrun, "run_case", stub)
    dryrun.main(["--arch", "yi_6b", "--shape", "train_4k", "--opt",
                 "no_remat", "--out", str(tmp_path)])
    assert seen == [("no_remat",)]


@pytest.mark.parametrize("lever", sorted(dryrun.NO_MEANING))
def test_cli_refuses_levers_without_meaning(lever, capsys):
    with pytest.raises(SystemExit):
        dryrun.main(["--arch", "yi_6b", "--shape", "train_4k", "--opt",
                     lever])
    assert "has no meaning here" in capsys.readouterr().err
