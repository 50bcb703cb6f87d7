"""The port's examples (``repro_torch.examples``) vs the JAX package's
``examples/``, on the CPU.

* ``wireless_scheduling`` is host numpy only: its stdout equals the
  reference example's, run with ``runpy``.
* The simulation examples (``quickstart``, ``compare_algorithms``,
  ``mobile_edge``, ``hetero_cells``): the reference example runs as
  ``__main__`` with its ``run_simulation`` replaced by the parity runner's
  ``run_ref`` (``tests/test_torch_mobility.py``), each run capped at a
  few rounds; the port's ``main(max_rounds=...)`` runs the same configs
  from the reference's initial params (``port_model(ref_init(0))``).
  Each pair of runs through ``hold_pair``: host event math bitwise (times,
  Π, handovers, cloud merges, wait fraction), losses and final params
  within rtol 1e-5, atol 1e-6 (inside the golden's rtol 1e-4); the two
  stdouts are equal line for line.
* ``serve_personalized`` with its config in f32: the meta and adapted
  losses of both users against the reference's at f32 tolerance, from the
  reference's params carried across (the example's own bf16 config runs
  on the card, in ``chip_smoke.py``).
"""
import contextlib
import dataclasses
import io
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fl.simulation as ref_simulation
from repro.configs import get_config as ref_get_config
from repro.core.perfed import adapt as ref_adapt
from repro.data.synthetic import synthetic_lm_corpus as ref_corpus
from repro.models import build_model as ref_build_model
from repro_torch.configs import get_config as port_get_config
from repro_torch.examples import (compare_algorithms, hetero_cells,
                                  mobile_edge, quickstart,
                                  serve_personalized, wireless_scheduling)
from repro_torch.utils.tree import from_numpy_tree
from test_torch_mobility import hold_pair, port_model, ref_init, run_ref
from test_torch_semi_sync import one_thread

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples")


def run_reference(name, monkeypatch, rounds, argv=()):
    """``examples/<name>.py`` as ``__main__``, every ``run_simulation`` call
    a ``run_ref`` capped at ``rounds``: (stdout, [(result, final
    params)])."""
    runs = []

    def recording(cfg, model, clients, *, max_rounds=None, **kw):
        res, params = run_ref(cfg, clients, max_rounds=min(max_rounds,
                                                           rounds), **kw)
        runs.append((res, params))
        return res

    path = os.path.join(EXAMPLES, f"{name}.py")
    monkeypatch.setattr(ref_simulation, "run_simulation", recording)
    monkeypatch.setattr(sys, "argv", [path, *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        runpy.run_path(path, run_name="__main__")
    return out.getvalue(), runs


def run_port(module, monkeypatch, rounds, argv=()):
    """The port's example from the reference's seed-0 init: (stdout,
    results in run order)."""
    monkeypatch.setattr(module, "build_model",
                        lambda cfg: port_model(ref_init(0)))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = module.main(["--device", "cpu", *argv], max_rounds=rounds)
    return out.getvalue(), (list(res.values()) if isinstance(res, dict)
                            else [res])


def hold_example(name, module, monkeypatch, rounds, argv=()):
    want_out, ref_runs = run_reference(name, monkeypatch, rounds, argv)
    with one_thread():
        got_out, port_runs = run_port(module, monkeypatch, rounds, argv)
    assert len(port_runs) == len(ref_runs) > 0
    for (ref, ref_params), port in zip(ref_runs, port_runs):
        hold_pair(ref, ref_params, port)
        assert 0 < port.pi.shape[0] <= rounds
        assert (port.pi.sum(1) == port.pi.sum(1)[0]).all()
    assert got_out.splitlines() == want_out.splitlines()
    return port_runs


def test_wireless_scheduling_prints_the_reference_output(capsys):
    runpy.run_path(os.path.join(EXAMPLES, "wireless_scheduling.py"),
                   run_name="__main__")
    want = capsys.readouterr().out
    res = wireless_scheduling.main(["--device", "cpu"])
    assert capsys.readouterr().out == want
    assert res["pi"].shape == (12, 8) and res["round_time_opt"] <= \
        res["round_time_eq"]


def test_quickstart_matches_reference(monkeypatch):
    (res,) = hold_example("quickstart", quickstart, monkeypatch, rounds=3)
    assert set(res.pi.sum(1).tolist()) == {5}
    assert res.losses[-1] < res.losses[0]


def test_compare_algorithms_matches_reference(monkeypatch):
    runs = hold_example("compare_algorithms", compare_algorithms,
                        monkeypatch, rounds=1)
    assert len(runs) == len(compare_algorithms.ALGORITHMS)


@pytest.mark.parametrize("module,argv", [
    (mobile_edge, ()), (hetero_cells, ("fl.participants_per_round=5",))],
    ids=["mobile_edge", "hetero_cells"])
def test_mobile_examples_match_reference(module, argv, monkeypatch):
    name = module.__name__.rsplit(".", 1)[1]
    runs = hold_example(name, module, monkeypatch, 3, argv)
    a = 5 if argv else 6
    for r in runs:           # a hierarchy's edge rounds close at ⌈A / cells⌉
        assert set(r.pi.sum(1).tolist()) == {-(-a // r.n_cells)}
    if module is mobile_edge:
        assert runs[2].cloud_rounds > 0 and runs[2].n_cells == 3


def test_serve_personalized_matches_reference(monkeypatch, capsys):
    cfg = dataclasses.replace(ref_get_config("yi_6b").reduced(),
                              vocab_size=512, dtype="float32")
    ref = ref_build_model(cfg)
    params = jax.tree.map(np.asarray, ref.init(jax.random.PRNGKey(0)))
    loss_fn = jax.jit(lambda p, b: ref.loss(p, b)[0])
    adapt = jax.jit(lambda p, b: ref_adapt(ref.loss, p, b, alpha=0.05))
    users = [ref_corpus(4096, vocab=cfg.vocab_size, seed=s) for s in (10, 11)]

    def batch(corpus, off):
        idx = np.arange(8)[:, None] * 64 + off + np.arange(64)
        return {"tokens": jnp.asarray(corpus[idx]),
                "targets": jnp.asarray(corpus[idx + 1])}

    want_meta, want_adapted = [], []
    for corpus in users:
        query = batch(corpus, 2048)
        want_meta.append(float(loss_fn(params, query)))
        p_ad = adapt(params, batch(corpus, 0))
        want_adapted.append(float(loss_fn(p_ad, query)))

    real = serve_personalized.build_model

    def carried(mcfg):
        model = real(mcfg)
        model.init = lambda gen: from_numpy_tree(params, "cpu")
        return model

    monkeypatch.setattr(serve_personalized, "build_model", carried)
    monkeypatch.setattr(serve_personalized, "get_config",
                        lambda arch: dataclasses.replace(
                            port_get_config(arch), dtype="float32"))
    with one_thread():
        res = serve_personalized.main(["--device", "cpu"])
    out = capsys.readouterr().out
    np.testing.assert_allclose(res["meta_losses"], want_meta, rtol=1e-5)
    np.testing.assert_allclose(res["adapted_losses"], want_adapted,
                               rtol=1e-5)
    assert all(a < m for a, m in zip(res["adapted_losses"],
                                     res["meta_losses"]))
    assert tuple(res["tokens"].shape) == (4, 16)
    assert res["tokens"].dtype == torch.int32
    assert "batched serve: 4 requests × 16 tokens" in out
