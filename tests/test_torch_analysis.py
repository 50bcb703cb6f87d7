"""The port's simlint (``repro_torch.analysis``): rule fixtures and the gate.

The fixtures of ``tests/test_simlint.py`` recast for the port: each seeds
one violation and asserts the exact rule code and line; negative twins
assert the idiomatic form stays clean.  The JAX key rules (SIM101, SIM102)
become ``torch.Generator`` discipline, the host-sync rules (SIM2xx) read
torch, and the purity rules (SIM3xx) patrol what ``torch.func`` transforms
and autograd Functions run.  The last tests run the checker over the
port's tree with ``simlint-torch-baseline.json``: no active finding, no
stale entry, every entry justified.
"""
from pathlib import Path

import pytest

from repro_torch.analysis import Baseline, lint_text
from repro_torch.analysis.cli import main as cli_main
from repro_torch.analysis.core import (DEFAULT_BASELINE_NAME,
                                       find_repo_root, run_paths)

SRC = "src/repro_torch/fl/somemod.py"    # a library path (rules scoped on)
HOT = "src/repro_torch/fl/driver.py"     # a hot-path module for SIM2xx
OBS = "src/repro_torch/obs/somemod.py"


def codes_at(findings, code):
    return [f.line for f in findings if f.code == code
            and f.status == "active"]


# ----------------------------------------------------------------------
# SIM1xx — RNG discipline
# ----------------------------------------------------------------------
@pytest.mark.parametrize("call", [
    "torch.randn(3)", "torch.rand(3)", "torch.randint(0, 5, (3,))",
    "torch.randperm(5)", "torch.multinomial(w, 2)", "torch.bernoulli(w)",
    "w.normal_()", "torch.manual_seed(s)"])
def test_sim101_global_rng_flagged(call):
    snippet = ("import torch\n"
               "def f(w, s):\n"
               f"    return {call}\n")
    assert codes_at(lint_text(snippet, SRC), "SIM101") == [3]


def test_sim101_generator_draws_are_clean():
    snippet = ("import torch\n"
               "def f(w, gen):\n"
               "    a = torch.randn(3, generator=gen)\n"
               "    b = torch.multinomial(w, 2, generator=gen)\n"
               "    return a, b, w.normal_(generator=gen)\n")
    assert codes_at(lint_text(snippet, SRC), "SIM101") == []


def test_sim101_sees_through_import_alias():
    snippet = ("from torch import randn as rn\n"
               "def f():\n"
               "    return rn(3)\n")
    assert codes_at(lint_text(snippet, SRC), "SIM101") == [3]


def test_sim101_tests_are_exempt():
    snippet = "import torch\ntorch.manual_seed(0)\nx = torch.randn(3)\n"
    assert codes_at(lint_text(snippet, "tests/test_x.py"), "SIM101") == []


def test_sim102_literal_seed_flagged_in_library():
    snippet = ("import torch\n"
               "def init():\n"
               "    return torch.Generator().manual_seed(0)\n")
    assert codes_at(lint_text(snippet, SRC), "SIM102") == [3]


def test_sim102_config_seed_is_clean():
    snippet = ("import torch\n"
               "def init(seed):\n"
               "    return torch.Generator().manual_seed(seed)\n")
    assert codes_at(lint_text(snippet, SRC), "SIM102") == []


def test_sim103_np_random_flagged_and_outside_exempt():
    snippet = ("import numpy as np\n"
               "def f(seed):\n"
               "    return np.random.default_rng(seed)\n")
    assert codes_at(lint_text(snippet, SRC), "SIM103") == [3]
    assert codes_at(lint_text(snippet, "benchmarks/b.py"), "SIM103") == []
    assert codes_at(lint_text("import random\n", SRC), "SIM103") == [1]


def test_sim104_conditional_draw_flagged():
    snippet = ("import torch\n"
               "def step(rng, gen, moving):\n"
               "    if moving:\n"
               "        return rng.uniform(size=4)\n"
               "    x = torch.rand(2, generator=gen) if moving else None\n"
               "    return x\n")
    assert codes_at(lint_text(snippet, SRC), "SIM104") == [4, 5]


def test_sim104_unconditional_draw_is_clean():
    snippet = ("import torch\n"
               "def step(rng, gen):\n"
               "    return rng.uniform(size=4), torch.rand(2, generator=gen)\n")
    assert codes_at(lint_text(snippet, SRC), "SIM104") == []


# ----------------------------------------------------------------------
# SIM2xx — host syncs in hot-path modules
# ----------------------------------------------------------------------
def test_sim201_item_flagged_in_hot_path_only():
    snippet = ("import torch\n"
               "def f(x):\n"
               "    return x.sum().item(), x.tolist()\n")
    assert codes_at(lint_text(snippet, HOT), "SIM201") == [3, 3]
    assert codes_at(lint_text(snippet, SRC), "SIM201") == []


def test_sim202_host_materialisation_flagged_and_suppressible():
    snippet = ("import numpy as np\n"
               "import torch\n"
               "def f(x):\n"
               "    a = x.cpu().numpy()\n"
               "    b = np.asarray(x)\n"
               "    c = x.cpu()  # simlint: disable=SIM202 -- host copy\n"
               "    return a, b, c\n")
    found = lint_text(snippet, HOT)
    assert codes_at(found, "SIM202") == [4, 5]
    assert [f.line for f in found if f.status == "suppressed"] == [6]


def test_sim203_scalar_coercion_flagged_metadata_clean():
    snippet = ("import torch\n"
               "def f(x):\n"
               "    a = float(torch.sum(x))\n"
               "    b = int(torch.zeros(3).shape[0])\n"
               "    return a, b\n")
    assert codes_at(lint_text(snippet, HOT), "SIM203") == [3]


# ----------------------------------------------------------------------
# SIM3xx — purity under torch.func and in autograd Functions
# ----------------------------------------------------------------------
def test_sim301_print_in_fn_handed_to_grad():
    snippet = ("from torch.func import grad\n"
               "def loss(p):\n"
               "    print(p)\n"
               "    return (p * p).sum()\n"
               "g = grad(loss)\n")
    assert codes_at(lint_text(snippet, SRC), "SIM301") == [3]


def test_sim301_reaches_through_lambda_and_call_graph():
    snippet = ("import torch\n"
               "def inner(p):\n"
               "    print('x')\n"
               "    return p\n"
               "def untraced(p):\n"
               "    print('fine')\n"
               "f = torch.func.vmap(lambda p: inner(p))\n")
    assert codes_at(lint_text(snippet, SRC), "SIM301") == [3]


def test_sim302_clock_in_autograd_function_forward():
    snippet = ("import time\n"
               "import torch\n"
               "class Op(torch.autograd.Function):\n"
               "    @staticmethod\n"
               "    def forward(ctx, x):\n"
               "        ctx.t0 = time.perf_counter()\n"
               "        return x\n"
               "    @staticmethod\n"
               "    def backward(ctx, g):\n"
               "        return g\n")
    found = lint_text(snippet, SRC)
    assert codes_at(found, "SIM302") == [6]
    assert codes_at(found, "SIM304") == []          # ctx is exempt


def test_sim303_tracer_span_in_jvp_fn():
    snippet = ("from repro_torch import obs\n"
               "from torch.func import jvp\n"
               "def f(p):\n"
               "    with obs.CURRENT.span('x'):\n"
               "        return p\n"
               "out = jvp(f, (1.0,), (1.0,))\n")
    assert codes_at(lint_text(snippet, SRC), "SIM303") == [4]


def test_sim304_nonlocal_and_container_mutation_flagged():
    snippet = ("from torch.func import vjp\n"
               "seen = []\n"
               "def f(p):\n"
               "    seen.append(p)\n"
               "    return p\n"
               "def g(p):\n"
               "    global seen\n"
               "    return p\n"
               "vjp(f, 1.0)\n"
               "vjp(g, 1.0)\n")
    assert codes_at(lint_text(snippet, SRC), "SIM304") == [4, 7]


def test_sim304_local_container_is_clean():
    snippet = ("from torch.func import grad\n"
               "def f(p):\n"
               "    out = []\n"
               "    out.append(p)\n"
               "    return out[0]\n"
               "grad(f)\n")
    assert codes_at(lint_text(snippet, SRC), "SIM304") == []


# ----------------------------------------------------------------------
# SIM4xx — obs stays read-only
# ----------------------------------------------------------------------
def test_sim401_obs_imports():
    bad = "from repro_torch.fl import driver\nimport repro.core\n"
    assert codes_at(lint_text(bad, OBS), "SIM401") == [1, 2]
    ok = "from repro_torch.utils import tree\nimport repro_torch.config\n"
    assert codes_at(lint_text(ok, OBS), "SIM401") == []


def test_sim402_obs_calling_mutator_flagged():
    snippet = "def f(net, t):\n    net.advance_to(t)\n"
    assert codes_at(lint_text(snippet, OBS), "SIM402") == [2]
    assert codes_at(lint_text(snippet, SRC), "SIM402") == []


# ----------------------------------------------------------------------
# suppression / baseline machinery, and the gate on the port's tree
# ----------------------------------------------------------------------
def test_suppression_same_line_and_file_wide():
    same_line = ("import torch\n"
                 "x = torch.randn(3)  # simlint: disable=SIM101 -- wanted\n")
    assert codes_at(lint_text(same_line, SRC), "SIM101") == []
    file_wide = ("# simlint: disable-file=SIM101\n"
                 "import torch\n"
                 "x = torch.randn(3)\n")
    assert codes_at(lint_text(file_wide, SRC), "SIM101") == []


def test_baseline_requires_justification(tmp_path):
    p = tmp_path / "baseline.json"
    p.write_text('{"entries": [{"file": "a.py", "code": "SIM103",'
                 ' "match": "x = 1", "why": ""}]}')
    with pytest.raises(ValueError):
        Baseline.load(p)


def test_port_baseline_entries_all_justified():
    root = find_repo_root(Path(__file__))
    assert DEFAULT_BASELINE_NAME == "simlint-torch-baseline.json"
    baseline = Baseline.load(root / DEFAULT_BASELINE_NAME)
    assert baseline.entries
    for e in baseline.entries:
        assert e.file.startswith("src/repro_torch/"), e.file
        assert len(e.why.strip()) > 10 and "TODO" not in e.why, \
            (e.file, e.code)


def test_port_tree_zero_active_findings(capsys):
    root = find_repo_root(Path(__file__))
    report = run_paths([root / "src" / "repro_torch"], repo_root=root,
                       baseline=Baseline.load(root / DEFAULT_BASELINE_NAME))
    assert report.errors == []
    assert [f.render() for f in report.active] == []
    assert [(e.file, e.code) for e in report.stale_baseline] == []
    assert {f.code[:4] for f in report.findings} >= {"SIM1", "SIM2",
                                                     "SIM3"}
    assert cli_main([str(root / "src" / "repro_torch"), "-q"]) == 0
    assert "0 active" in capsys.readouterr().out
