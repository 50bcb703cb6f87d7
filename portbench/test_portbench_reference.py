"""The plain references against the port at reduced sizes on the CPU, in
float32: scoring for both families."""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from portbench import weights  # noqa: E402
from portbench.reference import audio_lm, mamba2  # noqa: E402

AUDIO = dict(family="audio", num_layers=2, d_model=32, num_heads=2,
             num_kv_heads=2, head_dim=0, d_ff=64, vocab_size=32,
             num_audio_codebooks=3, attention="gqa", rope_theta=10000.0,
             activation="gelu", norm="rmsnorm", dtype="float32",
             remat=False, attn_impl="pallas")
SSM = dict(family="ssm", num_layers=2, d_model=32, num_heads=0,
           num_kv_heads=0, d_ff=0, vocab_size=32, attention="none",
           ssm=dict(state_dim=8, head_dim=8, expand=2, chunk_size=8,
                    conv_width=4),
           norm="rmsnorm", dtype="float32", remat=False, attn_impl="pallas")


@pytest.fixture(scope="module")
def port():
    from portbench.harness import import_port
    return import_port(ROOT)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens(cfg, b, sl, seed):
    g = torch.Generator().manual_seed(seed)
    shape = (b, sl + 1) + ((cfg["num_audio_codebooks"],)
                           if cfg.get("num_audio_codebooks") else ())
    t = torch.randint(0, cfg["vocab_size"], shape, generator=g)
    return {"tokens": t[:, :-1], "targets": t[:, 1:]}


@pytest.mark.parametrize("cfg, ref", [
    (AUDIO, audio_lm), (SSM, mamba2), ({**SSM, "tie_embeddings": True},
                                       mamba2)],
    ids=["audio", "mamba2", "mamba2-tied"])
def test_reference_loss_matches_port(port, cfg, ref):
    # 21 positions: a ragged last chunk for the scan
    model = port.build_model(port.model_config(cfg))
    params = weights.make_params(model.init(None, device="meta"), cfg, 5,
                                 "cpu")
    batch = _tokens(cfg, 2, 21, 6)
    with torch.no_grad():
        got = float(model.loss(params, batch)[0])
        want = float(ref.loss(params, batch, cfg))
    assert got == pytest.approx(want, rel=1e-5)


def test_dataclass_fields_cover_the_config_files(port):
    # every key of a configuration file that names a ModelConfig field
    # reaches the program
    import json
    from repro_torch.config import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    for path in (ROOT / "portbench" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        mc = port.model_config(cfg)
        for k in names & set(cfg):
            v = getattr(mc, k)
            if k == "ssm":
                v = {key: getattr(v, key) for key in cfg[k]}
            assert v == cfg[k], k
