"""Config registry of the port: the paper's own models, ``yi_6b`` and
``mamba2_370m``.

``yi_6b`` and ``mamba2_370m`` are literal copies of the JAX package's
``configs/yi_6b.py`` and ``configs/mamba2_370m.py``.  The rest of the LM
zoo (``starcoder2_15b`` … ``recurrentgemma_2b``) is not ported yet; asking
for one raises ``NotImplementedError`` (ROADMAP queue 1, model zoo).
"""
from __future__ import annotations

from repro_torch.config import ModelConfig, SSMConfig

CONFIGS = {
    # 2-layer DNN with hidden size 100 for MNIST (Sec. VI-A)
    "mnist_dnn": ModelConfig(
        name="mnist_dnn", family="small", num_layers=2, d_model=100,
        vocab_size=10, dtype="float32", source="paper Sec. VI-A (MNIST)"),
    # LeNet-5 for CIFAR-100 (Sec. VI-A)
    "lenet5": ModelConfig(
        name="lenet5", family="small", num_layers=5, d_model=120,
        vocab_size=100, dtype="float32",
        source="paper Sec. VI-A (CIFAR-100), LeCun et al. 1998"),
    # LSTM next-character classifier for Shakespeare (Sec. VI-A)
    "char_lstm": ModelConfig(
        name="char_lstm", family="small", num_layers=1, d_model=256,
        vocab_size=80, dtype="float32",
        source="paper Sec. VI-A (Shakespeare), LEAF benchmark"),
    # Yi-6B — dense llama-arch, GQA (32H/4KV). [arXiv:2403.04652]
    "yi_6b": ModelConfig(
        name="yi-6b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        d_ff=11008,
        vocab_size=64000,
        max_seq_len=4096,
        attention="gqa",
        rope_theta=5e6,
        activation="silu",
        long_context_window=4096,
        source="arXiv:2403.04652",
    ),
    # Mamba2-370M — attention-free SSD (state-space duality).
    # [arXiv:2405.21060]
    "mamba2_370m": ModelConfig(
        name="mamba2-370m",
        family="ssm",
        num_layers=48,
        d_model=1024,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,                 # attention-free, no separate FFN
        vocab_size=50280,
        max_seq_len=1048576,
        attention="none",
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk_size=256,
                      conv_width=4),
        source="arXiv:2405.21060",
    ),
}

_LM_ZOO = ("starcoder2_15b", "mixtral_8x22b", "deepseek_67b", "musicgen_large",
           "llama32_vision_11b", "deepseek_v2_236b", "nemotron4_15b",
           "recurrentgemma_2b")


def get_config(arch: str) -> ModelConfig:
    name = arch.replace("-", "_").replace(".", "")
    if name in CONFIGS:
        return CONFIGS[name]
    if name in _LM_ZOO or arch in _LM_ZOO:
        raise NotImplementedError(
            f"{arch!r} belongs to the LM zoo, not ported yet "
            f"(ROADMAP queue 1, model zoo)")
    raise ValueError(f"unknown arch {arch!r}; have {sorted(CONFIGS)}")
