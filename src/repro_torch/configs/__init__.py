"""Config registry of the port: the paper's own models.

The LM zoo's configs (``starcoder2_15b`` … ``recurrentgemma_2b``) are not
ported yet; asking for one raises ``NotImplementedError`` (ROADMAP queue 1,
model zoo).
"""
from __future__ import annotations

from repro_torch.config import ModelConfig

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
}

_LM_ZOO = ("starcoder2_15b", "mixtral_8x22b", "deepseek_67b", "mamba2_370m",
           "musicgen_large", "llama32_vision_11b", "deepseek_v2_236b",
           "nemotron4_15b", "yi_6b", "recurrentgemma_2b")


def get_config(arch: str) -> ModelConfig:
    name = arch.replace("-", "_").replace(".", "")
    if name in CONFIGS:
        return CONFIGS[name]
    if name in _LM_ZOO or arch in _LM_ZOO:
        raise NotImplementedError(
            f"{arch!r} belongs to the LM zoo, not ported yet "
            f"(ROADMAP queue 1, model zoo)")
    raise ValueError(f"unknown arch {arch!r}; have {sorted(CONFIGS)}")
