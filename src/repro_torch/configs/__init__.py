"""Config registry of the port: the paper's own models and the ported
part of the LM zoo.

The LM configs are literal copies of the JAX package's
``configs/<arch>.py`` files (``yi_6b``, ``mamba2_370m``, ``starcoder2_15b``,
``nemotron4_15b``, ``deepseek_67b``, ``recurrentgemma_2b``).  The rest of
the zoo (``mixtral_8x22b``, ``deepseek_v2_236b``, ``llama32_vision_11b``,
``musicgen_large``) is not ported yet; asking for one raises
``NotImplementedError`` (ROADMAP queue 1, model zoo).  The reference's
hyphenated aliases (``nemotron-4-15b``, ...) name the same configs.
"""
from __future__ import annotations

from repro_torch.config import HybridConfig, ModelConfig, SSMConfig

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
    # StarCoder2-15B — dense, GQA (48H/4KV), RoPE. [arXiv:2402.19173]
    "starcoder2_15b": ModelConfig(
        name="starcoder2-15b",
        family="dense",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=4,
        d_ff=24576,
        vocab_size=49152,
        max_seq_len=16384,
        attention="gqa",
        rope_theta=1e5,
        activation="gelu",
        long_context_window=4096,   # sliding-window variant for long_500k
        source="arXiv:2402.19173",
    ),
    # Nemotron-4-15B — dense, GQA (48H/8KV), squared-ReLU MLP.
    # [arXiv:2402.16819]
    "nemotron4_15b": ModelConfig(
        name="nemotron-4-15b",
        family="dense",
        num_layers=32,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=24576,
        vocab_size=256000,
        max_seq_len=4096,
        attention="gqa",
        rope_theta=1e4,
        activation="sq_relu",       # squared-ReLU, non-gated MLP
        long_context_window=4096,
        source="arXiv:2402.16819",
    ),
    # DeepSeek-67B — dense llama-arch, GQA (64H/8KV). [arXiv:2401.02954]
    "deepseek_67b": ModelConfig(
        name="deepseek-67b",
        family="dense",
        num_layers=95,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=22016,
        vocab_size=102400,
        max_seq_len=4096,
        attention="gqa",
        rope_theta=1e4,
        activation="silu",
        long_context_window=4096,
        source="arXiv:2401.02954",
    ),
    # RecurrentGemma-2B — RG-LRU + local attention (2 recurrent : 1 attn).
    # [arXiv:2402.19427]
    "recurrentgemma_2b": ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        num_layers=26,
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,             # MQA for the local-attention blocks
        d_ff=7680,
        vocab_size=256000,
        max_seq_len=1048576,        # unbounded in principle (fixed-size state)
        attention="gqa",
        rope_theta=1e4,
        activation="gelu",
        hybrid=HybridConfig(lru_width=2560, attention_window=2048,
                            pattern=("rglru", "rglru", "attn")),
        source="arXiv:2402.19427",
    ),
}

_LM_ZOO = ("mixtral_8x22b", "musicgen_large", "llama32_vision_11b",
           "deepseek_v2_236b")

# the reference's hyphenated ids that the rule below does not map
ALIASES = {"nemotron-4-15b": "nemotron4_15b",
           "llama-3.2-vision-11b": "llama32_vision_11b"}


def get_config(arch: str) -> ModelConfig:
    name = ALIASES.get(arch, arch.replace("-", "_").replace(".", ""))
    if name in CONFIGS:
        return CONFIGS[name]
    if name in _LM_ZOO or arch in _LM_ZOO:
        raise NotImplementedError(
            f"{arch!r} belongs to the LM zoo, not ported yet "
            f"(ROADMAP queue 1, model zoo)")
    raise ValueError(f"unknown arch {arch!r}; have {sorted(CONFIGS)}")
