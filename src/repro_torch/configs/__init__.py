"""Config registry of the port: the paper's own models and the ported
part of the LM zoo.

The LM configs are literal copies of the JAX package's
``configs/<arch>.py`` files (``yi_6b``, ``mamba2_370m``, ``starcoder2_15b``,
``nemotron4_15b``, ``deepseek_67b``, ``recurrentgemma_2b``,
``mixtral_8x22b``, ``deepseek_v2_236b``, ``llama32_vision_11b``,
``musicgen_large``): the whole zoo.  The reference's hyphenated aliases
(``nemotron-4-15b``, ``mixtral-8x22b``, ``llama-3.2-vision-11b``, ...) name
the same configs.  ``SHAPES`` holds the reference's four input shapes, the
dry run's (``get_shape``).
"""
from __future__ import annotations

from repro_torch.config import (HybridConfig, MLAConfig, ModelConfig,
                                MoEConfig, ShapeConfig, SSMConfig)

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
    # Mixtral-8x22B — MoE 8 experts top-2, GQA (48H/8KV), SWA.
    # [arXiv:2401.04088]
    "mixtral_8x22b": ModelConfig(
        name="mixtral-8x22b",
        family="moe",
        num_layers=56,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        d_ff=16384,
        vocab_size=32768,
        max_seq_len=65536,
        attention="gqa",
        rope_theta=1e6,
        sliding_window=4096,        # native SWA → long_500k runs natively
        long_context_window=4096,
        activation="silu",
        moe=MoEConfig(num_experts=8, experts_per_token=2, expert_d_ff=16384),
        source="arXiv:2401.04088",
    ),
    # DeepSeek-V2-236B — MLA (kv_lora 512) + MoE 160 routed top-6 + 2
    # shared. [arXiv:2405.04434]
    "deepseek_v2_236b": ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        num_layers=60,
        d_model=5120,
        num_heads=128,
        num_kv_heads=128,           # MLA: all heads share the latent cache
        d_ff=1536,                  # routed expert width
        vocab_size=102400,
        max_seq_len=131072,
        attention="mla",
        rope_theta=1e4,
        activation="silu",
        moe=MoEConfig(num_experts=160, experts_per_token=6,
                      num_shared_experts=2, expert_d_ff=1536),
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, qk_rope_head_dim=64,
                      qk_nope_head_dim=128, v_head_dim=128),
        long_context_window=4096,
        source="arXiv:2405.04434",
    ),
    # Llama-3.2-11B-Vision — text decoder w/ cross-attn image layers
    # (vision frontend stubbed).  [hf:meta-llama/Llama-3.2-11B-Vision]
    "llama32_vision_11b": ModelConfig(
        name="llama-3.2-vision-11b",
        family="vlm",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=128256,
        max_seq_len=131072,
        attention="gqa",
        rope_theta=5e5,
        activation="silu",
        cross_attn_every=5,         # 8 cross-attention layers over 40 self layers
        num_image_tokens=1601,      # 1 tile × (40×40 patches + 1 cls)
        long_context_window=4096,
        source="hf:meta-llama/Llama-3.2-11B-Vision",
    ),
    # MusicGen-Large — decoder-only over EnCodec tokens (codec stubbed).
    # [arXiv:2306.05284]
    "musicgen_large": ModelConfig(
        name="musicgen-large",
        family="audio",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,            # full MHA
        d_ff=8192,
        vocab_size=2048,            # per-codebook EnCodec codebook size
        max_seq_len=32768,
        attention="gqa",
        activation="gelu",
        num_audio_codebooks=4,
        long_context_window=4096,
        source="arXiv:2306.05284",
    ),
}

SHAPES = {
    "train_4k": ShapeConfig("train_4k", seq_len=4096, global_batch=256,
                            kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32768, global_batch=32,
                               kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32768, global_batch=128,
                              kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524288, global_batch=1,
                             kind="decode"),
}

# the reference's hyphenated ids that the rule below does not map
ALIASES = {"nemotron-4-15b": "nemotron4_15b",
           "llama-3.2-vision-11b": "llama32_vision_11b"}


def get_config(arch: str) -> ModelConfig:
    name = ALIASES.get(arch, arch.replace("-", "_").replace(".", ""))
    if name in CONFIGS:
        return CONFIGS[name]
    raise ValueError(f"unknown arch {arch!r}; have {sorted(CONFIGS)}")


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]
