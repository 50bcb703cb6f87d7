"""Configuration system.

Every experiment is described by a tree of frozen dataclasses:

  ``ExperimentConfig``
    ├── ``ModelConfig``     — architecture hyperparameters (family-dispatch)
    ├── ``FLConfig``        — PerFedS² / FL hyperparameters (A, S, n_ues, α, β, ...)
    ├── ``WirelessConfig``  — mobile-edge channel parameters (Table I of the paper)
    ├── ``ObsConfig``       — telemetry / tracing / reporting (src/repro/obs)
    ├── ``TrainConfig``     — optimizer / batching / steps
    └── ``MeshConfig``      — device mesh + sharding knobs

A copy of the JAX package's ``config.py``, so configurations mean the same
in both packages.  CLI overrides are dotted ``key=value`` pairs parsed by
``apply_overrides``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Any, Optional, Tuple


# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts sub-config (used when ModelConfig.family == 'moe')."""
    num_experts: int = 8
    experts_per_token: int = 2
    num_shared_experts: int = 0          # DeepSeek-V2 style shared experts
    expert_d_ff: int = 0                 # per-expert FFN width (0 → use d_ff)
    router_aux_loss_coef: float = 0.01
    router_jitter: float = 0.0
    capacity_factor: float = 1.25        # expert capacity for dropless=False paths


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2)."""
    kv_lora_rank: int = 512
    q_lora_rank: int = 0                 # 0 → full-rank queries
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) sub-config."""
    state_dim: int = 128                 # N — SSM state size
    head_dim: int = 64                   # P — channels per SSD head
    num_heads: int = 0                   # 0 → derived as d_inner // head_dim
    expand: int = 2                      # d_inner = expand * d_model
    chunk_size: int = 256                # SSD chunk length
    conv_width: int = 4                  # depthwise conv kernel


@dataclass(frozen=True)
class HybridConfig:
    """RecurrentGemma-style hybrid (RG-LRU + local attention)."""
    lru_width: int = 0                   # 0 → d_model
    attention_window: int = 2048
    pattern: Tuple[str, ...] = ("rglru", "rglru", "attn")   # 1:2 attn:recurrent


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description.

    ``family`` dispatches the model builder:
      dense  — decoder-only transformer (GQA/RoPE; covers llama-style, sq-relu, SWA)
      moe    — dense skeleton + MoE FFN (mixtral / deepseek-v2 w/ MLA)
      ssm    — Mamba-2 SSD stack (attention-free)
      hybrid — RG-LRU + local attention interleave
      vlm    — dense text decoder + cross-attention image layers (frontend stubbed)
      audio  — dense decoder over codec-frame embeddings (frontend stubbed)
      small  — the paper's own models (mnist_dnn / lenet5 / char_lstm)
    """
    name: str = "unnamed"
    family: str = "dense"
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0                    # 0 → d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 32000
    max_seq_len: int = 8192
    # --- attention flavour ---
    attention: str = "gqa"               # gqa | mla | none
    rope_theta: float = 10000.0
    sliding_window: int = 0              # 0 → full attention (SWA archs set this)
    long_context_window: int = 4096      # window used by the long_500k sliding variant
    cross_attn_every: int = 0            # vlm: insert cross-attn layer every N layers
    num_image_tokens: int = 0            # vlm: stubbed patch-embedding count
    num_audio_codebooks: int = 0         # audio: EnCodec codebooks (delay-interleaved)
    # --- FFN flavour ---
    activation: str = "silu"             # silu | gelu | sq_relu
    # --- norms / embeddings ---
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    # --- sub-configs ---
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # --- numerics ---
    dtype: str = "bfloat16"              # activation/param dtype
    remat: bool = True                   # activation checkpointing per layer
    scan_layers: bool = True             # lax.scan over homogeneous layer stacks
    attn_impl: str = "xla"               # xla | pallas
    attn_cast_f32: bool = True           # baseline: materialise k/v in f32;
                                         # False = bf16 reads + f32 MXU accum
                                         # (§Perf lever — halves decode traffic)
    # --- citation for provenance ---
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def reduced(self, max_d_model: int = 256, num_layers: int = 2,
                max_experts: int = 4, vocab: int = 512) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests."""
        d = min(self.d_model, max_d_model)
        if self.hybrid is not None:
            # keep ≥ one full (rec, rec, attn) group
            num_layers = max(num_layers, len(self.hybrid.pattern))
        heads = max(1, min(self.num_heads, 4))
        kv = max(1, min(self.num_kv_heads, heads))
        while heads % kv:
            kv -= 1
        kw: dict = dict(
            num_layers=num_layers, d_model=d, num_heads=heads, num_kv_heads=kv,
            head_dim=0, d_ff=min(self.d_ff, 4 * d) or 0,
            vocab_size=min(self.vocab_size, vocab), max_seq_len=512,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            long_context_window=64, remat=False,
            name=self.name + "-smoke",
        )
        if self.moe is not None:
            kw["moe"] = replace(
                self.moe,
                num_experts=min(self.moe.num_experts, max_experts),
                experts_per_token=min(self.moe.experts_per_token, 2),
                num_shared_experts=min(self.moe.num_shared_experts, 1),
                expert_d_ff=(min(self.moe.expert_d_ff, 2 * d)
                             if self.moe.expert_d_ff else 0),
                capacity_factor=max(self.moe.capacity_factor, 8.0),  # dropless
            )
        if self.mla is not None:
            kw["mla"] = replace(
                self.mla, kv_lora_rank=min(self.mla.kv_lora_rank, 64),
                qk_rope_head_dim=16, qk_nope_head_dim=32, v_head_dim=32,
                q_lora_rank=0,
            )
        if self.ssm is not None:
            kw["ssm"] = replace(
                self.ssm, state_dim=min(self.ssm.state_dim, 32),
                head_dim=min(self.ssm.head_dim, 32), num_heads=0, chunk_size=32,
            )
        if self.hybrid is not None:
            kw["hybrid"] = replace(
                self.hybrid, lru_width=0,
                attention_window=min(self.hybrid.attention_window, 64),
            )
        if self.cross_attn_every:
            kw["cross_attn_every"] = min(self.cross_attn_every, 2)
            kw["num_image_tokens"] = min(self.num_image_tokens or 16, 16)
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# FL / PerFedS² configuration
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FLConfig:
    """Paper hyperparameters (Table I + Alg. 1/2)."""
    algorithm: str = "perfed"            # fedavg | fedprox | perfed
    mode: str = "semi"                   # sync | semi | async
    n_ues: int = 20
    participants_per_round: int = 5      # A
    staleness_bound: int = 5             # S
    rounds: int = 100                    # K
    alpha: float = 0.03                  # inner (adaptation) lr
    alpha_spread: float = 0.0            # per-UE α_i ∈ α·[1/(1+s), 1+s]
    beta: float = 0.07                   # global step size
    local_batch_size: int = 32
    local_epochs: int = 1                # E for fedavg-style local work
    prox_mu: float = 0.1                 # FedProx proximal coefficient
    first_order: bool = False            # FO-MAML (drop Hessian term)
    pfedme_lambda: float = 15.0          # pFedMe Moreau-envelope strength [11]
    pfedme_steps: int = 5                # inner solver steps for θ̂(w)
    staleness_discount: float = 1.0      # λ^τ payload weighting (SAFA/FedSA
                                         # style, refs [20][21]); 1.0 = paper
    hessian_batch: int = 32              # |D_h|
    outer_batch: int = 32                # |D_o|
    inner_batch: int = 32                # |D_in|
    eta_mode: str = "equal"              # equal | distance
    seed: int = 0


@dataclass(frozen=True)
class WirelessConfig:
    """Table I of the paper."""
    total_bandwidth_hz: float = 1e6      # B = 1 MHz
    path_loss_exp: float = 3.8           # κ
    noise_dbm_per_hz: float = -174.0     # N0
    tx_power_w: float = 0.01             # p_i
    cell_radius_m: float = 200.0
    rayleigh_scale: float = 40.0         # paper's Rayleigh parameter
    grad_bits: float = 0.0               # Z: 0 → derived from model size
    bits_per_param: int = 32             # payload precision (16 = fp16 uploads)
    cpu_cycles_per_sample: float = 2e5   # c_i
    cpu_freq_hz: float = 1e9             # ϑ_i nominal (heterogeneity multiplies this)
    cpu_hetero: float = 4.0              # max/min CPU speed ratio across UEs
    # fading RNG stream for cycle pricing:
    #   legacy  — per-requeue [k, n] Rayleigh matrix off the main numpy
    #             stream, bitwise identical to the original per-UE loop
    #             (the parity-suite reference);
    #   counter — lane-indexed counter-based draws (splitmix64 → inverse
    #             Rayleigh CDF), O(k) per requeue independent of n.  Same
    #             marginal distribution, different bitstream — goldens for
    #             this stream are pinned separately.
    rng: str = "legacy"                  # legacy | counter


@dataclass(frozen=True)
class MobilityConfig:
    """Mobile multi-cell edge extension (``src/repro/mobility``).

    ``enabled=False`` keeps the original single-static-cell path untouched;
    the degenerate mobile configuration (speed 0, one cell, hierarchy off)
    reproduces it bitwise (pinned by ``tests/test_mobility.py``).
    """
    enabled: bool = False
    model: str = "random_waypoint"       # static | random_waypoint | gauss_markov
    speed_mps: float = 1.0               # mean UE speed; ≤ 0 → static
    pause_s: float = 0.0                 # random-waypoint pause at each waypoint
    gm_alpha: float = 0.85               # Gauss-Markov memory parameter
    step_s: float = 1.0                  # mobility integration step [simulated s]
    n_cells: int = 1                     # base stations (hex-ish layout)
    hierarchy: bool = False              # per-cell edge servers + cloud tier
    cloud_sync_every: int = 5            # cloud merge every N edge rounds
    cell_participants: int = 0           # per-cell A (0 → ceil(A / n_cells))
    # --- heterogeneous per-cell radio resources ------------------------
    # per-BS uplink budget [Hz]: () → every cell owns the full
    # wireless.total_bandwidth_hz (legacy); one value → broadcast to all
    # cells; else one entry per cell (macro/micro mixes)
    cell_bandwidth_hz: Tuple[float, ...] = ()
    association: str = "nearest"         # nearest | load_aware
    # load_aware: extra effective metres per unit of relative cell load
    # (members / fair share, budget-normalised) — hot cells shed UEs
    load_penalty_m: float = 50.0
    # association refresh strategy: "safe_radius" re-scores only UEs whose
    # displacement since their last score exceeds their handover margin
    # (bitwise-identical results, amortized O(n) per tick); "full" forces
    # the legacy [n, k] recompute every tick (exactness reference)
    reassoc: str = "safe_radius"


@dataclass(frozen=True)
class ScenarioConfig:
    """Open-world traffic/churn dynamics (``src/repro/fl/scenario.py``).

    ``enabled=False`` (default) keeps the closed-world simulator: an
    immortal, stationary UE population, bitwise identical to every
    pre-scenario golden.  ``enabled=True`` turns the UE pool open: a
    Poisson arrival process activates dormant UEs mid-run (they are
    priced and queued like any other cycle), a per-UE departure hazard
    deactivates them (their in-flight upload cancels through the
    driver's epoch mechanism), the arrival intensity can carry a diurnal
    wave and a flash-crowd window (which also retargets a fraction of
    random-waypoint UEs at a hotspot cell), and each UE's label
    distribution can drift over simulated time.

    All scenario randomness comes from one auxiliary stream seeded by
    ``(sim seed, scenario seed)`` — enabling a scenario never perturbs
    the fading / mobility / payload RNG schedules.
    """
    enabled: bool = False
    # --- population ----------------------------------------------------
    # fraction of the UE pool active at t=0 (the rest is the dormant
    # pool Poisson arrivals draw from; always at least one UE active)
    initial_active_frac: float = 1.0
    # --- Poisson churn -------------------------------------------------
    arrival_rate: float = 0.0        # expected UE joins per simulated second
    departure_rate: float = 0.0      # per-active-UE departure hazard [1/s]
    min_active: int = 1              # departures never go below this
    horizon_s: float = 0.0           # no churn events after this (0 → unbounded)
    # --- diurnal load wave: λ(t) *= 1 + amp·sin(2π t / period) ---------
    diurnal_amplitude: float = 0.0   # in [0, 1]
    diurnal_period_s: float = 0.0    # 0 → no wave
    # --- flash crowd ---------------------------------------------------
    flash_time_s: float = -1.0       # window start (< 0 → no flash)
    flash_duration_s: float = 0.0
    flash_arrival_boost: float = 1.0  # λ multiplier inside the window
    flash_hotspot_cell: int = 0      # BS whose vicinity is the hotspot
    # fraction of active random-waypoint UEs retargeted at the hotspot
    flash_hotspot_frac: float = 0.0
    # --- non-stationary label drift ------------------------------------
    drift_rate: float = 0.0          # per-active-UE drift hazard [1/s]
    drift_frac: float = 0.3          # fraction of samples remapped per event
    # --- protocol under churn ------------------------------------------
    # clamp each cell's effective round size A to its live membership so
    # a cell that shrinks below A keeps closing (smaller) rounds instead
    # of live-locking; False reproduces the frozen-A legacy behaviour
    # (the stall is then surfaced via SimResult.aborted_rounds)
    adaptive_cell_a: bool = True
    seed: int = 0                    # scenario stream (auxiliary)


@dataclass(frozen=True)
class ObsConfig:
    """Observability (``src/repro/obs``): tracing, telemetry, reporting.

    Everything here is read-only instrumentation — enabling it never
    changes a trajectory (goldens are pinned with tracing fully on).
    ``run_simulation``'s ``tracer``/``trace_dir``/``reporter`` kwargs
    override these per call.
    """
    # progress reporting level: quiet | progress | debug.  The legacy
    # ``verbose=True`` kwarg maps to "progress" (same output, same text)
    report: str = "quiet"
    trace: bool = False                  # collect phase spans + counters
    trace_dir: str = ""                  # per-round JSONL (implies trace)
    # block on every engine dispatch / protocol feed and attribute the
    # time as device seconds (host = wall − device); synchronizes, so
    # leave off when measuring end-to-end throughput
    device_timing: bool = False
    profile_dir: str = ""                # jax.profiler trace → TensorBoard


@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "adam"              # server-side optimizer for at-scale path
    learning_rate: float = 3e-4
    weight_decay: float = 0.0
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_clip: float = 1.0
    seq_len: int = 4096
    global_batch_size: int = 256
    microbatch: int = 0                  # 0 → no gradient accumulation
    adam_b1: float = 0.9
    adam_b2: float = 0.95
    adam_eps: float = 1e-8
    param_dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"


@dataclass(frozen=True)
class MeshConfig:
    multi_pod: bool = False
    data_axis: int = 16
    model_axis: int = 16
    pods: int = 2
    # sharding strategy knobs (perf-iteration levers)
    shard_params_over_data: bool = True   # ZeRO-3 / FSDP-style 2-D param sharding
    shard_moe_experts: bool = True        # experts → model axis
    decode_cache_axis: str = "auto"       # auto | batch | sequence

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.multi_pod else ("data", "model")

    @property
    def shape(self) -> Tuple[int, ...]:
        if self.multi_pod:
            return (self.pods, self.data_axis, self.model_axis)
        return (self.data_axis, self.model_axis)


@dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""
    name: str = "train_4k"
    seq_len: int = 4096
    global_batch: int = 256
    kind: str = "train"                  # train | prefill | decode


@dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    fl: FLConfig = field(default_factory=FLConfig)
    wireless: WirelessConfig = field(default_factory=WirelessConfig)
    mobility: MobilityConfig = field(default_factory=MobilityConfig)
    scenario: ScenarioConfig = field(default_factory=ScenarioConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)


# ---------------------------------------------------------------------------
# CLI overrides
# ---------------------------------------------------------------------------

def apply_overrides(cfg: Any, overrides: dict[str, str]) -> Any:
    """Apply dotted-path string overrides to a dataclass tree.

    ``apply_overrides(cfg, {"fl.participants_per_round": "10"})``
    """
    for path, raw in overrides.items():
        parts = path.split(".")
        cfg = _set_path(cfg, parts, raw)
    return cfg


def _coerce(raw: str, old: Any) -> Any:
    if isinstance(old, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(old, int):
        return int(raw)
    if isinstance(old, float):
        return float(raw)
    if isinstance(old, tuple):
        def elem(x: str) -> Any:
            x = x.strip()
            try:                         # numeric tuples (cell_bandwidth_hz)
                return float(x)
            except ValueError:           # string tuples (hybrid.pattern)
                return x
        return tuple(elem(x) for x in raw.split(",") if x.strip())
    return raw


def _set_path(node: Any, parts: list[str], raw: str) -> Any:
    key = parts[0]
    if not dataclasses.is_dataclass(node):
        raise TypeError(f"cannot descend into non-dataclass at {key!r}")
    old = getattr(node, key)
    if len(parts) == 1:
        return replace(node, **{key: _coerce(raw, old)})
    return replace(node, **{key: _set_path(old, parts[1:], raw)})


def parse_cli_overrides(argv: list[str]) -> dict[str, str]:
    """Parse trailing ``a.b=c`` tokens from argv."""
    out: dict[str, str] = {}
    for tok in argv:
        if "=" in tok:
            k, v = tok.split("=", 1)
            out[k] = v
    return out
