"""Unified model/shape configuration for the CHIME framework.

Every assigned architecture (plus the paper's own FastVLM/MobileVLM models)
is expressed as a ``ModelConfig``. The model zoo in ``repro_torch.models`` is fully
config-driven: a config describes the layer *segments* (repeated block
patterns), the mixer type per block (attention / MLA / rwkv6 / mamba2), the
MLP/MoE shape, and the modality frontend stub, so adding an architecture is
a config file, not a model file.
"""

from __future__ import annotations

import dataclasses
from typing import Literal, Optional

MixerType = Literal["attn", "mla", "rwkv6", "mamba2", "attn_shared"]
MlpType = Literal["gelu", "silu_gated", "gelu_gated", "relu2", "rwkv_cm", "moe"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0
    first_dense_layers: int = 0          # leading layers use a dense MLP
    d_ff_dense: int = 0                  # d_ff of those dense layers
    capacity_factor: float = 1.25
    router_jitter: float = 0.0


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0                 # 0 => full-rank Q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    # Mamba2 (SSD) parameters
    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk_size: int = 128
    # RWKV6 parameters
    rwkv_lora_rank: int = 64
    rwkv_decay_lora: int = 64


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Stub modality frontend: input_specs() provides precomputed patch/frame
    embeddings; the frontend here is a linear connector into the backbone."""
    kind: Literal["vision", "audio"]
    frontend_dim: int
    num_tokens: int                       # visual pseudo-tokens (vision only)
    connector: Literal["mlp", "linear"] = "mlp"


@dataclasses.dataclass(frozen=True)
class Segment:
    """A repeated block pattern: ``pattern`` lists the mixer type of each
    block in the unit; the unit repeats ``repeats`` times (scanned when
    homogeneous and config.scan_layers)."""
    pattern: tuple[MixerType, ...]
    repeats: int


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "vlm", "audio", "hybrid"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                     # 0 => d_model // num_heads
    segments: tuple[Segment, ...] = ()
    mlp_type: MlpType = "silu_gated"
    norm_type: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    pos_emb: Literal["rope", "learned", "none"] = "rope"
    rope_theta: float = 10_000.0
    use_attn_bias: bool = False
    use_mlp_bias: bool = False
    is_encoder: bool = False              # bidirectional, no decode step
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    frontend: Optional[FrontendConfig] = None
    # numerics / execution
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    scan_layers: bool = True
    remat: Literal["none", "full", "save_dots"] = "full"
    use_pallas_kernels: bool = False
    fsdp: bool = False                    # shard weight d_model dims over data
    seq_sharding: bool = False            # Megatron-SP on the residual stream
    mla_absorbed: bool = False            # MLA latent-space attention (§Perf)
    attn_scores_dtype: str = "float32"    # bf16 halves S^2 traffic (§Perf)
    moe_ff_fsdp: bool = False             # shard expert d_ff over 'data'
    #   instead of the embed dim: weights stay put and the (tiny) routed
    #   activations reduce instead — kills per-step expert-bank gathers
    vocab_pad_multiple: int = 256         # pad vocab for TP divisibility
    # CHIME technique knobs (core/planner consumes these)
    chime_enabled: bool = True
    kv_policy: Literal["flat", "tiered"] = "flat"
    kv_hot_window: int = 4096             # Tier-0 bf16 window (tokens)
    kv_cold_dtype: str = "int8"           # Tiers 1-3
    kv_frozen_dtype: str = "int8"         # Tier-4 "RRAM" write-once tier
    ffn_weight_store: Literal["native", "int8"] = "native"  # "RRAM" weights
    max_decode_len: int = 512
    # fused paged-decode attention (kernels/paged_decode.py): opt-in; the
    # unfused two-segment merge stays the parity oracle. Also settable at
    # serving time via REPRO_SERVE_FUSED_DECODE / REPRO_SERVE_SPARSE_READ.
    fused_decode: bool = False
    sparse_read_tau: float = 0.0          # SLIM-style skip threshold; 0=off
    # RRAM weight streaming (Cambricon-LLM shape): 0 = all params
    # DRAM-resident; W >= 1 keeps embeddings/head plus a W-repeat DRAM
    # sliding window per scanned unit resident and streams the remaining
    # per-layer weight slices from the simulated RRAM tier, prefetched
    # one layer ahead inside the scan body. Also settable at serving time
    # via REPRO_SERVE_WEIGHT_STREAM. Only units with repeats > W stream.
    weight_stream_layers: int = 0
    # partial unroll of the per-unit layer scan — the latency-hiding
    # window `runtime/overlap.py` documents (overlaps the next layer's
    # weight fetch with the current layer's compute). 1 = seed behaviour.
    scan_unroll: int = 1

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if not self.segments:
            object.__setattr__(
                self, "segments", (Segment(("attn",), self.num_layers),))
        n = sum(len(s.pattern) * s.repeats for s in self.segments)
        if n != self.num_layers:
            raise ValueError(
                f"{self.name}: segments describe {n} layers, "
                f"config says {self.num_layers}")

    # ---- conveniences -------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks). Used by the
        simulator and roofline MODEL_FLOPS = 6*N*D."""
        from repro_torch.models.counting import count_params
        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.counting import count_params
        return count_params(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


LM_SHAPES: tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeSpec:
    for s in LM_SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_REGISTRY: dict[str, "ModelConfig"] = {}
_REDUCED: dict[str, "ModelConfig"] = {}


def register(full: ModelConfig, reduced: ModelConfig) -> ModelConfig:
    _REGISTRY[full.name] = full
    _REDUCED[full.name] = reduced
    return full


def get_config(name: str, reduced: bool = False) -> ModelConfig:
    _ensure_loaded()
    table = _REDUCED if reduced else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]


def list_archs() -> list[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


ASSIGNED_ARCHS = (
    "starcoder2-7b", "stablelm-12b", "nemotron-4-340b", "granite-3-2b",
    "llama4-maverick-400b", "deepseek-v2-lite", "rwkv6-7b",
    "paligemma-3b", "hubert-xlarge", "zamba2-1.2b",
)

PAPER_MODELS = (
    "fastvlm-0.6b", "fastvlm-1.7b", "mobilevlm-1.7b", "mobilevlm-3b",
)

_LOADED = False


def _ensure_loaded():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    import importlib
    # every arch module of the reference, in its order
    for mod in (
        "starcoder2_7b", "stablelm_12b", "nemotron_4_340b", "granite_3_2b",
        "llama4_maverick_400b", "deepseek_v2_lite", "rwkv6_7b",
        "paligemma_3b", "hubert_xlarge", "zamba2_1_2b", "paper_models",
    ):
        importlib.import_module(f"repro_torch.configs.{mod}")
