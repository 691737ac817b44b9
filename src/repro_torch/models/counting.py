"""Analytic parameter counts per config — feeds MODEL_FLOPS = 6·N·D in the
roofline (§Roofline) and the CHIME simulator's per-kernel byte counts."""

from __future__ import annotations

import numpy as np

from repro_torch.configs.base import ModelConfig


def _block_specs(cfg: ModelConfig):
    """Yield (mixer, mlp_kind, d_ff) per layer, resolving MoE first-dense."""
    idx = 0
    for seg in cfg.segments:
        for _ in range(seg.repeats):
            for mixer in seg.pattern:
                if mixer in ("mamba2",) and cfg.family == "hybrid":
                    mlp = None
                elif mixer == "rwkv6":
                    mlp = "rwkv_cm"
                elif cfg.mlp_type == "moe":
                    if cfg.moe and idx < cfg.moe.first_dense_layers:
                        mlp = "dense_first"
                    else:
                        mlp = "moe"
                else:
                    mlp = cfg.mlp_type
                yield mixer, mlp, cfg.d_ff
                idx += 1


def mixer_weight_elems(cfg: ModelConfig, mixer: str) -> int:
    """Weight elements of ONE layer's mixer half-block."""
    D = cfg.d_model
    if mixer in ("attn", "attn_shared"):
        return D * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim \
            + cfg.num_heads * cfg.head_dim * D
    if mixer == "mla":
        m = cfg.mla
        qk = m.qk_nope_head_dim + m.qk_rope_head_dim
        return (D * cfg.num_heads * qk            # wq (full rank)
                + D * m.kv_lora_rank + D * m.qk_rope_head_dim
                + m.kv_lora_rank * cfg.num_heads * (
                    m.qk_nope_head_dim + m.v_head_dim)
                + cfg.num_heads * m.v_head_dim * D)
    if mixer == "rwkv6":
        H, K = cfg.num_heads, cfg.head_dim
        r, rd = cfg.ssm.rwkv_lora_rank, cfg.ssm.rwkv_decay_lora
        return (3 * D * H * K + D * D + H * K * D
                + D * 5 * r + 5 * r * D + D * rd + rd * D)
    if mixer == "mamba2":
        d_inner = cfg.ssm.expand * D
        conv_dim = d_inner + 2 * cfg.ssm.state_dim
        H = d_inner // cfg.ssm.head_dim
        return D * (d_inner + conv_dim + H) + d_inner * D
    raise ValueError(mixer)


def mlp_weight_elems(cfg: ModelConfig, mlp: str | None, d_ff: int,
                     active_only: bool = False) -> int:
    """Weight elements of ONE layer's mlp half-block (0 for mixer-only)."""
    D = cfg.d_model
    if mlp is None:
        return 0
    if mlp == "rwkv_cm":
        return D * d_ff + d_ff * D + D * D
    if mlp == "moe":
        m = cfg.moe
        e_count = (m.top_k if active_only else m.num_experts)
        n = D * m.num_experts                    # router
        n += e_count * 3 * D * m.d_ff_expert
        if m.num_shared_experts:
            n += 3 * D * m.d_ff_shared
        return n
    if mlp == "dense_first":
        return 3 * D * cfg.moe.d_ff_dense
    mats = 3 if mlp in ("silu_gated", "gelu_gated") else 2
    return mats * D * d_ff


def layer_weight_elems(cfg: ModelConfig, mixer: str, mlp: str | None,
                       d_ff: int, active_only: bool = False) -> int:
    """Weight elements of ONE full layer block (mixer + mlp)."""
    return mixer_weight_elems(cfg, mixer) \
        + mlp_weight_elems(cfg, mlp, d_ff, active_only)


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    D = cfg.d_model
    n = 0
    n += cfg.vocab_size * D                      # embed
    if not cfg.tie_embeddings and not cfg.is_encoder:
        n += cfg.vocab_size * D                  # lm_head
    if cfg.is_encoder:
        n += cfg.vocab_size * D                  # classifier head
    if cfg.frontend is not None:
        f = cfg.frontend
        n += f.frontend_dim * D + (D * D if f.connector == "mlp" else 0)

    seen_shared_attn = False
    for mixer, mlp, d_ff in _block_specs(cfg):
        a = mixer_weight_elems(cfg, mixer)
        if mixer == "attn_shared":
            # one weight set reused by every application (Zamba2 shape)
            if not seen_shared_attn:
                n += a
                seen_shared_attn = True
        else:
            n += a
        n += mlp_weight_elems(cfg, mlp, d_ff, active_only)
    return n


# ---------------------------------------------------------------------------
# RRAM weight streaming: the param-set split between tiers
# ---------------------------------------------------------------------------
def param_dtype_bytes(cfg: ModelConfig) -> int:
    """Bytes per weight element in the stored param dtype (2 for the
    bfloat16 default, which bare numpy does not know)."""
    try:
        return np.dtype(cfg.param_dtype).itemsize
    except TypeError:
        return 2


def weight_units(cfg: ModelConfig) -> list[tuple[str, str | None, int, int]]:
    """Scan units as (mixer, mlp, d_ff, repeats): consecutive identical
    layers compressed exactly as `models.model.build_plan` compresses
    BlockSpecs, so unit indices here and in `Model.plan` agree."""
    units: list[list] = []
    for spec in _block_specs(cfg):
        if units and units[-1][0] == spec:
            units[-1][1] += 1
        else:
            units.append([spec, 1])
    return [(m, mlp, dff, r) for (m, mlp, dff), r in units]


def streamed_unit_indices(cfg: ModelConfig) -> tuple[int, ...]:
    """Unit indices whose per-layer weight slices live in the simulated
    RRAM tier under ``cfg.weight_stream_layers`` (W): scanned units with
    their own per-layer params (shared attention excluded) and more
    repeats than the W-repeat DRAM sliding window. Mirrors
    `Model.streamed_units` — the single plan-free source the scheduler
    and simulator price from."""
    W = int(getattr(cfg, "weight_stream_layers", 0) or 0)
    if W < 1 or not cfg.scan_layers:
        return ()
    return tuple(i for i, (m, _, _, r) in enumerate(weight_units(cfg))
                 if r > W and m != "attn_shared")


def stream_window_repeats(cfg: ModelConfig, repeats: int) -> int:
    """DRAM sliding-window depth (in repeats) a streamed unit keeps
    resident: at least 2 (the double-buffer floor — the current slice in
    the scan carry plus the prefetched next one), at most the unit's own
    repeat count."""
    W = int(getattr(cfg, "weight_stream_layers", 0) or 0)
    return min(max(W, 2), repeats)


def weight_stream_split(cfg: ModelConfig) -> tuple[int, int]:
    """(dram_resident_bytes, rram_streamed_bytes) of the full param set
    under ``cfg.weight_stream_layers``.

    Streamed units keep `stream_window_repeats` layer slices in DRAM
    (transit storage for the layer-ahead prefetch) while their FULL
    per-layer weight slices are RRAM-resident (the tier is the home of
    the data; the window only stages it). Everything else — embeddings,
    head, frontend, shared attention, units at or under the window — is
    DRAM-resident. W = 0 puts every param byte in DRAM and zero in RRAM.
    """
    ib = param_dtype_bytes(cfg)
    dram = count_params(cfg) * ib
    rram = 0
    streamed = set(streamed_unit_indices(cfg))
    for i, (mixer, mlp, d_ff, r) in enumerate(weight_units(cfg)):
        if i not in streamed:
            continue
        lb = layer_weight_elems(cfg, mixer, mlp, d_ff) * ib
        win = stream_window_repeats(cfg, r)
        dram -= (r - win) * lb
        rram += r * lb
    return dram, rram


def kv_elems_per_token(cfg: ModelConfig) -> int:
    """Cache elements appended per generated token (all layers): GQA K+V
    rows and MLA latents. This is the single source of truth for KV byte
    math — the simulator's `kv_bytes_per_token` cost terms and the serving
    pool's `slot_kv_bytes` capacity admission both derive from it, so the
    two can never drift."""
    total = 0
    for mixer, _, _ in _block_specs(cfg):
        if mixer in ("attn", "attn_shared"):
            total += 2 * cfg.num_kv_heads * cfg.head_dim
        elif mixer == "mla":
            total += cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim
    return total


def kv_scale_elems_per_token(cfg: ModelConfig) -> int:
    """float32 quant-scale elements per token in the tiered cold store:
    one per (token, kv-head) for each of K and V, one per MLA latent
    store (scales are per-token over the trailing feature dim)."""
    total = 0
    for mixer, _, _ in _block_specs(cfg):
        if mixer in ("attn", "attn_shared"):
            total += 2 * cfg.num_kv_heads
        elif mixer == "mla":
            total += 2
    return total


def kv_bytes_per_token(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    """KV-cache bytes appended per generated token (all layers)."""
    return kv_elems_per_token(cfg) * dtype_bytes
