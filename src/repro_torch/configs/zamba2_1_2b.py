"""Zamba2-1.2B [arXiv:2411.15242; hf] — hybrid: Mamba2 backbone with a
SHARED attention block applied every 6th position (one weight set reused
across applications, closed over the layer scan). Sub-quadratic overall:
runs the long_500k shape. ssm_state=64."""
from repro_torch.configs.base import ModelConfig, SSMConfig, Segment, register

# 6 superblocks of [5x mamba2 + shared attn] + 2 trailing mamba2 = 38 layers
_SEGMENTS = (
    Segment(("mamba2", "mamba2", "mamba2", "mamba2", "mamba2", "attn_shared"), 6),
    Segment(("mamba2",), 2),
)

FULL = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    mlp_type="gelu_gated",
    norm_type="rmsnorm",
    pos_emb="rope",
    segments=_SEGMENTS,
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, conv_width=4,
                  chunk_size=128),
)

REDUCED = FULL.replace(
    num_layers=8, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    segments=(
        Segment(("mamba2", "mamba2", "mamba2", "attn_shared"), 2),),
    ssm=SSMConfig(state_dim=16, head_dim=16, expand=2, conv_width=4,
                  chunk_size=16))

register(FULL, REDUCED)
