"""StarCoder2-7B [arXiv:2402.19173; hf] — dense, GQA (kv=4), RoPE."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    mlp_type="gelu",
    norm_type="layernorm",
    pos_emb="rope",
    rope_theta=1e5,
    use_attn_bias=True,
    use_mlp_bias=True,
)

REDUCED = FULL.replace(
    name="starcoder2-7b", num_layers=2, d_model=96, num_heads=6,
    num_kv_heads=2, head_dim=16, d_ff=256, vocab_size=256, segments=())

register(FULL, REDUCED)
