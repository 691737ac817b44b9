"""StableLM-2-12B [hf:stabilityai; hf-tier] — dense, GQA (kv=8)."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100352,
    mlp_type="silu_gated",
    norm_type="layernorm",
    pos_emb="rope",
)

REDUCED = FULL.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=160, vocab_size=256, segments=())

register(FULL, REDUCED)
