"""Granite-3.0-2B [hf:ibm-granite; hf-tier] — dense, GQA (kv=8).
Closest assigned arch to the paper's own edge-scale backbones."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=49155,
    mlp_type="silu_gated",
    norm_type="rmsnorm",
    pos_emb="rope",
    tie_embeddings=True,
)

REDUCED = FULL.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=192, vocab_size=256, segments=())

register(FULL, REDUCED)
