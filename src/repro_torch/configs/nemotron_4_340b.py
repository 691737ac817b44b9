"""Nemotron-4-340B [arXiv:2402.16819; unverified] — dense, GQA (kv=8),
squared-ReLU FFN. Exercises pod-scale FSDP + low-precision optimizer state."""
from repro_torch.configs.base import ModelConfig, register

FULL = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    num_layers=96,
    d_model=18432,
    num_heads=96,
    num_kv_heads=8,
    head_dim=192,
    d_ff=73728,
    vocab_size=256000,
    mlp_type="relu2",
    norm_type="layernorm",
    pos_emb="rope",
)

REDUCED = FULL.replace(
    num_layers=3, d_model=96, num_heads=6, num_kv_heads=2, head_dim=16,
    d_ff=384, vocab_size=512, segments=())

register(FULL, REDUCED)
