"""Llama-4-Maverick-400B-A17B [hf:meta-llama; unverified] — MoE 128 routed
experts top-1 + 1 shared expert, GQA (kv=8). The routed expert bank is the
natural "RRAM domain" in the CHIME mapping (dense, read-mostly storage)."""
from repro_torch.configs.base import ModelConfig, MoEConfig, register

FULL = ModelConfig(
    name="llama4-maverick-400b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    mlp_type="moe",
    norm_type="rmsnorm",
    pos_emb="rope",
    moe=MoEConfig(
        num_experts=128,
        top_k=1,
        d_ff_expert=8192,
        num_shared_experts=1,
        d_ff_shared=8192,
    ),
)

REDUCED = FULL.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, segments=(),
    moe=MoEConfig(num_experts=8, top_k=1, d_ff_expert=128,
                  num_shared_experts=1, d_ff_shared=128))

register(FULL, REDUCED)
