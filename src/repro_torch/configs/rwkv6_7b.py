"""RWKV-6 (Finch) 7B [arXiv:2404.05892; hf] — attention-free, data-dependent
decay. No KV cache => CHIME KV tiering inapplicable (DESIGN.md
§Arch-applicability); the channel-mix FFN still maps to the RRAM domain and
the recurrent state is Tier-0 resident by construction. Sub-quadratic: runs
the long_500k shape."""
from repro_torch.configs.base import ModelConfig, SSMConfig, Segment, register

FULL = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,          # wkv heads = d_model / 64
    num_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    mlp_type="rwkv_cm",
    norm_type="layernorm",
    pos_emb="none",
    segments=(Segment(("rwkv6",), 32),),
    ssm=SSMConfig(rwkv_lora_rank=64, rwkv_decay_lora=128, chunk_size=128),
)

REDUCED = FULL.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=192, vocab_size=256,
    segments=(Segment(("rwkv6",), 2),),
    ssm=SSMConfig(rwkv_lora_rank=16, rwkv_decay_lora=16, chunk_size=32))

register(FULL, REDUCED)
