"""DeepSeek-V2-Lite-16B [arXiv:2405.04434; hf] — MLA (kv_lora=512) + MoE:
2 shared + 64 routed experts, top-6, first layer dense. The MLA latent cache
is itself a compressed KV representation; CHIME tiering stacks on top of it
(the latent is what gets tiered)."""
from repro_torch.configs.base import (
    ModelConfig, MoEConfig, MLAConfig, Segment, register)

FULL = ModelConfig(
    name="deepseek-v2-lite",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,          # qk_nope dim; v_head_dim in MLAConfig
    d_ff=1408,
    vocab_size=102400,
    mlp_type="moe",
    norm_type="rmsnorm",
    pos_emb="rope",
    segments=(Segment(("mla",), 27),),
    mla=MLAConfig(
        kv_lora_rank=512,
        q_lora_rank=0,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        d_ff_expert=1408,
        num_shared_experts=2,
        d_ff_shared=2816,
        first_dense_layers=1,
        d_ff_dense=10944,
    ),
)

REDUCED = FULL.replace(
    num_layers=3, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=64, vocab_size=256,
    segments=(Segment(("mla",), 3),),
    mla=MLAConfig(kv_lora_rank=32, q_lora_rank=0, qk_nope_head_dim=16,
                  qk_rope_head_dim=8, v_head_dim=16),
    moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64,
                  num_shared_experts=1, d_ff_shared=64,
                  first_dense_layers=1, d_ff_dense=128))

register(FULL, REDUCED)
