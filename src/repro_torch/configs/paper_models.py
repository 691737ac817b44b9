"""The paper's own evaluation models (Table II):

| Model            | Vision Encoder | Connector      | LLM backbone |
|------------------|----------------|----------------|--------------|
| FastVLM (0.6B)   | FastViT-HD     | lightweight MLP| Qwen2-0.5B   |
| FastVLM (1.7B)   | FastViT-HD     | lightweight MLP| Qwen2-1.5B   |
| MobileVLM (1.7B) | ViT (CLIP-L)   | LDP            | MobileLLaMA-1.4B |
| MobileVLM (3B)   | ViT (CLIP-L)   | LDP            | MobileLLaMA-2.7B |

Backbone configs from the public HF checkpoints. Vision encoders are stub
frontends (precomputed patch embeddings), matching the paper's observation
that the encoder+connector are <15% of runtime — the backbone is what CHIME
accelerates. FastViT-HD compresses to few visual tokens (M << N); ViT+LDP
yields 144 tokens.
"""
from repro_torch.configs.base import ModelConfig, FrontendConfig, register


def _reduced(cfg: ModelConfig) -> ModelConfig:
    return cfg.replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, segments=(),
        frontend=FrontendConfig(kind="vision", frontend_dim=32, num_tokens=8,
                                connector="mlp"))


FASTVLM_06B = register(ModelConfig(
    name="fastvlm-0.6b", family="vlm",
    num_layers=24, d_model=896, num_heads=14, num_kv_heads=2, head_dim=64,
    d_ff=4864, vocab_size=151936, mlp_type="silu_gated", norm_type="rmsnorm",
    pos_emb="rope", use_attn_bias=True, tie_embeddings=True,
    frontend=FrontendConfig(kind="vision", frontend_dim=3072, num_tokens=64,
                            connector="mlp"),
), _reduced(ModelConfig(
    name="fastvlm-0.6b", family="vlm", num_layers=24, d_model=896,
    num_heads=14, num_kv_heads=2, head_dim=64, d_ff=4864, vocab_size=151936)))

FASTVLM_17B = register(ModelConfig(
    name="fastvlm-1.7b", family="vlm",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936, mlp_type="silu_gated", norm_type="rmsnorm",
    pos_emb="rope", use_attn_bias=True, tie_embeddings=True,
    frontend=FrontendConfig(kind="vision", frontend_dim=3072, num_tokens=64,
                            connector="mlp"),
), _reduced(ModelConfig(
    name="fastvlm-1.7b", family="vlm", num_layers=28, d_model=1536,
    num_heads=12, num_kv_heads=2, head_dim=128, d_ff=8960,
    vocab_size=151936)))

MOBILEVLM_17B = register(ModelConfig(
    name="mobilevlm-1.7b", family="vlm",
    num_layers=24, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=5632, vocab_size=32000, mlp_type="silu_gated", norm_type="rmsnorm",
    pos_emb="rope",
    frontend=FrontendConfig(kind="vision", frontend_dim=1024, num_tokens=144,
                            connector="mlp"),
), _reduced(ModelConfig(
    name="mobilevlm-1.7b", family="vlm", num_layers=24, d_model=2048,
    num_heads=16, num_kv_heads=16, head_dim=128, d_ff=5632,
    vocab_size=32000)))

MOBILEVLM_3B = register(ModelConfig(
    name="mobilevlm-3b", family="vlm",
    num_layers=32, d_model=2560, num_heads=20, num_kv_heads=20, head_dim=128,
    d_ff=6912, vocab_size=32000, mlp_type="silu_gated", norm_type="rmsnorm",
    pos_emb="rope",
    frontend=FrontendConfig(kind="vision", frontend_dim=1024, num_tokens=144,
                            connector="mlp"),
), _reduced(ModelConfig(
    name="mobilevlm-3b", family="vlm", num_layers=32, d_model=2560,
    num_heads=20, num_kv_heads=20, head_dim=128, d_ff=6912,
    vocab_size=32000)))
