"""PaliGemma-3B [arXiv:2407.07726; hf] — VLM: SigLIP frontend (STUB:
input_specs() provides precomputed patch embeddings) + Gemma-2B backbone
(MQA kv=1, head_dim 256, gelu-gated). The most paper-representative assigned
arch: a real MLLM with encoder -> connector -> LLM backbone dataflow."""
from repro_torch.configs.base import ModelConfig, FrontendConfig, register

FULL = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=257216,
    mlp_type="gelu_gated",
    norm_type="rmsnorm",
    pos_emb="rope",
    tie_embeddings=True,
    frontend=FrontendConfig(kind="vision", frontend_dim=1152,
                            num_tokens=256, connector="mlp"),
)

REDUCED = FULL.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, head_dim=16,
    d_ff=192, vocab_size=256, segments=(),
    frontend=FrontendConfig(kind="vision", frontend_dim=48, num_tokens=16,
                            connector="mlp"))

register(FULL, REDUCED)
