"""HuBERT-XLarge [arXiv:2106.07447; unverified] — encoder-only audio
transformer (w2v2 arch). Frontend STUB: input_specs() provides precomputed
frame embeddings. Encoder-only => no decode step (decode_32k / long_500k
skipped); CHIME KV tiering inapplicable (no autoregressive cache) — the
attention/FFN memory-domain split and fused kernels still apply."""
from repro_torch.configs.base import ModelConfig, FrontendConfig, register

FULL = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    mlp_type="gelu",
    norm_type="layernorm",
    pos_emb="learned",
    is_encoder=True,
    frontend=FrontendConfig(kind="audio", frontend_dim=512, num_tokens=0,
                            connector="linear"),
)

REDUCED = FULL.replace(
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=160, vocab_size=64, segments=(),
    frontend=FrontendConfig(kind="audio", frontend_dim=32, num_tokens=0,
                            connector="linear"))

register(FULL, REDUCED)
