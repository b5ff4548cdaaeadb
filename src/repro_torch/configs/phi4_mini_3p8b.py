"""Phi-4-mini 3.8B [arXiv:2412.08905] — RoPE (partial rotary), SwiGLU, GQA."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=200064,
    period=("attn",),
    rope_theta=1e4,
    rotary_pct=0.75,
    tie_embeddings=True,
)

SMOKE = CONFIG.scaled(n_layers=4, d_model=96, n_heads=6, n_kv_heads=2,
                      head_dim=16, d_ff=192, vocab=512)
