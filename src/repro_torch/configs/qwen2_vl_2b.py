"""Qwen2-VL-2B [arXiv:2409.12191] — M-RoPE (t/h/w sections), dynamic
resolution vision frontend as a STUB supplying patch embeddings."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab=151936,
    period=("attn",),
    rope_theta=1e6,
    mrope_sections=(16, 24, 24),
    tie_embeddings=True,
)

SMOKE = CONFIG.scaled(n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, d_ff=128, vocab=256,
                      mrope_sections=(2, 3, 3))
