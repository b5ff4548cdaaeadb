"""Gemma3-27B [hf:google/gemma-3 family] — 5:1 local:global attention,
1024-token sliding window, qk-norm, 128k context. 62 layers = 10 x (5L+1G)
period + 2 trailing local layers."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    n_layers=62,
    d_model=5376,
    n_heads=32,
    n_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab=262144,
    period=("local", "local", "local", "local", "local", "attn"),
    suffix=("local", "local"),
    window=1024,
    rope_theta=1e6,
    qk_norm=True,
    tie_embeddings=True,
    subquadratic=True,  # 5/6 layers windowed; globals are O(S) per decode
)

SMOKE = CONFIG.scaled(n_layers=8, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, d_ff=128, vocab=256, window=16,
                      period=("local", "local", "attn"), suffix=("local", "local"))
