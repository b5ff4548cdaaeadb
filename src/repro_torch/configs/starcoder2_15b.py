"""StarCoder2-15B [arXiv:2402.19173] — GQA + RoPE dense code model."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab=49152,
    period=("attn",),
    rope_theta=1e5,
    tie_embeddings=False,
)

SMOKE = CONFIG.scaled(n_layers=4, d_model=96, n_heads=6, n_kv_heads=2,
                      head_dim=16, d_ff=256, vocab=256)
