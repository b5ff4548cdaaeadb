"""RWKV6 "Finch" 1.6B [arXiv:2404.05892] — attention-free, data-dependent
decay; head size 64 (32 heads at d=2048); channel-mix ff 7168."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    n_layers=24,
    d_model=2048,
    n_heads=32,  # = d_model / rwkv_head_size (informational for rwkv)
    n_kv_heads=32,
    d_ff=7168,
    vocab=65536,
    period=("rwkv",),
    rwkv_head_size=64,
    tie_embeddings=False,
    subquadratic=True,
)

SMOKE = CONFIG.scaled(n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
                      d_ff=128, vocab=256, rwkv_head_size=16)
