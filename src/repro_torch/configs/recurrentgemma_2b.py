"""RecurrentGemma-2B [arXiv:2402.19427] — Griffin: RG-LRU + local attention
in a (recurrent, recurrent, local-attn) pattern; 26 layers = 8 periods + 2
trailing recurrent layers; MQA (kv=1), window 2048."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab=256000,
    period=("rglru", "rglru", "local"),
    suffix=("rglru", "rglru"),
    window=2048,
    lru_width=2560,
    conv_width=4,
    rope_theta=1e4,
    tie_embeddings=True,
    subquadratic=True,
)

SMOKE = CONFIG.scaled(n_layers=5, d_model=64, n_heads=4, n_kv_heads=1,
                      head_dim=16, d_ff=128, vocab=256, window=16,
                      lru_width=64, period=("rglru", "rglru", "local"),
                      suffix=("rglru", "rglru"))
