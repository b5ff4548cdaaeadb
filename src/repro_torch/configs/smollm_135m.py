"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M] — llama-arch small dense."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab=49152,
    period=("attn",),
    rope_theta=1e4,
    tie_embeddings=True,
)

SMOKE = CONFIG.scaled(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, d_ff=128, vocab=256)
