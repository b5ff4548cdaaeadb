"""Qwen3-30B-A3B [hf:Qwen/Qwen3-30B-A3B] — 128-expert top-8 MoE, GQA."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,  # per-expert ff (assigned spec)
    vocab=151936,
    period=("moe",),
    rope_theta=1e6,
    qk_norm=True,
    moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768),
    tie_embeddings=False,
)

SMOKE = CONFIG.scaled(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, d_ff=96, vocab=256,
                      moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96))
