"""DeepSeek-V3 671B [arXiv:2412.19437] — MLA attention, 1 shared + 256
routed experts (top-8), 3 leading dense layers, 61 layers total.
(The paper's MTP head is a training objective add-on; main stack here.)"""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,  # MLA: per-head keys derived from the shared latent
    head_dim=128,
    d_ff=18432,  # dense-layer ff; expert ff is 2048 (assigned spec)
    vocab=129280,
    prefix=("mla_dense", "mla_dense", "mla_dense"),
    period=("mla",),
    rope_theta=1e4,
    moe=MoEConfig(
        n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1, first_k_dense=3
    ),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        rope_head_dim=64,
        nope_head_dim=128,
        v_head_dim=128,
    ),
    tie_embeddings=False,
)

SMOKE = CONFIG.scaled(
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
    vocab=256, prefix=("mla_dense",), period=("mla",),
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared=1, first_k_dense=1),
    mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16, rope_head_dim=8,
                  nope_head_dim=16, v_head_dim=16),
)
