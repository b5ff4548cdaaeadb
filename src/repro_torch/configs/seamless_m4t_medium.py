"""SeamlessM4T-medium [arXiv:2308.11596] — encoder-decoder multimodal;
the speech/text frontend is a STUB supplying precomputed frame embeddings
(B, S_enc, d); 12 encoder + 12 decoder layers (n_layers = decoder)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab=256206,
    period=("xattn",),
    encoder_layers=12,
    encoder_seq=512,
    rope_theta=1e4,
    tie_embeddings=True,
)

SMOKE = CONFIG.scaled(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
                      head_dim=16, d_ff=128, vocab=256, encoder_layers=2,
                      encoder_seq=24)
