"""Whisper-medium — encoder-decoder; conv/mel frontend is a stub,
``input_specs`` feeds precomputed frame embeddings (1500 frames / 30 s).

[arXiv:2212.04356]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="whisper-medium", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab_size=51865,
    is_encoder_decoder=True, n_encoder_layers=24, encoder_len=1500,
    norm="layer", mlp="gelu", mlp_bias=True, tie_embeddings=True,
    source="arXiv:2212.04356",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, n_encoder_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
    head_dim=0, d_ff=512, vocab_size=512, encoder_len=64, max_seq_len=4096)

register(CONFIG, SMOKE_CONFIG)
