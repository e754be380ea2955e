"""LLaVA-NeXT (Mistral-7B backbone) — VLM; anyres tiling frontend is a stub,
``input_specs`` feeds precomputed patch+text embeddings.

[hf:llava-hf/llava-v1.6-mistral-7b-hf]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    takes_embeddings=True, rope_theta=1_000_000.0,
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=0,
    d_ff=512, vocab_size=512, max_seq_len=4096)

register(CONFIG, SMOKE_CONFIG)
