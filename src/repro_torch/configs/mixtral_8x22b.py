"""Mixtral-8x22B — MoE 8 experts top-2, GQA, sliding-window attention.

[arXiv:2401.04088]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab_size=32768,
    n_experts=8, top_k=2, window=4096, rope_theta=1_000_000.0,
    source="arXiv:2401.04088",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=0,
    d_ff=512, vocab_size=512, n_experts=4, top_k=2, window=128,
    max_seq_len=4096)

register(CONFIG, SMOKE_CONFIG)
