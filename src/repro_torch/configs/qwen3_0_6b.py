"""Qwen3-0.6B — dense decoder, GQA (8 kv heads), QK-norm.

[hf:Qwen/Qwen3-8B family card, 0.6B variant per assignment]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=3072, vocab_size=151936,
    qk_norm=True, head_dim=128, rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=32,
    d_ff=512, vocab_size=512, max_seq_len=4096)

register(CONFIG, SMOKE_CONFIG)
