"""Qwen2.5-32B — dense decoder, GQA (8 kv heads), QKV bias.

[hf:Qwen/Qwen2.5-0.5B family card, scaled per assignment]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=27648, vocab_size=152064,
    qkv_bias=True, rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen2.5-0.5B",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=0,
    d_ff=512, vocab_size=512, max_seq_len=4096)

register(CONFIG, SMOKE_CONFIG)
