"""Zamba2-1.2B — hybrid: Mamba2 backbone + shared attention block.

[arXiv:2411.15242]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_chunk=256,
    attn_every=6,            # shared attention block after every 6 Mamba2 layers
    source="arXiv:2411.15242",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=4, d_model=256, n_heads=4, n_kv_heads=4, head_dim=0,
    d_ff=512, vocab_size=512, ssm_state=16, ssm_chunk=64, attn_every=2,
    max_seq_len=4096)

register(CONFIG, SMOKE_CONFIG)
