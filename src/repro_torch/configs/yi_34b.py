"""Yi-34B — llama-architecture dense decoder with GQA.

[arXiv:2403.04652]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab_size=64000,
    rope_theta=5_000_000.0,
    source="arXiv:2403.04652",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=0,
    d_ff=512, vocab_size=512, max_seq_len=4096)

register(CONFIG, SMOKE_CONFIG)
