"""Command-R+ 104B — dense decoder, GQA, no biases.

[hf:CohereForAI/c4ai-command-r-v01]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=33792, vocab_size=256000,
    rope_theta=75_000_000.0,
    source="hf:CohereForAI/c4ai-command-r-v01",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=0,
    d_ff=512, vocab_size=512, max_seq_len=4096)

register(CONFIG, SMOKE_CONFIG)
