"""DBRX-132B — fine-grained MoE, 16 experts top-4, GQA.

[hf:databricks/dbrx-base]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab_size=100352,
    n_experts=16, top_k=4, rope_theta=500_000.0,
    source="hf:databricks/dbrx-base",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=256, n_heads=8, n_kv_heads=2, head_dim=0,
    d_ff=512, vocab_size=512, n_experts=4, top_k=2, max_seq_len=4096)

register(CONFIG, SMOKE_CONFIG)
