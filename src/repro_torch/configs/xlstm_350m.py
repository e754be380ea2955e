"""xLSTM-350M — alternating sLSTM + mLSTM blocks (recurrent, O(1) decode state).

[arXiv:2405.04517]
"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = ArchConfig(
    name="xlstm-350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    slstm_ratio=2,           # 1 sLSTM per 2 blocks (alternating)
    ssm_expand=2, ssm_chunk=256,
    source="arXiv:2405.04517",
)

SMOKE_CONFIG = CONFIG.replace(
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, head_dim=0,
    vocab_size=512, ssm_chunk=64, max_seq_len=4096)

register(CONFIG, SMOKE_CONFIG)
