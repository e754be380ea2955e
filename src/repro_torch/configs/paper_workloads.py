"""The paper's own training workload (Table 2): BERT-Large*-1B on
WikiText-2, as a decoder-family config of the right parameter count
(port of ``repro.configs.paper_workloads``; the ViT* configs come with
the VLM family).  The smoke variant is what the multi-model tests run
on the CPU and what ``examples/quickstart.py`` trains."""
from repro_torch.configs.base import ArchConfig, register

# ~1B-param BERT-Large-like encoder (trained with an MLM-style xent on
# full-sequence logits; attention non-causal).
BERT_LARGE_1B = ArchConfig(
    name="bert-large-1b", family="dense",
    n_layers=36, d_model=1536, n_heads=24, n_kv_heads=24,
    d_ff=6144, vocab_size=30522,
    norm="layer", mlp="gelu", mlp_bias=True, qkv_bias=True, causal=False,
    source="paper Table 2 (BERT-Large*, 1B)",
)

BERT_SMOKE = BERT_LARGE_1B.replace(
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4, head_dim=0,
    d_ff=256, vocab_size=512, max_seq_len=512)

register(BERT_LARGE_1B, BERT_SMOKE)
