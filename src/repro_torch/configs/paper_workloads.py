"""The paper's own benchmark workloads (Table 2), expressed in this
framework (port of ``repro.configs.paper_workloads``).

* BERT-Large*-1B on WikiText-2: hyper-parameter grid (batch × lr) = 12 models.
* ViT* 300M–2B on CIFAR-10: architecture grid × batch sizes = 12 models.

Both are modelled as decoder-family configs of the right parameter count
(the paper itself uses "architectures similar to BERT-Large and ViT,
scaled up").  Smoke variants are what the multi-model tests run on the
CPU and what ``examples/quickstart.py`` trains.
"""
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


def vit_like(n_params_m: int) -> ArchConfig:
    """ViT*-style config scaled to roughly n_params_m million params."""
    table = {
        300: (24, 1024, 16), 600: (32, 1280, 20), 800: (36, 1408, 22),
        1000: (40, 1536, 24), 1500: (48, 1664, 26), 2000: (48, 1920, 30),
    }
    L, d, h = table[n_params_m]
    return ArchConfig(
        name=f"vit-{n_params_m}m", family="vlm",
        n_layers=L, d_model=d, n_heads=h, n_kv_heads=h, head_dim=d // h,
        d_ff=4 * d, vocab_size=10,   # CIFAR-10 classes as a 10-way "vocab"
        takes_embeddings=True, causal=False,
        norm="layer", mlp="gelu", mlp_bias=True,
        source="paper Table 2 (ViT*, scaled)",
    )


VIT_SMOKE = ArchConfig(
    name="vit-smoke", family="vlm",
    n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab_size=10, takes_embeddings=True, causal=False,
    norm="layer", mlp="gelu", mlp_bias=True,
    source="paper Table 2 (ViT*, smoke)",
)
register(vit_like(300), VIT_SMOKE.replace(name="vit-300m"))
