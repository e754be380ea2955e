"""Model FLOPs a token, behind ``mfu.*``.

Training: 6 x matmul parameters + 12 x s x A (the attention's two score
products, forward and backward); forward only: 2 x matmul parameters +
4 x s x A.  The family file (``bench/init/<family>.py``) gives the matmul
parameters and A, the attention width (layers x heads x head size).
Layer recompute (the port's remat) is not model work and is not counted.
"""

from __future__ import annotations


def per_token(family, arch: dict, seq: int, *, train: bool) -> int:
    mm = family.matmul_params(arch)
    attn = seq * family.attention_width(arch)
    if train:
        return 6 * mm + 12 * attn
    return 2 * mm + 4 * attn
