"""Architecture config dataclass + registry (port of ``repro.configs.base``,
with every field of the JAX package's: dense, vlm, moe, ssm, hybrid and
audio).

``attn_impl`` follows the port's kernel vocabulary: ``"xla"`` (the
default, as in the JAX package: plain attention, no kernel) or ``"cuda"``
(the hand-written flash kernel on the cache-free causal path; on CPU
tensors its plain version).  ``checkpoint.convert.attn_impl_from_jax``
maps the JAX spellings onto it.

Dtypes are strings (``"bfloat16"``, ``"float32"``) rather than framework
dtype objects, so a config means the same thing on both sides of the
port; ``torch_dtype`` maps a string to the ``torch.dtype`` the code uses.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

# "xla": plain attention (the JAX package's default spelling, kept so a
# config means the same on both sides); "cuda": the flash kernel
ATTN_IMPLS = ("xla", "cuda")

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16, "float8_e4m3fn": torch.float8_e4m3fn}


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16`` (and float32 / float16, and
    ``"float8_e4m3fn"``, which only ``kv_cache_dtype`` takes: the JAX
    package's fp8 KV cache)."""
    if name not in _DTYPES:
        raise ValueError(f"dtype {name!r}: expected one of {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // n_heads
    source: str = ""                  # citation (paper / model card)

    # attention details
    causal: bool = True               # False for BERT-style encoders
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    window: Optional[int] = None      # native sliding window
    long_context_window: int = 8192   # SWA fallback used only for long_500k
    attn_impl: str = "xla"            # xla | cuda (see ATTN_IMPLS)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM / recurrent
    ssm_state: int = 0                # Mamba2 state dim N
    ssm_expand: int = 2
    ssm_chunk: int = 256
    conv_kernel: int = 4
    slstm_ratio: int = 0              # xLSTM: 1 sLSTM per this many blocks (0=off)

    # hybrid (zamba2-style)
    attn_every: int = 0               # shared attention block every k core layers

    # encoder-decoder (whisper)
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_len: int = 1500           # 30 s of audio at 50 Hz after conv stub

    # modality frontends (stubs per spec)
    takes_embeddings: bool = False    # VLM: input_specs feeds patch+text embeds

    # norms / mlp family / misc
    norm: str = "rms"                 # rms | layer
    mlp: str = "swiglu"               # swiglu | gelu
    mlp_bias: bool = False
    tie_embeddings: bool = True
    max_seq_len: int = 524_288

    # precision (strings; see torch_dtype)
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    kv_cache_dtype: str = "bfloat16"

    # training
    remat: bool = True                # activation checkpoint each layer

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl={self.attn_impl!r}: expected one "
                             f"of {ATTN_IMPLS}")
        for f in ("dtype", "param_dtype", "kv_cache_dtype"):
            torch_dtype(getattr(self, f))       # reject unknown names early

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    # ---- derived quantities ------------------------------------------------
    @property
    def attn_params(self) -> int:
        d, nh, nkv, hd = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim
        return d * nh * hd + 2 * d * nkv * hd + nh * hd * d

    @property
    def mlp_params(self) -> int:
        mult = 3 if self.mlp == "swiglu" else 2
        return mult * self.d_model * self.d_ff

    @property
    def layer_params(self) -> int:
        if self.family == "moe":
            return self.attn_params + self.n_experts * self.mlp_params + \
                self.d_model * self.n_experts  # router
        if self.family == "ssm":
            d_in = self.d_model * self.ssm_expand
            return 2 * self.d_model * d_in + d_in * (2 * self.ssm_state + 2)
        return self.attn_params + self.mlp_params

    @property
    def n_params(self) -> int:
        """The JAX package's count, term for term: an encoder-decoder adds
        one ``layer_params`` per encoder layer and prices each decoder
        layer as one ``layer_params`` too, so the decoder's
        cross-attention and the learned ``dec_pos`` table are left out.
        Plans are priced from this number, so it must equal JAX's."""
        emb = self.vocab_size * self.d_model
        body = self.n_layers * self.layer_params
        if self.is_encoder_decoder:
            body += self.n_encoder_layers * self.layer_params
        return emb * (1 if self.tie_embeddings else 2) + body

    @property
    def n_active_params(self) -> int:
        """Per-token active params (MoE counts top_k experts only)."""
        if self.family != "moe":
            return self.n_params
        dense_layer = self.attn_params + self.top_k * self.mlp_params
        return self.vocab_size * self.d_model + self.n_layers * dense_layer


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


ARCH_REGISTRY: dict[str, ArchConfig] = {}
SMOKE_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig, smoke: ArchConfig) -> None:
    ARCH_REGISTRY[cfg.name] = cfg
    SMOKE_REGISTRY[cfg.name] = smoke


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (triggers registration)
    reg = SMOKE_REGISTRY if smoke else ARCH_REGISTRY
    if name not in reg:
        raise KeyError(f"unknown arch {name!r}; have {sorted(reg)}")
    return reg[name]
