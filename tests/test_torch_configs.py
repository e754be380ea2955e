"""The port's config registry against the JAX package's: the configs
ported with the MoE family, the three widest dense models and the
encoder-decoder and VLM families (whisper-medium, llava-next-mistral-7b,
the paper's vit-300m), field for field (dtypes as strings), the
parameter counts every config reports, and ``ASSIGNED_ARCHS``.

Since ROADMAP Queue 1 item 9.3 the port's ``ArchConfig`` has every field
of JAX's, ``long_context_window`` (the ``long_500k`` decode window)
included: ``JAX_ONLY`` is empty, and every config compared here leaves
that field at JAX's default.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
import dataclasses

import numpy as np
import pytest

from repro import configs as jconfigs
from repro.configs import ArchConfig as JArchConfig
from repro.configs import get_config as jget_config
from repro_torch import configs
from repro_torch.configs import ARCH_REGISTRY, ArchConfig, get_config

NEW = ["qwen2.5-32b", "yi-34b", "command-r-plus-104b", "mixtral-8x22b",
       "dbrx-132b", "whisper-medium", "llava-next-mistral-7b", "vit-300m"]
JAX_ONLY: set = set()
UNPORTED_ARCHS = []


def _as_port(v):
    """A JAX field value as the port writes it (dtypes as strings)."""
    if isinstance(v, (type, np.dtype)) or hasattr(v, "dtype"):
        return np.dtype(v).name
    return v


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", NEW)
def test_new_configs_equal_jax_field_for_field(arch, smoke):
    cfg, jcfg = get_config(arch, smoke=smoke), jget_config(arch, smoke=smoke)
    fields = {f.name for f in dataclasses.fields(ArchConfig)}
    jfields = {f.name for f in dataclasses.fields(JArchConfig)}
    assert jfields - fields == JAX_ONLY and fields <= jfields
    for name in sorted(fields):
        assert getattr(cfg, name) == _as_port(getattr(jcfg, name)), name
    jdefaults = JArchConfig(name="x", family="dense", n_layers=1, d_model=8,
                            n_heads=1, n_kv_heads=1, d_ff=8, vocab_size=8)
    for name in JAX_ONLY:
        assert getattr(jcfg, name) == getattr(jdefaults, name), name


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", sorted(ARCH_REGISTRY))
def test_param_counts_equal_jax(arch, smoke):
    """``n_params``, ``layer_params`` and ``n_active_params`` (MoE: the
    top-k experts only) of every ported config, full and smoke."""
    cfg, jcfg = get_config(arch, smoke=smoke), jget_config(arch, smoke=smoke)
    for prop in ("n_params", "layer_params", "n_active_params",
                 "attn_params", "mlp_params"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop


def test_dims_and_moe_extras_of_the_new_configs():
    """JAX ``tests/test_double_buffer.py``'s numbers for these five."""
    expected = {"qwen2.5-32b": (64, 5120, 40, 8, 27648, 152064),
                "mixtral-8x22b": (56, 6144, 48, 8, 16384, 32768),
                "dbrx-132b": (40, 6144, 48, 8, 10752, 100352),
                "yi-34b": (60, 7168, 56, 8, 20480, 64000),
                "command-r-plus-104b": (64, 12288, 96, 8, 33792, 256000)}
    for arch, dims in expected.items():
        cfg = get_config(arch)
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                cfg.d_ff, cfg.vocab_size) == dims
        assert cfg.source
        smoke = get_config(arch, smoke=True)
        assert smoke.n_layers <= 4 and smoke.d_model <= 512
        assert smoke.family != "moe" or smoke.n_experts <= 4
    mix, dbrx = get_config("mixtral-8x22b"), get_config("dbrx-132b")
    assert (mix.n_experts, mix.top_k, mix.window) == (8, 2, 4096)
    assert (dbrx.n_experts, dbrx.top_k) == (16, 4)
    assert get_config("qwen2.5-32b").qkv_bias


def test_assigned_archs_are_jax_less_the_unported():
    """Nothing of JAX's list is unported: the lists are equal, in order,
    and the registries hold the same names."""
    assert configs.ASSIGNED_ARCHS == [
        a for a in jconfigs.ASSIGNED_ARCHS if a not in UNPORTED_ARCHS]
    assert configs.ASSIGNED_ARCHS == jconfigs.ASSIGNED_ARCHS
    assert sorted(ARCH_REGISTRY) == sorted(jconfigs.ARCH_REGISTRY)
    for arch in configs.ASSIGNED_ARCHS:
        assert get_config(arch) and get_config(arch, smoke=True)
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("llama-3-8b")


def test_encdec_and_vlm_dims():
    """whisper-medium's and llava's published widths, the ViT* table's
    300M row, and the smoke cuts (JAX ``tests/test_double_buffer.py``'s
    numbers for the first two)."""
    w, ll = get_config("whisper-medium"), get_config("llava-next-mistral-7b")
    assert (w.n_layers, w.d_model, w.n_heads, w.n_kv_heads, w.d_ff,
            w.vocab_size) == (24, 1024, 16, 16, 4096, 51865)
    assert (w.is_encoder_decoder, w.n_encoder_layers, w.encoder_len) == \
        (True, 24, 1500)
    assert (ll.n_layers, ll.d_model, ll.n_heads, ll.n_kv_heads, ll.d_ff,
            ll.vocab_size) == (32, 4096, 32, 8, 14336, 32000)
    assert ll.takes_embeddings and ll.family == "vlm"
    assert w.n_params == 657_089_536 and ll.n_params == 7_110_393_856
    vit = get_config("vit-300m")
    assert (vit.n_layers, vit.d_model, vit.n_heads, vit.d_ff,
            vit.vocab_size, vit.causal) == (24, 1024, 16, 4096, 10, False)
    assert get_config("vit-300m", smoke=True).name == "vit-300m"
    assert get_config("whisper-medium", smoke=True).encoder_len == 64
