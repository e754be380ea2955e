"""``repro_torch.models.api``'s last names against the JAX package's:
``decode_state_spec`` and the deprecated capability shims.

* ``decode_state_spec`` gives, for one config of every family (smoke and
  full size), meta tensors of JAX's ``eval_shape`` shapes and dtypes at
  every path of the decode state; the write index and the recurrent
  position, JAX's 0-d int32, are the port's plain ints.
* ``is_attention_family``, ``supports_padded_prefill``,
  ``supports_paging``, ``ATTENTION_FAMILIES`` and ``PAGED_FAMILIES``
  answer as JAX's do (``tests/test_registry.py``'s case), each with a
  ``DeprecationWarning`` whose text is JAX's with the port's module
  name; an unknown attribute raises ``AttributeError``.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro_torch.configs import get_config
from repro_torch.models import api

FAMILY_ARCH = {"dense": "qwen3-0.6b", "vlm": "llava-next-mistral-7b",
               "moe": "mixtral-8x22b", "ssm": "xlstm-350m",
               "hybrid": "zamba2-1.2b", "audio": "whisper-medium"}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield "/".join(map(str, path)), tree


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("family", sorted(FAMILY_ARCH))
def test_decode_state_spec_equals_jax(family, smoke):
    arch = FAMILY_ARCH[family]
    got = dict(_leaves(api.decode_state_spec(
        get_config(arch, smoke=smoke), 2, 64)))
    exp = {"/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                    for q in path): leaf
           for path, leaf in jax.tree_util.tree_flatten_with_path(
               japi.decode_state_spec(jget_config(arch, smoke=smoke), 2,
                                      64))[0]}
    assert got.keys() == exp.keys()
    for key, leaf in got.items():
        if isinstance(leaf, int):
            assert exp[key].shape == () and exp[key].dtype == np.int32
            continue
        assert leaf.device == torch.device("meta"), key
        assert tuple(leaf.shape) == exp[key].shape, key
        assert str(leaf.dtype).removeprefix("torch.") \
            == np.dtype(exp[key].dtype).name, key


def _warned(fn):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    (w,) = caught
    assert w.category is DeprecationWarning
    return out, str(w.message)


@pytest.mark.parametrize("name,arg", [
    ("is_attention_family", "dense"), ("is_attention_family", "ssm"),
    ("supports_padded_prefill", "dense"), ("supports_padded_prefill", "moe"),
    ("supports_paging", "dense"), ("supports_paging", "moe"),
    ("ATTENTION_FAMILIES", None), ("PAGED_FAMILIES", None)])
def test_deprecated_shims_answer_and_warn_as_jax(name, arg):
    def call(mod, cfg):
        return getattr(mod, name) if arg is None else getattr(mod, name)(cfg)
    got, msg = _warned(lambda: call(api, get_config(FAMILY_ARCH[arg or
                                                                "dense"],
                                                    smoke=True)))
    exp, jmsg = _warned(lambda: call(japi, jget_config(
        FAMILY_ARCH[arg or "dense"], smoke=True)))
    if arg is None:
        assert set(got) == set(exp)
    else:
        assert got == exp
    assert msg == jmsg.replace("repro.models.api.",
                               "repro_torch.models.api.")
    assert msg.startswith(f"repro_torch.models.api.{name} is deprecated")


def test_deprecated_family_tuples_match_the_registry_case():
    with pytest.warns(DeprecationWarning):
        assert set(api.ATTENTION_FAMILIES) == {"dense", "vlm", "moe"}
    with pytest.warns(DeprecationWarning):
        assert set(api.PAGED_FAMILIES) == {"dense", "vlm"}
    with pytest.raises(AttributeError):
        api.NOT_A_THING
