"""Weights for a test that runs one model in both packages: the port's
init from a seed, as a JAX tree in the dtypes JAX's own init gives, and
that tree again as tensors, so both packages hold the same numbers.

``jax.eval_shape`` reads JAX's dtypes without running its init: the
first eager init in a process compiles every op it runs, seconds for
each config.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import api as japi
from repro_torch.checkpoint.convert import params_from_numpy, params_to_numpy
from repro_torch.models import api


def both_params(jcfg, cfg, seed):
    """``(jax_params, torch_params)`` of the same weights, on the CPU."""
    port = params_to_numpy(api.init_params(
        cfg, torch.Generator().manual_seed(seed), "cpu"))
    specs = jax.eval_shape(lambda k: japi.init_params(jcfg, k),
                           jax.random.PRNGKey(seed))
    jparams = jax.tree.map(lambda s, a: jnp.asarray(a, s.dtype), specs, port)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")
