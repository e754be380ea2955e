"""The port's expert-parallel MoE (explicit all_to_all over the 'model'
group, the JAX package's ``shard_map`` path) against its local path and
the JAX package's layer: ``tests/test_moe_shardmap.py``'s case with eight
gloo ranks on a (2, 4) mesh and mixtral-8x22b smoke (4 experts, one per
'model' member).

* The layer under ``activation_axes`` equals the port's local path within
  1e-5 (f32), and its ``lb_loss`` within 1e-6 — the JAX test's bounds.
* The layer equals JAX's ``moe.moe_mlp`` on the same params and input
  within 1e-5.
* The end-to-end softmax (bf16) is within 5e-3 of the unmeshed forward,
  and the run launched at least one all-to-all.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
from _torch_mesh_ranks import moe_ep_rank, run_ranks
from _torch_weights import both_params

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro_torch.checkpoint.convert import params_to_numpy
from repro_torch.configs import get_config


def _flat(tree, prefix="p"):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def test_expert_parallel_moe_matches_local_and_jax(tmp_path):
    jcfg = jget_config("mixtral-8x22b", smoke=True)
    cfg = get_config("mixtral-8x22b", smoke=True)
    jparams, params = both_params(jcfg, cfg, seed=0)
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((4, 64, cfg.d_model)) * 0.3).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (4, 64)).astype(np.int32)
    np.savez(tmp_path / "moe_inputs.npz", x=x, tokens=tokens,
             **_flat(params_to_numpy(params)))

    jlp = jax.tree.map(lambda a: a[0], jparams["layers"])["moe"]
    y_jax, _ = jmoe.moe_mlp(jlp, jnp.asarray(x), jcfg)

    run_ranks(moe_ep_rank, 8, tmp_path, timeout=300)
    out = np.load(tmp_path / "moe_out.npz")
    np.testing.assert_allclose(out["y_ep"], out["y_ref"], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(out["lb_ep"]), float(out["lb_ref"]),
                               rtol=1e-6)
    np.testing.assert_allclose(out["y_ep"], np.asarray(y_jax), rtol=1e-5,
                               atol=1e-5)
    assert float(out["softmax_diff"]) < 5e-3
    assert int(out["n_a2a"]) >= 1
