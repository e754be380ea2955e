"""The port's sharding rules (``repro_torch.sharding.specs``) against the
JAX package's.

* ``tests/test_sharding_specs.py``'s seven cases, run on both packages
  (each with its own ``P``), on the same mocked meshes.
* For every config of ``ASSIGNED_ARCHS`` plus bert-large-1b and vit-300m
  at full size — JAX's params through ``jax.eval_shape``, the port's on
  the meta device — on the mock meshes (16, 16), (2, 16, 16), (32, 8) and
  (2, 32, 8): ``param_specs`` and ``opt_state_specs`` equal JAX's leaf
  for leaf, and so do ``batch_specs`` and ``decode_state_specs`` at
  ``decode_32k`` and ``long_500k``.
* On a fake process group of 512 ranks, every placement list the port
  derives gives the local shard shape JAX's spec implies on the
  (2, 32, 8) mesh.
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
from types import SimpleNamespace

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import ASSIGNED_ARCHS as JASSIGNED
from repro.configs import INPUT_SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro.models import api as japi
from repro.optim import optimizers as jopt
from repro.sharding import specs as jsh
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.models import api
from repro_torch.optim import optimizers as opt
from repro_torch.sharding import specs as sh

ARCHS = list(JASSIGNED) + ["bert-large-1b", "vit-300m"]


def mesh(shape: dict, axes=None):
    return SimpleNamespace(shape=shape,
                           axis_names=tuple(axes or shape.keys()))


SINGLE = mesh({"data": 16, "model": 16})
MULTI = mesh({"pod": 2, "data": 16, "model": 16})
MESHES = [SINGLE, MULTI, mesh({"data": 32, "model": 8}),
          mesh({"pod": 2, "data": 32, "model": 8})]

PKGS = pytest.mark.parametrize("pkg", [(jsh, JP), (sh, sh.P)],
                               ids=["jax", "port"])


# -- tests/test_sharding_specs.py's cases, on both packages -----------------

@PKGS
def test_spec_fits_divisibility(pkg):
    s, P = pkg
    assert s.spec_fits(SINGLE, P("data", None), (32, 7))
    assert not s.spec_fits(SINGLE, P("data", None), (24, 7))
    assert s.spec_fits(SINGLE, P(("data", "model"), None), (512, 3))
    assert not s.spec_fits(SINGLE, P(("data", "model"), None), (128, 3))


@PKGS
def test_pick_spec_falls_back_in_order(pkg):
    s, P = pkg
    cands = [P("model", None), P(None, "model"), P(None, None)]
    assert s.pick_spec(SINGLE, cands, (32, 64)) == P("model", None)
    assert s.pick_spec(SINGLE, cands, (7, 64)) == P(None, "model")
    assert s.pick_spec(SINGLE, cands, (7, 9)) == P(None, None)


@PKGS
def test_param_candidates_projection_rules(pkg):
    s, P = pkg
    assert s._param_candidates("layers/attn/wq", 3, SINGLE)[0] \
        == P(None, "data", "model")
    assert s._param_candidates("attn/wo", 2, SINGLE)[0] == P("model", "data")
    assert s._param_candidates("layers/moe/w_gate", 4, SINGLE)[0] \
        == P(None, "model", "data", None)


@PKGS
def test_param_candidates_multipod_uses_pod_axis(pkg):
    s, P = pkg
    assert s._param_candidates("layers/attn/wq", 3, MULTI)[0] \
        == P(None, ("pod", "data"), "model")


@PKGS
def test_embed_table_rules(pkg):
    s, P = pkg
    c = s._param_candidates("embed/table", 2, SINGLE)
    assert c[0] == P("model", "data")
    got = s.pick_spec(SINGLE, c, (51865, 1024))
    assert got in (P(None, "data"), P(None, None))


@PKGS
def test_norm_scales_replicate(pkg):
    s, P = pkg
    assert s._param_candidates("layers/attn_norm/scale", 2, SINGLE) \
        == [P(None, None)]


@PKGS
def test_batch_axes(pkg):
    s, _ = pkg
    assert s.batch_axes(SINGLE) == "data"
    assert s.batch_axes(MULTI) == ("pod", "data")


# -- the spec trees, leaf for leaf ------------------------------------------

def _jflat(tree, specs=False):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=(lambda x: isinstance(x, JP)) if specs else None)[0]
    return {"/".join(str(getattr(q, "key", getattr(q, "idx", q)))
                     for q in path): leaf for path, leaf in leaves}


def _pflat(tree):
    return {sh._path_key(p): leaf for p, leaf in sh.leaves_with_path(tree)}


def _same_specs(port_tree, jax_tree):
    port, jx = _pflat(port_tree), _jflat(jax_tree, specs=True)
    assert port.keys() == jx.keys()
    for k in port:
        assert tuple(port[k]) == tuple(jx[k]), (k, port[k], jx[k])


def _both_params(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    jp = jax.eval_shape(lambda k: japi.init_params(jcfg, k),
                        jax.random.PRNGKey(0))
    return jcfg, cfg, jp, api.init_params(cfg, torch.Generator(), "meta")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_state_specs_match_jax(arch):
    jcfg, cfg, jp, pp = _both_params(arch)
    jocfg, ocfg = jopt.OptimizerConfig(), opt.OptimizerConfig()
    jo = jax.eval_shape(lambda p: jopt.init_state(jocfg, p), jp)
    po = opt.init_state(ocfg, pp)
    for m in MESHES:
        _same_specs(sh.param_specs(cfg, pp, m), jsh.param_specs(jcfg, jp, m))
        _same_specs(sh.opt_state_specs(cfg, po, m),
                    jsh.opt_state_specs(jcfg, jo, m))


@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_decode_state_specs_match_jax(arch):
    jcfg, cfg = jget_config(arch), get_config(arch)
    for name in ("decode_32k", "long_500k"):
        jshape, shape = JSHAPES[name], INPUT_SHAPES[name]
        jb = japi.input_specs(jcfg, jshape, kind="prefill")
        pb = api.input_specs(cfg, shape, kind="prefill")
        js = jax.eval_shape(lambda: japi.init_decode_state(
            jcfg, jshape.global_batch, jshape.seq_len))
        ps = api.family_module(cfg).init_decode_state(
            cfg, shape.global_batch, shape.seq_len, device="meta")
        for m in MESHES:
            _same_specs(sh.batch_specs(cfg, pb, m),
                        jsh.batch_specs(jcfg, jb, m))
            _same_specs(sh.decode_state_specs(cfg, ps, m),
                        jsh.decode_state_specs(jcfg, js, m))


def test_placements_give_jax_local_shapes_on_512_fake_ranks():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512)
    try:
        dmesh = init_device_mesh("cpu", (2, 32, 8),
                                 mesh_dim_names=("pod", "data", "model"))
        mock = MESHES[3]
        for arch in ARCHS:
            jcfg, cfg, jp, pp = _both_params(arch)
            jspecs = _jflat(jsh.param_specs(jcfg, jp, mock), specs=True)
            placements = _pflat(sh.to_placements(
                dmesh, sh.param_specs(cfg, pp, dmesh)))
            for key, leaf in _pflat(pp).items():
                local, _ = compute_local_shape_and_global_offset(
                    leaf.shape, dmesh, placements[key])
                spec = tuple(jspecs[key]) + (None,) * leaf.dim()
                implied = tuple(n // jsh._axis_size(mock, a)
                                for n, a in zip(leaf.shape, spec))
                assert tuple(local) == implied, (arch, key)
    finally:
        dist.destroy_process_group()
