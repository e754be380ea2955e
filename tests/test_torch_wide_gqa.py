"""The three dense configs with the widest query groups, and the paged
attention paths at 5, 6, 7 and 12 query heads per KV head (qwen2.5-32b
40/8, yi-34b 56/8, command-r-plus-104b 96/8), against the JAX package.

On the CPU: the smoke forwards of the three configs (qwen2.5 with its
QKV bias) equal JAX's at 2e-4 (matmul chains); the plain paged, int8,
verify and fused versions at those group counts, head_dim 128, equal
JAX's jnp references at 2e-5 (f32; 2e-4 for the fused layer's products);
the split-KV shape check takes 12 groups (the kernel's limit is 16) and
refuses 17; the CUDA route on CPU tensors raises naming what it needs.

On a card (``-m cuda``; they skip here with the reason): each kernel at
those group counts against its plain version, phase 3's tolerances.  The
JAX side comes in through fixtures, so the card runs this file without
JAX (``python -m pytest --noconftest -m cuda
tests/test_torch_wide_gqa.py``).
"""

import _torch_threads  # noqa: F401  (one torch thread per xdist worker)
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.paged_attention import _MAX_GROUPS, \
    _check_split_shape

F32_TOL = 2e-5
MM_TOL = 2e-4
BF16_TOL = 2e-2
GROUPS = [5, 6, 7, 12]
HD, BS, NKV = 128, 16, 2
DENSE = ["qwen2.5-32b", "yi-34b", "command-r-plus-104b"]


@pytest.fixture(scope="module")
def jx():
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref
    return SimpleNamespace(jnp=jnp, ref=jref)


def _inputs(seed, n, groups, B=6, kk=None):
    """Ragged lanes over ``B`` blocks of 16 rows: one partial block, one
    on a block edge, one full table; the last lane inactive on the
    garbage block 0.  ``kk``: verify queries per lane (lengths leave room
    for them)."""
    rng = np.random.default_rng(seed)
    nh = NKV * groups
    P = n * B + 1
    qshape = (n, nh, HD) if kk is None else (n, kk, nh, HD)
    q = rng.standard_normal(qshape, np.float32)
    kp = rng.standard_normal((P, BS, NKV, HD), np.float32)
    vp = rng.standard_normal((P, BS, NKV, HD), np.float32)
    tables = (rng.permutation(P - 1)[: n * B] + 1).reshape(n, B)
    top = B * BS - (kk or 0)
    lengths = np.array([7, BS, top, max(1, top // 3)][:n])
    tables[-1], lengths[-1] = 0, 1 if kk is None else 0
    return q, kp, vp, tables.astype(np.int32), lengths.astype(np.int32)


def _t(arrays, float_idx=(0, 1, 2), dtype=torch.float32, device="cpu"):
    return [torch.from_numpy(a).to(device).to(dtype) if i in float_idx
            else torch.from_numpy(a).to(device)
            for i, a in enumerate(arrays)]


def _close(out, exp, tol):
    np.testing.assert_allclose(np.asarray(out, np.float32),
                               np.asarray(exp, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", DENSE)
def test_smoke_forward_matches_jax(arch):
    """Each config's smoke forward (2 layers, 8/2 heads) in f32; the full
    config's query group is what the kernels below take."""
    import jax.numpy as jnp
    from _torch_weights import both_params

    from repro.configs import get_config as jget_config
    from repro.models import api as japi
    from repro_torch.models import api
    jcfg = jget_config(arch, smoke=True).replace(dtype=jnp.float32)
    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    jp, tp = both_params(jcfg, cfg, 0)
    if arch == "qwen2.5-32b":
        assert cfg.qkv_bias and "bq" in tp["layers"]["attn"]
        for k in ("bq", "bk", "bv"):      # non-zero biases, both sides
            tp["layers"]["attn"][k].normal_(generator=torch.Generator()
                                            .manual_seed(1))
            jp["layers"]["attn"][k] = jnp.asarray(
                tp["layers"]["attn"][k].numpy())
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24))
    exp = japi.forward(jcfg, jp, {"tokens": jnp.asarray(toks)})
    with torch.no_grad():
        out = api.forward(cfg, tp, {"tokens": torch.from_numpy(toks)})
    _close(out.numpy(), exp, MM_TOL)
    full = get_config(arch)
    assert full.n_heads // full.n_kv_heads in GROUPS
    assert full.head_dim == HD


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("window", [None, 40])
def test_paged_and_int8_plain_versions_match_jax(jx, groups, window):
    args = _inputs(groups, 4, groups)
    out = ref.paged_attention_ref(*_t(args), window=window)
    exp = jx.ref.paged_attention_ref(*map(jx.jnp.asarray, args),
                                     window=window)
    _close(out.numpy(), exp, F32_TOL)
    q, kp, vp, tables, lengths = args
    kq, ks = ref.quantize_kv(torch.from_numpy(kp))
    vq, vs = ref.quantize_kv(torch.from_numpy(vp))
    out = ref.paged_attention_quant_ref(
        torch.from_numpy(q), kq, vq, ks, vs, torch.from_numpy(tables),
        torch.from_numpy(lengths), window=window)
    exp = jx.ref.paged_attention_quant_ref(
        *map(jx.jnp.asarray, (q, kq.numpy(), vq.numpy(), ks.numpy(),
                              vs.numpy(), tables, lengths)), window=window)
    _close(out.numpy(), exp, F32_TOL)


@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("kk", [1, 4, 5])
def test_verify_plain_version_matches_jax(jx, groups, kk):
    """k up to 5: k * groups <= 60, inside the verify kernel's 64 rows."""
    args = _inputs(10 * groups + kk, 4, groups, kk=kk)
    out = ref.paged_verify_ref(*_t(args), window=None)
    exp = jx.ref.paged_verify_ref(*map(jx.jnp.asarray, args), window=None)
    _close(out.numpy(), exp, F32_TOL)


@pytest.mark.parametrize("groups", [7, 12])
def test_fused_plain_version_matches_jax(jx, groups):
    """The fused layer's plain version at d 256, f 512 with 7 and 12
    query heads of 128 per KV head."""
    q, kp, vp, tables, lengths = _inputs(3 * groups, 4, groups)
    rng = np.random.default_rng(groups)
    d, f, nh = 256, 512, NKV * groups
    h = rng.standard_normal((4, d), np.float32)
    w = [rng.standard_normal(s, np.float32) / np.sqrt(s[0])
         for s in ((nh * HD, d), (d, f), (d, f), (f, d))]
    scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
    args = (h, q, kp, vp, tables, lengths, w[0], scale, w[1], w[2], w[3])
    out = ref.fused_decode_layer_ref(*map(torch.from_numpy, args))
    exp = jx.ref.fused_decode_layer_ref(*map(jx.jnp.asarray, args))
    _close(out.numpy(), exp, MM_TOL)


def test_split_shape_check_takes_twelve_groups():
    pages = torch.zeros(4, BS, 8, HD)
    _check_split_shape("paged_attention_lanes", 96, 8, HD, pages, pages)
    _check_split_shape("paged_attention_lanes", 8 * _MAX_GROUPS, 8, HD,
                       pages, pages)
    with pytest.raises(ValueError, match="groups <= 16"):
        _check_split_shape("paged_attention_lanes", 8 * 17, 8, HD, pages,
                           pages)


@pytest.mark.parametrize("op", ["paged_attention", "paged_attention_quant",
                                "paged_verify", "fused_decode_layer"])
def test_cuda_route_on_cpu_tensors_names_what_it_needs(op):
    q, kp, vp, tables, lengths = _t(_inputs(1, 4, 12))
    args = {"paged_attention": (q, kp, vp, tables, lengths),
            "paged_verify": (q[:, None], kp, vp, tables, lengths),
            "paged_attention_quant": (q, kp.to(torch.int8),
                                      vp.to(torch.int8), kp[..., 0],
                                      vp[..., 0], tables, lengths),
            "fused_decode_layer": (torch.zeros(4, 8), q, kp, vp, tables,
                                   lengths, None, None, None, None, None)}
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        getattr(ops, op)(*args[op], impl="cuda")


# ---------------------------------------------------------------------------
# on a card: the kernels at these group counts against their plain versions
# ---------------------------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, BF16_TOL),
                                       (torch.float32, F32_TOL)])
def test_cuda_paged_kernel_at_wide_groups(groups, dtype, tol):
    _cuda()
    for window in (None, 40):
        t = _t(_inputs(groups, 4, groups, B=40), dtype=dtype, device="cuda")
        out = ops.paged_attention(*t, window=window, impl="cuda")
        exp = ref.paged_attention_ref(*t, window=window)
        torch.cuda.synchronize()
        _close(out.float().cpu(), exp.float().cpu(), tol)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", GROUPS)
def test_cuda_int8_kernel_at_wide_groups(groups):
    _cuda()
    q, kp, vp, tables, lengths = _t(_inputs(groups, 4, groups, B=40),
                                    device="cuda")
    kq, ks = ref.quantize_kv(kp)
    vq, vs = ref.quantize_kv(vp)
    q = q.to(torch.bfloat16)
    out = ops.paged_attention_quant(q, kq, vq, ks, vs, tables, lengths,
                                    impl="cuda")
    exp = ref.paged_attention_quant_ref(q, kq, vq, ks, vs, tables, lengths)
    torch.cuda.synchronize()
    _close(out.float().cpu(), exp.float().cpu(), BF16_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", GROUPS)
@pytest.mark.parametrize("kk", [1, 4, 5])
def test_cuda_verify_kernel_at_wide_groups(groups, kk):
    _cuda()
    t = _t(_inputs(groups + kk, 4, groups, B=40, kk=kk), device="cuda")
    out = ops.paged_verify(*t, impl="cuda")
    exp = ref.paged_verify_ref(*t)
    torch.cuda.synchronize()
    _close(out.cpu(), exp.cpu(), F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("groups", [7, 12])
def test_cuda_fused_layer_at_wide_groups(groups):
    _cuda()
    q, kp, vp, tables, lengths = _t(_inputs(groups, 4, groups, B=40),
                                    device="cuda")
    g = torch.Generator("cuda").manual_seed(groups)
    d, f, nh = 1024, 2048, NKV * groups

    def w(*s):
        return torch.randn(s, generator=g, device="cuda") / s[0] ** 0.5

    args = (torch.randn(4, d, generator=g, device="cuda"), q, kp, vp, tables,
            lengths, w(nh * HD, d), torch.ones(d, device="cuda"), w(d, f),
            w(d, f), w(f, d))
    out = ops.fused_decode_layer(*args, impl="cuda")
    exp = ref.fused_decode_layer_ref(*args)
    torch.cuda.synchronize()
    _close(out.cpu(), exp.cpu(), MM_TOL)
