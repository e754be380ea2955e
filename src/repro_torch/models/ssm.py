"""State-space / recurrent families: Mamba2 (SSD) and xLSTM (mLSTM + sLSTM)
(port of ``repro.models.ssm``).

The workhorse is ``ssd_chunked`` — the Mamba2 "state-space duality"
chunked algorithm: quadratic attention *within* a chunk, linear
recurrence *across* chunks.  mLSTM is expressed through the same primitive
(its matrix memory S_t = f_t·S + i_t·k v^T is an SSD recurrence with
per-head scalar decay).  ``use_kernel`` routes the scan through
``kernels.ops.ssd_scan`` (the hand-written CUDA kernel on a CUDA device,
its plain version on the CPU); no caller above these functions sets it,
as in the JAX package.

Decode: both families carry O(1) state per layer (Mamba2: (h, p, N)
matrix + conv tail; mLSTM: (h, p, p) matrix + normalizer; sLSTM: (h, p)
vectors).  A decode state's leaves are layer-first, ``(G, b, ...)``, and
its ``pos`` is an int shared by the batch (prefill) or a ``(b,)`` tensor
with one per lane (the slot pool, where the JAX package vmaps batch-1
states).  The decode step writes the new recurrent state into the state's
tensors in place (the JAX package returns new arrays) and returns a state
sharing them with ``pos`` advanced.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs import torch_dtype
from repro_torch.kernels import ref as kref
from repro_torch.models import layers as nn
from repro_torch.models.transformer import _n_stacked, layer_slices
from repro_torch.sharding.context import (constrain_batch, gather_fsdp,
                                          pointwise)

SSM_HEAD_DIM = 64  # Mamba2 P (head dim)


# ---------------------------------------------------------------------------
# SSD: chunked selective-state-space computation
# ---------------------------------------------------------------------------

def ssd_chunked(x, log_a, b_coef, c_coef, chunk: int,
                initial_state: Optional[torch.Tensor] = None,
                use_kernel: bool = False):
    """Chunked SSD scan.

    x:      (b, s, h, p)   inputs (already scaled by dt where applicable)
    log_a:  (b, s, h)      per-step log decay (<= 0)
    b_coef: (b, s, h, n)   input->state coefficients  ("B" / keys)
    c_coef: (b, s, h, n)   state->output coefficients ("C" / queries)
    Returns (y, final_state) with y: (b, s, h, p), state: (b, h, p, n).

    ``use_kernel`` returns before the padding branch, as in the JAX
    package: the kernel route needs ``s % chunk == 0``, takes no
    ``initial_state`` and returns no final state (``kernels.ops.ssd_scan``
    raises where the JAX op asserts or drops the input)."""
    if use_kernel:
        from repro_torch.kernels import ops as kops
        return kops.ssd_scan(x, log_a, b_coef, c_coef, chunk=chunk,
                             initial_state=initial_state)
    s = x.shape[1]
    if s % chunk != 0:
        # pad to a chunk multiple: zero x/B/C and zero log-decay leave the
        # recurrent state untouched; padded outputs are sliced away
        pad = chunk - s % chunk
        y, st = ssd_chunked(
            F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(log_a, (0, 0, 0, pad)),
            F.pad(b_coef, (0, 0, 0, 0, 0, pad)),
            F.pad(c_coef, (0, 0, 0, 0, 0, pad)),
            chunk, initial_state=initial_state)
        return y[:, :s], st
    return kref.ssd_chunked_ref(x, log_a, b_coef, c_coef, chunk,
                                initial_state=initial_state)


def ssd_step(state, x_t, log_a_t, b_t, c_t):
    """Single-token SSD recurrence (decode).

    state: (b,h,p,n); x_t: (b,h,p); log_a_t: (b,h); b_t/c_t: (b,h,n).
    Returns (y_t (b,h,p) in x_t's dtype, new_state f32)."""
    f32 = torch.float32
    decay = torch.exp(log_a_t.to(f32))[:, :, None, None]
    upd = x_t.to(f32)[..., None] * b_t.to(f32)[:, :, None, :]
    new_state = state.to(f32) * decay + upd
    y = torch.einsum("bhpn,bhn->bhp", new_state, c_t.to(f32))
    return y.to(x_t.dtype), new_state


# ---------------------------------------------------------------------------
# causal depthwise conv (Mamba front conv)
# ---------------------------------------------------------------------------

def causal_conv1d(x, w, b):
    """x: (b, s, c); w: (k, c); b: (c,). Depthwise causal conv in f32:
    ``y[t] = sum_i x[t - (k-1) + i] w[i] + b`` with zeros before the
    start (a sum of k shifted products: no convolution library call)."""
    k, s = w.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, k - 1, 0))
    w32 = w.float()
    out = xp[:, 0:s] * w32[0]
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w32[i]
    return (out + b.float()).to(x.dtype)


def causal_conv1d_step(conv_state, x_t, w, b):
    """conv_state: (b, k-1, c); x_t: (b, c). Returns (y_t, new_state)."""
    window = torch.cat([conv_state, x_t[:, None]], dim=1)      # (b,k,c)
    y = torch.einsum("bkc,kc->bc", window.float(), w.float()) + b.float()
    return y.to(x_t.dtype), window[:, 1:]


# ---------------------------------------------------------------------------
# Mamba2 block
# ---------------------------------------------------------------------------

def mamba2_dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    h = d_in // SSM_HEAD_DIM
    return d_in, h, SSM_HEAD_DIM, cfg.ssm_state


def init_mamba2(generator, cfg, device, lead=()):
    d = cfg.d_model
    d_in, h, p, n = mamba2_dims(cfg)
    pdt = torch_dtype(cfg.param_dtype)
    proj_out = 2 * d_in + 2 * n + h      # z, x, B, C, dt
    u = torch.rand((*lead, h), generator=generator, device=device)
    dt = torch.exp(u * (math.log(1e-1) - math.log(1e-3)) + math.log(1e-3))
    dt_bias = torch.log(torch.expm1(dt))
    conv_w = torch.randn((*lead, cfg.conv_kernel, d_in + 2 * n),
                         generator=generator, device=device) * 0.1
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=device))
    return {
        "in_proj": nn.dense_init(generator, (*lead, d, proj_out), d, pdt,
                                 device),
        "conv_w": conv_w.to(pdt),
        "conv_b": torch.zeros((*lead, d_in + 2 * n), dtype=pdt,
                              device=device),
        "a_log": a_log.expand(*lead, h).clone().to(pdt),
        "d_skip": torch.ones((*lead, h), dtype=pdt, device=device),
        "dt_bias": dt_bias.to(pdt),
        "out_norm": nn.init_rmsnorm(d_in, pdt, device, lead),
        "out_proj": nn.dense_init(generator, (*lead, d_in, d), d_in, pdt,
                                  device),
    }


def _mamba2_split(params, x, cfg):
    d_in, h, p, n = mamba2_dims(cfg)
    dt_proj = x @ params["in_proj"].to(x.dtype)
    z, xbc, dt = torch.split(dt_proj, [d_in, d_in + 2 * n, h], dim=-1)
    return z, xbc, dt, (d_in, h, p, n)


def _mamba2_decay(params, dt):
    """(dt after softplus, log decay dt·a), both f32."""
    dt = F.softplus(dt.float() + params["dt_bias"].float())
    a = -torch.exp(params["a_log"].float())
    return dt, dt * a


def mamba2_scan_inputs(params, x, cfg):
    """The front half of ``mamba2_forward``: the input projection, the
    causal conv and the dt/decay, up to the SSD scan's operands.
    x: (b, s, d) -> ``(xdt, log_a, B, C, xi, z)``: the scan's x (b, s, h,
    p), f32 log decay (b, s, h), B and C (b, s, h, n) — one group
    broadcast over the heads, an ``expand`` view (head stride 0) that the
    kernel reads as it is — and the skip input xi and gate z."""
    b, s, d = x.shape
    z, xbc, dt, (d_in, h, p, n) = _mamba2_split(params, x, cfg)
    xbc = F.silu(causal_conv1d(xbc, params["conv_w"], params["conv_b"]))
    xi, bc, cc = torch.split(xbc, [d_in, n, n], dim=-1)
    xi = xi.reshape(b, s, h, p)
    dt, log_a = _mamba2_decay(params, dt)                      # (b,s,h)
    bch = bc[:, :, None, :].expand(b, s, h, n)
    cch = cc[:, :, None, :].expand(b, s, h, n)
    xdt = xi * dt[..., None].to(xi.dtype)
    return xdt, log_a, bch, cch, xi, z


def mamba2_forward(params, x, cfg, *, use_kernel: bool = False):
    """x: (b, s, d) -> (b, s, d). Training/prefill path (chunked scan)."""
    b, s, d = x.shape
    xdt, log_a, bch, cch, xi, z = mamba2_scan_inputs(params, x, cfg)
    y, _ = ssd_chunked(xdt, log_a, bch, cch, cfg.ssm_chunk,
                       use_kernel=use_kernel)
    y = y + xi * params["d_skip"].to(xi.dtype)[None, None, :, None]
    y = y.reshape(b, s, xi.shape[2] * xi.shape[3])
    y = nn.rms_norm(params["out_norm"], y) * F.silu(z)
    return y @ params["out_proj"].to(x.dtype)


def init_mamba2_state(cfg, batch: int, device, lead=()):
    d_in, h, p, n = mamba2_dims(cfg)
    f32 = torch.float32
    return {
        "ssm": torch.zeros((*lead, batch, h, p, n), dtype=f32, device=device),
        "conv": torch.zeros((*lead, batch, cfg.conv_kernel - 1,
                             d_in + 2 * n), dtype=f32, device=device),
    }


def mamba2_step(params, x_t, state, cfg):
    """x_t: (b, d) one token. Returns (y_t, new_state)."""
    b, d = x_t.shape
    z, xbc, dt, (d_in, h, p, n) = _mamba2_split(params, x_t, cfg)
    xbc, conv_state = causal_conv1d_step(
        state["conv"].to(x_t.dtype), xbc, params["conv_w"],
        params["conv_b"])
    xbc = F.silu(xbc)
    xi, bc, cc = torch.split(xbc, [d_in, n, n], dim=-1)
    xi = xi.reshape(b, h, p)
    dt, log_a = _mamba2_decay(params, dt)                      # (b,h)
    bch = bc[:, None, :].expand(b, h, n)
    cch = cc[:, None, :].expand(b, h, n)
    y, new_ssm = ssd_step(state["ssm"], xi * dt[..., None].to(xi.dtype),
                          log_a, bch, cch)
    y = y + xi * params["d_skip"].to(xi.dtype)[None, :, None]
    y = y.reshape(b, d_in)
    y = nn.rms_norm(params["out_norm"], y) * F.silu(z)
    y = y @ params["out_proj"].to(x_t.dtype)
    return y, {"ssm": new_ssm, "conv": conv_state.float()}


# ---------------------------------------------------------------------------
# xLSTM: mLSTM block (matrix memory — expressed through SSD)
# ---------------------------------------------------------------------------

def mlstm_dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    h = cfg.n_heads
    p = d_in // h
    return d_in, h, p


def init_mlstm(generator, cfg, device, lead=()):
    d = cfg.d_model
    d_in, h, p = mlstm_dims(cfg)
    pdt = torch_dtype(cfg.param_dtype)

    def dense(shape, fan_in):
        return nn.dense_init(generator, (*lead, *shape), fan_in, pdt, device)

    return {
        "up_proj": dense((d, 2 * d_in), d),
        "wq": dense((d_in, d_in), d_in),
        "wk": dense((d_in, d_in), d_in),
        "wv": dense((d_in, d_in), d_in),
        "w_gates": dense((d_in, 2 * h), d_in),
        "out_norm": nn.init_rmsnorm(d_in, pdt, device, lead),
        "down_proj": dense((d_in, d), d_in),
    }


def _mlstm_qkv_gates(params, xi, h, p):
    shp = xi.shape[:-1]
    dt = xi.dtype
    q = (xi @ params["wq"].to(dt)).reshape(*shp, h, p)
    k = (xi @ params["wk"].to(dt)).reshape(*shp, h, p) / math.sqrt(p)
    v = (xi @ params["wv"].to(dt)).reshape(*shp, h, p)
    gates = (xi @ params["w_gates"].to(dt)).float()
    logf, logi_raw = torch.chunk(gates, 2, dim=-1)
    log_f = pointwise(F.logsigmoid, logf)   # (..., h) decay in (0,1)
    i_gate = torch.exp(pointwise(F.logsigmoid, logi_raw))
    return q, k, v, log_f, i_gate


def mlstm_forward(params, x, cfg, *, use_kernel: bool = False):
    """mLSTM block: (b, s, d) -> (b, s, d).  The normalizer's scan takes
    the plain path whatever ``use_kernel`` says, as in the JAX package:
    with the kernel, an mLSTM layer makes one kernel call and one plain
    one."""
    b, s, d = x.shape
    d_in, h, p = mlstm_dims(cfg)
    up = x @ params["up_proj"].to(x.dtype)
    xi, z = torch.chunk(up, 2, dim=-1)
    q, k, v, log_f, i_gate = _mlstm_qkv_gates(params, xi, h, p)
    # matrix memory: S_t = f_t S + i_t k v^T == SSD(x=v*i, a=log f, B=k, C=q)
    y, _ = ssd_chunked(v * i_gate[..., None].to(v.dtype), log_f, k, q,
                       cfg.ssm_chunk, use_kernel=use_kernel)
    # normalizer: n_t = f n + i k ; divide by max(|n·q|, 1)
    ones = torch.ones((b, s, h, 1), dtype=v.dtype, device=v.device)
    nsum, _ = ssd_chunked(ones * i_gate[..., None].to(v.dtype), log_f, k, q,
                          cfg.ssm_chunk)
    denom = torch.clamp(torch.abs(nsum[..., 0]), min=1.0)[..., None]
    y = (y / denom).reshape(b, s, d_in)
    y = nn.rms_norm(params["out_norm"], y) * F.silu(z)
    return y @ params["down_proj"].to(x.dtype)


def init_mlstm_state(cfg, batch: int, device, lead=()):
    d_in, h, p = mlstm_dims(cfg)
    f32 = torch.float32
    return {"s": torch.zeros((*lead, batch, h, p, p), dtype=f32,
                             device=device),
            "n": torch.zeros((*lead, batch, h, 1, p), dtype=f32,
                             device=device)}


def mlstm_step(params, x_t, state, cfg):
    b, d = x_t.shape
    d_in, h, p = mlstm_dims(cfg)
    up = x_t @ params["up_proj"].to(x_t.dtype)
    xi, z = torch.chunk(up, 2, dim=-1)
    q, k, v, log_f, i_gate = _mlstm_qkv_gates(params, xi, h, p)
    y, new_s = ssd_step(state["s"], v * i_gate[..., None].to(v.dtype),
                        log_f, k, q)
    nsum, new_n = ssd_step(
        state["n"],
        torch.ones((b, h, 1), dtype=v.dtype, device=v.device)
        * i_gate[..., None].to(v.dtype), log_f, k, q)
    denom = torch.clamp(torch.abs(nsum[..., 0]), min=1.0)[..., None]
    y = (y / denom).reshape(b, d_in)
    y = nn.rms_norm(params["out_norm"], y) * F.silu(z)
    return y @ params["down_proj"].to(x_t.dtype), {"s": new_s, "n": new_n}


# ---------------------------------------------------------------------------
# xLSTM: sLSTM block (true recurrence — a loop over time)
# ---------------------------------------------------------------------------

def slstm_dims(cfg):
    h = cfg.n_heads
    p = cfg.d_model // h
    return h, p


def init_slstm(generator, cfg, device, lead=()):
    d = cfg.d_model
    h, p = slstm_dims(cfg)
    pdt = torch_dtype(cfg.param_dtype)
    return {
        "w_in": nn.dense_init(generator, (*lead, d, 4 * d), d, pdt, device),
        "r": nn.dense_init(generator, (*lead, h, p, 4 * p), p, pdt, device),
        "b": torch.zeros((*lead, 4 * d), dtype=pdt, device=device),
        "out_norm": nn.init_rmsnorm(d, pdt, device, lead),
        "out_proj": nn.dense_init(generator, (*lead, d, d), d, pdt, device),
        "ffn": nn.init_swiglu(generator, cfg.replace(d_ff=2 * d), device,
                              lead),
    }


def _slstm_pre(params, x):
    """The input half of the gate pre-activations, ``x @ w_in + b`` in
    f32: (..., 4d)."""
    return (x @ params["w_in"].to(x.dtype)).float() + params["b"].float()


def _slstm_cell(params, pre, carry, cfg):
    """pre: (b, 4d) input pre-activations; carry: dict of (b, h, p)."""
    h, p = slstm_dims(cfg)
    b = pre.shape[0]
    rec = torch.einsum("bhp,hpq->bhq", carry["h"],
                       params["r"].float()).reshape(b, 4 * h * p)
    pre = (pre.reshape(b, 4, h, p)
           + rec.reshape(b, h, 4, p).transpose(1, 2))
    ig, fg, zg, og = pre[:, 0], pre[:, 1], pre[:, 2], pre[:, 3]
    i_t = torch.exp(pointwise(F.logsigmoid, ig))
    f_t = torch.sigmoid(fg)
    z_t = torch.tanh(zg)
    o_t = torch.sigmoid(og)
    c_t = f_t * carry["c"] + i_t * z_t
    n_t = f_t * carry["n"] + i_t
    h_t = o_t * c_t / torch.clamp(n_t, min=1.0)
    return {"c": c_t, "n": n_t, "h": h_t}


def init_slstm_state(cfg, batch: int, device, lead=()):
    h, p = slstm_dims(cfg)
    return {k: torch.zeros((*lead, batch, h, p), dtype=torch.float32,
                           device=device) for k in ("c", "n", "h")}


def _slstm_out(params, hs, dtype):
    y = nn.rms_norm(params["out_norm"], hs.to(dtype))
    y = y @ params["out_proj"].to(dtype)
    return y + nn.swiglu(params["ffn"], y)


def slstm_forward(params, x, cfg):
    """sLSTM block: (b, s, d) -> (b, s, d), a loop over time.  The input
    projection of every step is one product ahead of the loop (the JAX
    scan projects step by step; the numbers agree to rounding)."""
    b, s, d = x.shape
    carry = init_slstm_state(cfg, b, x.device)
    pre = _slstm_pre(params, x)                                # (b,s,4d)
    hs = []
    for t in range(s):
        carry = _slstm_cell(params, pre[:, t], carry, cfg)
        hs.append(carry["h"])
    hs = torch.stack(hs, dim=1).reshape(b, s, d)
    return _slstm_out(params, hs, x.dtype)


def slstm_step(params, x_t, carry, cfg):
    new = _slstm_cell(params, _slstm_pre(params, x_t), carry, cfg)
    return _slstm_out(params, new["h"].reshape(x_t.shape[0], -1),
                      x_t.dtype), new


# ---------------------------------------------------------------------------
# xLSTM model (alternating mLSTM / sLSTM pattern groups)
# ---------------------------------------------------------------------------

def n_groups(cfg) -> int:
    if cfg.slstm_ratio != 2:
        raise ValueError("xLSTM pattern implemented as [mLSTM, sLSTM] "
                         f"(slstm_ratio 2); got {cfg.slstm_ratio}")
    if cfg.n_layers % 2:
        raise ValueError(f"n_layers {cfg.n_layers} is not even")
    return cfg.n_layers // 2


def init_params(cfg, generator: torch.Generator, device="cuda"):
    """Random parameters from ``generator``, laid out as the JAX package
    lays them out (groups stacked on axis 0).  The numbers differ from
    JAX's for the same seed; parity tests carry JAX's across with
    ``checkpoint.convert.params_from_numpy``."""
    device = resolve_device(device)
    pdt = torch_dtype(cfg.param_dtype)
    G = (n_groups(cfg),)
    return {
        "embed": nn.init_embedding(generator, cfg.vocab_size, cfg.d_model,
                                   pdt, device),
        "layers": {
            "m_norm": nn.init_rmsnorm(cfg.d_model, pdt, device, G),
            "mlstm": init_mlstm(generator, cfg, device, G),
            "s_norm": nn.init_rmsnorm(cfg.d_model, pdt, device, G),
            "slstm": init_slstm(generator, cfg, device, G),
        },
        "final_norm": nn.init_rmsnorm(cfg.d_model, pdt, device),
    }


def apply_layer(cfg, gp, x, **_):
    gp = gather_fsdp(gp)
    x = constrain_batch(x, seq_parallel=False)
    x = x + mlstm_forward(gp["mlstm"], nn.rms_norm(gp["m_norm"], x), cfg)
    x = x + slstm_forward(gp["slstm"], nn.rms_norm(gp["s_norm"], x), cfg)
    return x


def apply_layer_range(cfg, stacked_slice, x, *, remat=None, **_):
    """Apply a contiguous slice of stacked groups (Hydra shard unit);
    ``remat`` (default ``cfg.remat``) checkpoints each group when autograd
    records (``torch.utils.checkpoint``): memory, not numbers."""
    remat = cfg.remat if remat is None else remat
    for gp in layer_slices(stacked_slice, _n_stacked(stacked_slice)):
        if remat and torch.is_grad_enabled():
            x = checkpoint(lambda gp_, h: apply_layer(cfg, gp_, h), gp, x,
                           use_reentrant=False)
        else:
            x = apply_layer(cfg, gp, x)
        x = constrain_batch(x)
    return x


def forward(cfg, params, batch, *, last_only=False, **_):
    x = nn.embed(params["embed"], batch["tokens"], torch_dtype(cfg.dtype))
    x = apply_layer_range(cfg, params["layers"], x)
    if last_only:
        x = x[:, -1:]
    x = nn.rms_norm(params["final_norm"], x)
    return nn.unembed(params["embed"], x)


def init_decode_state(cfg, batch: int, max_seq: int, device="cuda"):
    device = resolve_device(device)
    G = (n_groups(cfg),)
    return {"groups": {"mlstm": init_mlstm_state(cfg, batch, device, G),
                       "slstm": init_slstm_state(cfg, batch, device, G)},
            "pos": 0}


def _write_state(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if isinstance(v, dict):
            _write_state(dst[k], v)
        else:
            dst[k].copy_(v)


def decode_step(cfg, params, state, tokens, **_):
    """tokens: (b, 1).  The groups' states are written in place."""
    if tokens.shape[1] != 1:
        raise ValueError(f"{cfg.name}: recurrent decode takes one token "
                         f"per lane, got {tokens.shape[1]}")
    x = nn.embed(params["embed"], tokens[:, 0], torch_dtype(cfg.dtype))
    G = n_groups(cfg)
    gs_all = layer_slices(state["groups"], G)
    for gp, gs in zip(layer_slices(params["layers"], G), gs_all):
        y, ms = mlstm_step(gp["mlstm"], nn.rms_norm(gp["m_norm"], x),
                           gs["mlstm"], cfg)
        x = x + y
        y, ss = slstm_step(gp["slstm"], nn.rms_norm(gp["s_norm"], x),
                           gs["slstm"], cfg)
        x = x + y
        _write_state(gs, {"mlstm": ms, "slstm": ss})
    x = nn.rms_norm(params["final_norm"], x)
    logits = nn.unembed(params["embed"], x[:, None, :])
    return logits, {"groups": state["groups"], "pos": state["pos"] + 1}


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def _decode_state_bytes(cfg, batch: int, max_seq: int) -> int:
    """Bytes of ``init_decode_state``: f32 mLSTM (h, p, p) memory and (h,
    1, p) normalizer, three f32 sLSTM (h, p) vectors per group, and the
    4-byte int32 ``pos`` the JAX package counts."""
    G = n_groups(cfg)
    _, h, pm = mlstm_dims(cfg)
    _, ps = slstm_dims(cfg)
    per_lane = h * pm * pm + h * pm + 3 * h * ps
    return 4 * G * batch * per_lane + 4


def _register():
    import sys

    from repro_torch.models import registry
    registry.register(registry.FamilySpec(
        family="ssm", module=sys.modules[__name__],
        batched_prefill=False, padded_prefill=False, paging=False,
        pure_kv_state=False, servable=True, spec_draftable=False,
        kv_quant=False,
        notes={
            "batched_prefill": "recurrent state advances strictly "
                               "token-by-token (prefill scans the prompt)",
            "padded_prefill": "recurrent state cannot be rewound past a "
                              "pad tail",
            "paging": "O(1) recurrent state — nothing to page",
            "pure_kv_state": "decode state is conv/ssd recurrences, not a "
                             "KV cache",
            "spec_draftable": "recurrent state cannot be rolled back past "
                              "rejected draft tokens",
        },
        decode_state_cost=_decode_state_bytes))


_register()
