"""Multi-rank gloo runs for the port's mesh tests: ``run_ranks`` spawns
``n`` CPU ranks of one ``torch.distributed`` world on a free localhost
port, each running ``fn(rank, out_dir, *args)``, and waits at most
``timeout`` seconds.  The rank bodies live here, apart from the test
files, so a spawned rank imports torch and the port only (no JAX)."""

import os
import socket
import time

import numpy as np
import torch
import torch.multiprocessing as mp

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, fn, n, port, out_dir, args):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=n)
    try:
        fn(rank, out_dir, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n: int, out_dir, *args, timeout: float = 300.0) -> None:
    """Run ``fn`` on ``n`` spawned gloo ranks; raises if any rank fails
    or the run outlasts ``timeout``."""
    ctx = mp.start_processes(_entry, args=(fn, n, _free_port(), str(out_dir),
                                           args),
                             nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{n} ranks outlasted {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


# ---------------------------------------------------------------------------
# rank bodies
# ---------------------------------------------------------------------------

def spmd_step_rank(rank, out_dir, arch, accum, device="cpu"):
    """One train step of ``arch`` smoke (f32) over a (2, 2) mesh against
    the unmeshed step on the same params and batch; rank 0 writes the
    largest differences and every param's local shape.  ``device``
    "cuda": one GPU a rank, under ``torchrun`` (NCCL)."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import (DataConfig, SyntheticTokens,
                                           as_tensors)
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import api, registry
    from repro_torch.optim.optimizers import OptimizerConfig, init_state
    from repro_torch.sharding import specs as sh
    from repro_torch.sharding.context import activation_axes
    from repro_torch.training.train_loop import make_train_step
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch, smoke=True).replace(dtype="float32")
    ocfg = OptimizerConfig(lr=1e-3)
    params = api.init_params(cfg, torch.Generator(device).manual_seed(0),
                             device)
    if registry.spec(cfg).token_stream_data:
        batch = as_tensors(next(iter(SyntheticTokens(DataConfig(
            batch_size=4, seq_len=32, vocab_size=cfg.vocab_size,
            seed=0)))), device)
    else:       # audio / vlm batches carry embeddings
        batch = api.make_dummy_batch(cfg, 4, 32, device=device)
    ref_p, _, ref_m = make_train_step(cfg, ocfg, accum_steps=accum)(
        params, init_state(ocfg, params), batch)

    mesh = make_debug_mesh(2, 2, device=device)
    dp = sh.distribute(mesh, params, sh.param_specs(cfg, params, mesh))
    step = make_train_step(cfg, ocfg, accum_steps=accum, mesh=mesh)
    with activation_axes(mesh, moe_shardmap=False):
        new_p, _, m = step(dp, init_state(ocfg, dp), batch)
    full = sh.full_tensors(new_p)
    if rank == 0:
        out = {"loss": abs(float(m["loss"]) - float(ref_m["loss"])),
               "grad_norm": abs(float(m["grad_norm"])
                                - float(ref_m["grad_norm"])),
               "params": max(float((a - b).abs().max()) for a, b in
                             zip(tree_leaves(full), tree_leaves(ref_p))),
               "local_shapes": {sh._path_key(p): tuple(v.to_local().shape)
                                for p, v in sh.leaves_with_path(new_p)}}
        torch.save(out, os.path.join(out_dir, "spmd_step.pt"))


def moe_ep_rank(rank, out_dir):
    """The expert-parallel MoE layer over a (2, 4) mesh (mixtral-8x22b
    smoke: 4 experts, one per 'model' member) and the end-to-end forward,
    from the params and inputs the test wrote; rank 0 writes the
    results."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.checkpoint.convert import params_from_numpy
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api, moe
    from repro_torch.sharding.context import activation_axes

    data = dict(np.load(os.path.join(out_dir, "moe_inputs.npz")))
    cfg = get_config("mixtral-8x22b", smoke=True)
    flat = {k[len("p/"):]: v for k, v in data.items() if k.startswith("p/")}
    tree: dict = {}
    for k, v in flat.items():
        node = tree
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    params = params_from_numpy(tree, device="cpu")
    lp = {k: v[0] for k, v in params["layers"]["moe"].items()}
    x = torch.from_numpy(data["x"])
    batch = {"tokens": torch.from_numpy(data["tokens"]).long()}

    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    with torch.no_grad():
        y_ref, aux_ref = moe.moe_mlp(lp, x, cfg)
        ref = api.forward(cfg, params, batch)
        comm = CommDebugMode()
        with activation_axes(mesh), comm:
            y_ep, aux_ep = moe.moe_mlp(lp, x, cfg)
            out = api.forward(cfg, params, batch)
    n_a2a = sum(n for op, n in comm.get_comm_counts().items()
                if "all_to_all" in str(op))
    if rank == 0:
        pp = torch.softmax(out.float(), -1)
        pr = torch.softmax(ref.float(), -1)
        np.savez(os.path.join(out_dir, "moe_out.npz"),
                 y_ep=y_ep.numpy(), y_ref=y_ref.numpy(),
                 lb_ep=float(aux_ep["lb_loss"]),
                 lb_ref=float(aux_ref["lb_loss"]),
                 softmax_diff=float((pp - pr).abs().max()),
                 n_a2a=n_a2a)


# the cases of ``seq_sharded_decode_rank``: name -> (batch, the K/V
# planes' spec over (L, b, s, nkv, hd) on the (2, 2) mesh — None:
# ``decode_state_specs``'s own pick, the sequence over ("data", "model") —,
# whether each lane has its own write index, the attention window)
SEQ_DECODE_CASES = {
    "seq_data_model": (1, None, False, None),
    "seq_data_model_window": (1, None, False, 8),
    "seq_data_heads_model_window": (
        1, (None, None, "data", "model", None), False, 8),
    "batch_data_seq_model_per_lane": (
        2, (None, "data", "model", None, None), True, None),
}


def _seq_decode_case(cfg, params, mesh, case, device):
    """One ``SEQ_DECODE_CASES`` case on this rank (see
    ``seq_sharded_decode_rank``)."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models import api
    from repro_torch.sharding import specs as sh
    from repro_torch.sharding.context import activation_axes

    batch, kv_spec, per_lane, window = SEQ_DECODE_CASES[case]
    steps, max_seq = 3, 64
    rng = np.random.default_rng(0)
    state = api.init_decode_state(cfg, batch, max_seq, device=device)
    for name in ("k", "v"):
        state["kv"][name].copy_(torch.from_numpy(rng.standard_normal(
            state["kv"][name].shape).astype(np.float32)))
    # 37 (and 21): rows 48.. lie past the causal limit, and a window of 8
    # leaves rows 0..29 out too
    starts = [37, 21][:batch] if per_lane else [37] * batch
    index = torch.tensor(starts, device=device) if per_lane else starts[0]
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, 1))
                              ).to(device)
    init = {n: state["kv"][n].clone() for n in ("k", "v")}

    ref = {"kv": {"k": init["k"].clone(), "v": init["v"].clone(),
                  "index": index}}
    ref_logits, tok = [], tokens
    for _ in range(steps):
        lg, ref = api.decode_step(cfg, params, ref, tok, window=window)
        ref_logits.append(lg)
        tok = lg[:, -1:].argmax(-1)

    specs = sh.decode_state_specs(cfg, state, mesh)
    if kv_spec is not None:
        specs["kv"]["k"] = specs["kv"]["v"] = sh.P(*kv_spec)
    dstate = sh.distribute(mesh, state, specs)
    dstate["kv"]["index"] = index
    dparams = sh.distribute(mesh, params, sh.param_specs(cfg, params, mesh))
    placements = tuple(dstate["kv"]["k"].placements)
    logit_diff, tok, tokens_out = 0.0, tokens, []
    with torch.no_grad(), implicit_replication(), activation_axes(mesh):
        for i in range(steps):
            dtok = sh.distribute(mesh, tok, sh.P(None, None))
            lg, dstate = api.decode_step(cfg, dparams, dstate, dtok,
                                         window=window)
            lg = lg.full_tensor() if isinstance(lg, DTensor) else lg
            logit_diff = max(logit_diff,
                             float((lg - ref_logits[i]).abs().max()))
            tok = lg[:, -1:].argmax(-1)
            tokens_out.append(tok.flatten().tolist())
    # this rank's shard: the new rows where it owns them, else untouched
    out = {"placements": [str(p) for p in placements],
           "logit_diff": logit_diff, "tokens": tokens_out,
           "ref_tokens": [lg[:, -1].argmax(-1).tolist()
                          for lg in ref_logits]}
    for name in ("k", "v"):
        local = dstate["kv"][name].to_local()
        shape, off = compute_local_shape_and_global_offset(
            dstate["kv"][name].shape, mesh, placements)
        sl = tuple(slice(o, o + n) for o, n in zip(off, shape))
        written = torch.zeros(local.shape[1:3], dtype=torch.bool,
                              device=local.device)
        for lane in range(local.shape[1]):
            for r in range(starts[off[1] + lane],
                           starts[off[1] + lane] + steps):
                if off[2] <= r < off[2] + local.shape[2]:
                    written[lane, r - off[2]] = True
        mask = written[None, :, :, None, None].expand_as(local)
        out[f"{name}_offset"] = list(off)
        out[f"{name}_rows_owned"] = int(written.sum())
        out[f"{name}_new_rows_diff"] = float(
            (local - ref["kv"][name][sl])[mask].abs().max()) \
            if mask.any() else 0.0
        out[f"{name}_others_unchanged"] = bool(torch.equal(
            local[~mask], init[name][sl][~mask]))
    return out


def seq_sharded_decode_rank(rank, out_dir, device="cpu"):
    """Every ``SEQ_DECODE_CASES`` case: three decode steps of qwen3-0.6b
    smoke (f32) over a (2, 2) mesh with the KV cache's *sequence*
    sharded, against the same steps without a mesh.

    The cache starts full of distinct random rows (numpy seed 0; rows
    past the write index stay as garbage the causal mask must hide), and
    the write index sits where some ranks hold no live key, more so with
    a window.  Each rank writes ``seq_decode_<rank>.pt``: per case the
    largest logit difference, the tokens both ways, and whether its own
    shards hold the new rows exactly where it owns them with nothing
    else changed.  ``device`` "cuda": one GPU a rank, under
    ``torchrun``."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import api

    cfg = get_config("qwen3-0.6b", smoke=True).replace(dtype="float32")
    params = api.init_params(cfg, torch.Generator(device).manual_seed(0),
                             device)
    mesh = make_debug_mesh(2, 2, device=device)
    out = {case: _seq_decode_case(cfg, params, mesh, case, device)
           for case in SEQ_DECODE_CASES}
    torch.save(out, os.path.join(out_dir, f"seq_decode_{rank}.pt"))
