"""Dry runs of the PyTorch port (port of ``repro.launch.dryrun``).

The lowering mode proves that an (arch x input shape x mesh) step
partitions over the production mesh and says what one device would hold,
compute and exchange — with no real allocation:

  1. start a ``"fake"`` process group of 256 (``32x8``) or 512
     (``2x32x8``) ranks; this process is rank 0, every collective returns
     at once (``torch.testing._internal.distributed.fake_pg``);
  2. build the production ``DeviceMesh`` (``launch/mesh.py``) and lay the
     params, optimizer state, batch and decode state out by the spec rules
     (``sharding/specs.py``) as DTensors whose local shards are meta
     tensors of rank 0's shape — built shard by shard
     (``DTensor.from_local``), never as a full tensor first;
  3. run one step of the shape's kind inside ``activation_axes(mesh,
     moe_shardmap=(kind != "train"))``: train with ``accum = global_batch
     // data size``, prefill, or decode with ``decode_window_for``;
  4. count what rank 0 does under one dispatch mode that sees the local
     ops DTensor issues (it defers DTensor-level ops, so each count is
     per device, never global).

Meta tensors stand where the JAX package has ``ShapeDtypeStruct``s:
``FakeTensorMode`` would be the closer analogue, but DTensor's own
placement search runs tensor ops (``.tolist()`` on strided-shard
offsets) that fake tensors refuse, and meta tensors run them.  DTensor
on a CPU mesh replaces an all-to-all by all-gather + chunk, so a record
may list all-gathers where the card would run all-to-alls.

Each record keeps the JAX package's keys, so ``launch/roofline.py`` of
either package reads it:

* ``status``: "ok" or "fail" (with ``error`` and ``traceback``).
* ``bytes_per_device``: rank 0's live meta bytes — ``arguments`` (the
  laid-out inputs), ``output`` (the step's outputs), ``alias`` (outputs
  written in place into an input: the decode cache, the params and
  state the train step updates), ``peak`` (the most live at once) and
  ``temp`` (``peak - arguments - output + alias``, the JAX identity).
* ``hlo_flops_per_device``: rank 0's FLOPs (``torch.utils.flop_counter``'s
  formulas: matmuls and attention), over the whole step — every layer
  and micro-batch, recompute included — where XLA's count shows a loop
  body once.
* ``hlo_bytes_per_device``: the bytes rank 0's ops read and write.
* ``collectives``: output bytes per collective kind under JAX's names
  (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``), their ``total`` and ``n_ops``, over the whole
  step (nothing to scale by a trip count).
* ``collective_shapes``: per kind, the count of collectives by output
  shape (``"8x1x2x128": 28``), which says what moved: a gathered K/V
  plane shows as a 4-D all-gather as large as a layer's key rows.
* ``scan_trip``: the layer count (the JAX package's key; informational).
* ``compile_s``: the wall time of building and tracing the step.

  python -m repro_torch.launch.dryrun --arch qwen3-0.6b --shape decode_32k \\
      --out results/dryrun_torch.jsonl
  python -m repro_torch.launch.dryrun --all --both-meshes

``--plan`` is the Session plan dry run: it builds a ``Session`` over
``TrainJob``s of the ``--arch`` list, emits its ``Plan`` (partitions,
spill placement, the schedule estimate) as JSON without executing a
single unit, and asserts that the JSON round-trips byte for byte.  The
Plan written here is the same object ``Session.run`` consumes.

  python -m repro_torch.launch.dryrun --plan --arch qwen3-0.6b,bert-large-1b \\
      --smoke --budget-mb 18 --out results/plan_smoke.json
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.api import HydraConfig, Plan, Session, TrainJob
from repro_torch.configs import ASSIGNED_ARCHS, INPUT_SHAPES, get_config
from repro_torch.models import api
from repro_torch.tree import tree_leaves


# ---------------------------------------------------------------------------
# lowering mode: one step over the production mesh, counted on rank 0
# ---------------------------------------------------------------------------

# functional collectives by JAX's kind names
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


class DeviceCounter(TorchDispatchMode):
    """Counts what one rank does: FLOPs, bytes its ops touch, collective
    bytes by kind, and its live tensor bytes and their peak.

    An op on DTensors is deferred (``NotImplemented``): DTensor then
    issues the rank's local ops, which come back here on local tensors,
    so every count is per device.  DTensor's placement search runs ops on
    fake tensors of global shape; those are skipped.  Live bytes follow
    the storages of the tensors counted ops make, freed when their last
    tensor goes."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops_of = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.collectives: dict[str, int] = {}
        self.shapes: dict[str, dict[str, int]] = {}
        self.n_collectives = 0
        self.live = 0
        self.peak = 0
        self._storages: dict[int, int] = {}

    def track(self, t) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._storages:
            return
        n = st.nbytes()
        self._storages[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._storages.pop(key, 0)

    def storage_bytes(self, tensors) -> tuple[int, set]:
        keys = {t.untyped_storage()._cdata for t in tensors}
        return sum(self._storages.get(k, 0) for k in keys), keys

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out                  # DTensor's placement search
        name = func.overloadpacket.__name__
        if func.namespace in ("_c10d_functional", "c10d_functional",
                              "_c10d_functional_autograd"):
            kind = COLLECTIVE_KINDS.get(name)
            if kind is not None:
                nbytes = sum(t.numel() * t.element_size() for t in outs)
                self.collectives[kind] = self.collectives.get(kind, 0) \
                    + nbytes
                self.n_collectives += 1
                by_shape = self.shapes.setdefault(kind, {})
                for t in outs:
                    key = "x".join(map(str, t.shape))
                    by_shape[key] = by_shape.get(key, 0) + 1
        elif func.overloadpacket in self._flops_of:
            self.flops += self._flops_of[func.overloadpacket](
                *args, **kwargs, out_val=out)
        self.bytes_accessed += sum(t.numel() * t.element_size()
                                   for t in ins + outs)
        for t in outs:
            self.track(t)
        return out


def _local(t):
    """A DTensor's local shard; any other tensor itself."""
    from torch.distributed.tensor import DTensor
    return t.to_local() if isinstance(t, DTensor) else t


def _fake_world(n: int) -> bool:
    """Start a fake process group of ``n`` ranks (this process rank 0);
    returns whether this call started it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            return False
        raise RuntimeError(
            "the lowering dry run needs its own fake process group; one "
            f"of backend {dist.get_backend()!r} and {dist.get_world_size()}"
            " ranks is already running")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)
    return True


def _lay_out(mesh, tree, spec_tree):
    """``tree``'s meta tensors as DTensors over ``mesh``, each built from a
    meta shard of rank 0's shape (no full tensor is made); ints stay."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from repro_torch.sharding import specs as sh
    specs = iter(sh.spec_leaves(spec_tree))

    def one(_, leaf):
        spec = next(specs)
        if not isinstance(leaf, torch.Tensor):
            return leaf
        placements = sh.spec_placements(mesh, spec)
        local, _ = compute_local_shape_and_global_offset(
            leaf.shape, mesh, placements)
        shard = torch.empty(tuple(local), dtype=leaf.dtype, device="meta")
        if leaf.dim() == 0:
            return shard
        return DTensor.from_local(shard, mesh, placements, run_check=False,
                                  shape=leaf.shape,
                                  stride=sh.contiguous_stride(leaf.shape))
    return sh._map_with_path(one, tree)


def _data_size(mesh) -> int:
    from repro_torch.sharding import specs as sh
    return sh._axis_size(mesh, sh.batch_axes(mesh))


def build_step(cfg, shape, mesh):
    """``(step, args, meta)`` for the shape's step kind, the inputs laid
    out over ``mesh`` as meta DTensors."""
    from repro_torch.models import api as mapi
    from repro_torch.optim.optimizers import OptimizerConfig, init_state
    from repro_torch.sharding import specs as sh
    from repro_torch.training.train_loop import (decode_window_for,
                                                 make_decode_step,
                                                 make_prefill_step,
                                                 make_train_step)

    meta = {"layers": cfg.n_layers}
    pm = mapi.init_params(cfg, torch.Generator(), "meta")
    params = _lay_out(mesh, pm, sh.param_specs(cfg, pm, mesh))
    if shape.kind == "train":
        ocfg = OptimizerConfig(kind="adamw", lr=1e-4, grad_clip=1.0)
        batch = mapi.input_specs(cfg, shape, kind="train")
        batch = _lay_out(mesh, batch, sh.batch_specs(cfg, batch, mesh))
        opt_state = init_state(ocfg, params)   # zeros in the params' layout
        # micro-batch = one sequence per data shard; the rest accumulates
        accum = max(1, shape.global_batch // _data_size(mesh))
        meta["accum"] = accum
        step = make_train_step(cfg, ocfg, accum_steps=accum, mesh=mesh)
        return step, (params, opt_state, batch), meta
    if shape.kind == "prefill":
        batch = mapi.input_specs(cfg, shape, kind="prefill")
        batch.pop("labels", None)
        batch = _lay_out(mesh, batch, sh.batch_specs(cfg, batch, mesh))
        return make_prefill_step(cfg), (params, batch), meta
    sm = mapi.family_module(cfg).init_decode_state(
        cfg, shape.global_batch, shape.seq_len, device="meta")
    state = _lay_out(mesh, sm, sh.decode_state_specs(cfg, sm, mesh))
    tokens = _lay_out(mesh, torch.empty((shape.global_batch, 1),
                                        dtype=torch.int64, device="meta"),
                      sh.P(None, None))
    step = make_decode_step(cfg, window=decode_window_for(cfg, shape))
    return step, (params, state, tokens), meta


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            smoke: bool = False) -> dict:
    """One lowering record (``smoke``: the reduced config, marked so in
    the record)."""
    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.launch.mesh import (MESH_NAMES, MULTI_POD_AXES,
                                         MULTI_POD_SHAPE, PRODUCTION_AXES,
                                         PRODUCTION_SHAPE)
    from repro_torch.sharding.context import activation_axes

    cfg = get_config(arch, smoke=smoke)
    shape = INPUT_SHAPES[shape_name]
    mshape, axes = ((MULTI_POD_SHAPE, MULTI_POD_AXES) if multi_pod
                    else (PRODUCTION_SHAPE, PRODUCTION_AXES))
    rec: dict[str, Any] = {"arch": arch, "shape": shape_name,
                           "mesh": MESH_NAMES[mshape],
                           "family": cfg.family, "kind": shape.kind}
    if smoke:
        rec["smoke"] = True
    n = 1
    for d in mshape:
        n *= d
    t0 = time.time()
    started = _fake_world(n)
    try:
        from torch.distributed.device_mesh import DeviceMesh
        # a "cuda" mesh over meta shards: DTensor then plans the card's
        # collectives (a CPU mesh turns all-to-alls into all-gathers)
        mesh = DeviceMesh("cuda", torch.arange(n).view(mshape),
                          mesh_dim_names=axes)
        # the inputs are laid out before counting starts (their global
        # meta stand-ins are never any device's bytes) and registered
        step, args, meta = build_step(cfg, shape, mesh)
        counter = DeviceCounter()
        ins = [_local(t) for t in _tensors(args)]
        for t in ins:
            counter.track(t)
        in_bytes, in_keys = counter.storage_bytes(ins)
        with counter, implicit_replication(), \
                activation_axes(mesh, moe_shardmap=shape.kind != "train"):
            out = step(*args)
        out_bytes, out_keys = counter.storage_bytes(
            [_local(t) for t in _tensors(out)])
        alias = sum(counter._storages.get(k, 0)
                    for k in out_keys & in_keys)
        peak = counter.peak
        coll = dict(counter.collectives)
        coll["total"] = sum(coll.values())
        coll["n_ops"] = counter.n_collectives
        rec.update(
            status="ok",
            compile_s=round(time.time() - t0, 1),
            bytes_per_device={
                "arguments": in_bytes, "output": out_bytes,
                "temp": peak - in_bytes - out_bytes + alias,
                "alias": alias, "peak": peak},
            hlo_flops_per_device=float(counter.flops),
            hlo_bytes_per_device=float(counter.bytes_accessed),
            collectives=coll,
            collective_shapes=counter.shapes,
            scan_trip=meta["layers"])
        if "accum" in meta:
            rec["accum"] = meta["accum"]
        print(f"OK   {arch:24s} {shape_name:12s} {rec['mesh']:8s} "
              f"peak={peak / 1e9:6.2f}GB "
              f"flops={rec['hlo_flops_per_device']:.3e} "
              f"coll={coll['total'] / 1e9:.2f}GB  ({rec['compile_s']}s)")
    except Exception as e:
        rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:],
                   compile_s=round(time.time() - t0, 1))
        print(f"FAIL {arch:24s} {shape_name:12s} {rec['mesh']:8s} {e}")
    finally:
        if started:
            dist.destroy_process_group()
    return rec


def kv_plane_gathers(rec: dict) -> dict:
    """The all-gathers of a decode record that move a K/V plane: 4-D
    outputs at least as large as one rank's share of a layer's cache
    (``seq_len / ranks`` rows of every KV head), by output shape.  Empty
    where attention reads a sequence-sharded cache where it lies."""
    cfg = get_config(rec["arch"], smoke=rec.get("smoke", False))
    ranks = math.prod(int(d) for d in rec["mesh"].split("x"))
    least = (INPUT_SHAPES[rec["shape"]].seq_len // ranks
             * cfg.n_kv_heads * cfg.head_dim)
    gathers = rec["collective_shapes"].get("all-gather", {})
    return {key: n for key, n in gathers.items()
            if key.count("x") == 3
            and math.prod(int(d) for d in key.split("x")) >= least}


def lowering_dryrun(args) -> list[dict]:
    """Every (arch x shape x mesh) combination asked for, one JSON line
    each appended to ``args.out``."""
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    recs = []
    with open(args.out, "a") as f:
        for mp in meshes:
            for a in archs:
                for s in shapes:
                    rec = run_one(a, s, multi_pod=mp, smoke=args.smoke)
                    f.write(json.dumps(rec) + "\n")
                    f.flush()
                    recs.append(rec)
    return recs


def _plan_loader(cfg, batch, seq, seed, device):
    """Endless random batches (the plan reads none of them)."""

    class Loader:
        def __iter__(self):
            gen = torch.Generator(device).manual_seed(seed)
            while True:
                yield api.make_dummy_batch(cfg, batch, seq, generator=gen,
                                           device=device)

    return Loader()


def plan_dryrun(args) -> dict:
    """Build a Session over --arch TrainJobs, emit its Plan as JSON, and
    verify that the JSON round-trips byte for byte."""
    archs = [a.strip() for a in (args.arch or "qwen3-0.6b").split(",")
             if a.strip()]
    # what-if pricing: --profile plans against another machine's measured
    # facts (loaded without the freshness gate); the default (None, not
    # "auto") pins analytic pricing, so the plan does not depend on any
    # profile cached on this machine
    profile = None
    if args.profile:
        from repro_torch.profiler import load_facts
        profile = load_facts(args.profile, require_fresh=False)
    session = Session(HydraConfig(
        n_devices=args.n_devices,
        device_budget_bytes=int(args.budget_mb * 10**6)),
        device=args.device, profile=profile)
    for i, arch in enumerate(archs):
        cfg = get_config(arch, smoke=args.smoke)
        loader = _plan_loader(cfg, 2, 64, i, args.device)
        session.submit(TrainJob(cfg, loader, epochs=1, steps_per_epoch=2,
                                seed=i, batch=2, seq=64))
    plan = session.plan()

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    plan.save(args.out)
    if Plan.load(args.out).to_json() != plan.to_json():
        raise AssertionError(f"plan JSON does not round-trip ({args.out})")

    summary = plan.summary()
    print(json.dumps(summary))
    est = summary["est_makespan_s"]
    print(f"plan -> {args.out}  ({len(plan.jobs)} jobs, "
          f"est makespan {est:.3e}s, round-trip OK)" if est is not None
          else f"plan -> {args.out}  ({len(plan.jobs)} jobs, round-trip OK)")
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None,
                    help="records (JSON lines, appended); default "
                    "results/dryrun_torch.jsonl, or results/plan.json "
                    "with --plan")
    # session-plan mode: partition/spill/schedule, no execution
    ap.add_argument("--plan", action="store_true",
                    help="emit a Session Plan JSON instead of lowering")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced configs")
    ap.add_argument("--n-devices", type=int, default=2,
                    help="(--plan) virtual device count")
    ap.add_argument("--budget-mb", type=float, default=18,
                    help="(--plan) per-device budget, MB")
    ap.add_argument("--profile", default=None,
                    help="(--plan) MachineFacts JSON to price the plan "
                    "with — the what-if tool; default analytic")
    ap.add_argument("--device", default="cuda",
                    help="(--plan) cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.plan:
        args.out = args.out or "results/plan.json"
        return plan_dryrun(args)
    args.out = args.out or "results/dryrun_torch.jsonl"
    return lowering_dryrun(args)


if __name__ == "__main__":
    main()
