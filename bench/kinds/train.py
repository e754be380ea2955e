"""Traffic of kind "train": a grid of models trained at once.

Every grid model is a ``TrainJob`` with the weights the benchmark drew
and a feed of its own batches; set-up builds the host stores, runs the
pilot and every model's checked first steps, reading each model's first
gradient after step 1 and its change after the last checked step.

The window opens at a minibatch boundary, once every model has made its
checked steps, where no other model has run a unit of its current
minibatch: every minibatch the window counts began inside it.  It
closes when each model has reached its first minibatch boundary after
``seconds``, and counts the tokens of every minibatch completed in it.
"""

from __future__ import annotations

import gc
import time

import torch

from bench import check, gen, program_state
from bench.harness import (arch_config, mem_available_bytes,
                           reference_module, sync)
from bench.metrics import flops as flop_count


class _TrainClock:
    """Minibatch boundaries of every grid model, from ``early_stop``."""

    def __init__(self, n_models, execs, checked, seconds, on_step, on_open):
        self.execs = execs                     # filled before the run
        self.done = [0] * n_models
        self.checked, self.seconds = checked, seconds
        self.on_step, self.on_open = on_step, on_open
        self.t0 = None
        self.t0_epoch = 0.0
        self.completions: list[tuple[float, int, int]] = []

    def _others_between_minibatches(self, i) -> bool:
        return all(e.cursor == 0 for j, e in enumerate(self.execs)
                   if j != i and not e.done)

    def hook(self, i):
        def early_stop(_losses):
            self.done[i] += 1
            now = time.perf_counter()
            if self.t0 is not None:
                self.completions.append((now, i, time.time_ns()))
                return now >= self.t0 + self.seconds
            if self.done[i] <= self.checked:
                self.on_step(i, self.done[i])
            if min(self.done) >= self.checked \
                    and self._others_between_minibatches(i):
                self.t0_epoch = time.time()
                self.on_open()
                self.t0 = time.perf_counter()
            return False
        return early_stop


def run(r, seed, seconds, device, tracer):
    from repro_torch.api import Session, TrainJob
    from repro_torch.core.sharp import HydraConfig
    fam, arch, traffic = r["init"], r["arch"], r["traffic"]
    cfg = arch_config(arch)
    models, seq = traffic["models"], traffic["seq"]
    checked = traffic["checked_steps"]
    need = 3 * gen.weight_bytes(fam, arch) * len(models)
    if device.type == "cuda" and need > mem_available_bytes() / 2:
        raise RuntimeError(
            f"the host stores need {need / 1e9:.1f} GB, over half of "
            f"MemAvailable ({mem_available_bytes() / 1e9:.1f} GB)")
    session = Session(HydraConfig(**r["config"]["hydra"]), device=device,
                      profile=None)
    snaps = [dict() for _ in models]
    execs = []

    def on_step(i, n):
        store = execs[i].store
        if n == 1:
            snaps[i]["grad"] = program_state.first_grad_norms(store)
        if n == checked:
            snaps[i]["change"] = program_state.change_norms(
                store, fam, arch, seed, i)

    clock = _TrainClock(len(models), execs, checked, seconds, on_step,
                        tracer.start if tracer else (lambda: None))
    jobs = []
    for i, m in enumerate(models):
        job = TrainJob(
            cfg, dataloader=gen.Batches(fam, arch, seq, m["batch"], seed, i,
                                        device),
            lr=m["lr"], epochs=1,
            steps_per_epoch=traffic["steps"],
            optimizer="adamw",
            params=gen.make_weights(fam, arch, seed, i, device),
            batch=m["batch"], seq=seq, early_stop=clock.hook(i))
        session.submit(job)
        jobs.append(job)
    sync(device)
    t = time.perf_counter()
    execs.extend(session.train_execs)          # builds the host stores
    sync(device)
    pin_s = time.perf_counter() - t
    for job in jobs:
        job.params = None                      # the stores hold the weights
    report = session.run()
    if clock.t0 is None or not clock.completions:
        raise RuntimeError("the window never opened or saw no minibatch "
                           "complete: the run ended in set-up")
    t1, _, t1_ns = clock.completions[-1]
    if tracer:
        tracer.stop(t1_ns)
    window_s, t0_epoch = t1 - clock.t0, clock.t0_epoch
    steps = len(clock.completions)
    tokens = sum(models[i]["batch"] * seq for _, i, _ in clock.completions)
    losses = [report.train.losses[m.model_id] for m in execs]
    done = [len(x) for x in losses]
    # a model's window minibatches are its last ones: count them back
    in_window = [sum(1 for _, j, _ in clock.completions if j == i)
                 for i in range(len(models))]
    window_losses = [v for i, x in enumerate(losses)
                     for v in x[done[i] - in_window[i]:]]
    prog = [{"losses": losses[i][:checked], **snaps[i]}
            for i in range(len(models))]
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    del session, execs, report, jobs, clock
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    refs = [_reference(r, seed, i, device) for i in range(len(models))]
    readings, where = check.compare_train(prog, refs)
    where["losses"] = [[p["losses"], q["losses"]] for p, q in zip(prog, refs)]
    return {"kind": "train", "t0_epoch": t0_epoch,
            "window_s": window_s, "steps": steps, "tokens": tokens,
            "flops": tokens * flop_count.per_token(fam, arch, seq,
                                                   train=True),
            "pin_s": pin_s,
            "pin_bytes": 3 * gen.weight_bytes(fam, arch) * len(models),
            "window_losses": window_losses, "peak": peak,
            "readings": readings, "where": where,
            "reference_s": time.perf_counter() - t_ref}


def _reference(r, seed, i, device, **kw) -> dict:
    """The reference's checked steps of grid model ``i`` from the same
    seeded weights and batches."""
    fam, arch, traffic = r["init"], r["arch"], r["traffic"]
    m = traffic["models"][i]
    w = gen.make_weights(fam, arch, seed, i, device)
    batches = [gen.make_batch(fam, arch, traffic["seq"], m["batch"], seed,
                              i, k, device)
               for k in range(traffic["checked_steps"])]
    return reference_module(r["config"]).train(arch, w, batches,
                                               lr=m["lr"], **kw)


def control_readings(r, seed, device) -> dict:
    """The float8 control and the half-batch fault, each compared with
    the float32 reference as a run compares the program; a state left
    unchanged."""
    runs: dict = {"f32": [], "control": [], "half_batch": []}
    for i in range(len(r["traffic"]["models"])):
        runs["f32"].append(_reference(r, seed, i, device))
        runs["control"].append(_reference(r, seed, i, device,
                                          precision="fp8"))
        runs["half_batch"].append(_reference(r, seed, i, device,
                                             rows="half"))
    out = {k: check.compare_train(v, runs["f32"])[0]
           for k, v in runs.items() if k != "f32"}
    unchanged = [{**x, "change": {k: 0.0 for k in x["change"]}}
                 for x in runs["f32"]]
    out["unchanged"] = check.compare_train(unchanged, runs["f32"])[0]
    return out
