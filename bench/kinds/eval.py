"""Traffic of kind "eval": one grid model scored by an ``EvalJob``.

The feed opens the window when the program asks for the first batch
after the warm ones, and ends the job when it asks for one after
``seconds``: the window holds whole batches only.  A sample of the
window's batches, drawn from the seed, is checked against the reference.
"""

from __future__ import annotations

import gc
import random
import time

import torch

from bench import check, gen
from bench.harness import arch_config, reference_module, sync
from bench.metrics import flops as flop_count


def run(r, seed, seconds, device, tracer):
    from repro_torch.api import EvalJob, Session
    from repro_torch.core.sharp import HydraConfig
    fam, arch, traffic = r["init"], r["arch"], r["traffic"]
    cfg = arch_config(arch)
    seq, batch, warm = traffic["seq"], traffic["batch"], \
        traffic["warm_batches"]
    session = Session(HydraConfig(**r["config"]["hydra"]), device=device,
                      profile=None)
    state = {"t0": None, "t1": None, "t0_epoch": 0.0, "t1_ns": 0}

    def on_next(k):
        now = time.perf_counter()
        if k == warm:
            state["t0_epoch"] = time.time()
            if tracer:
                tracer.start()
            state["t0"] = now = time.perf_counter()
        elif state["t0"] is not None and now >= state["t0"] + seconds:
            state["t1"], state["t1_ns"] = now, time.time_ns()
            raise StopIteration

    job = EvalJob(cfg, dataloader=gen.Batches(fam, arch, seq, batch, seed, 0,
                                              device, on_next),
                  n_batches=10**9,
                  params=gen.make_weights(fam, arch, seed, 0, device),
                  batch=batch, seq=seq)
    jid = session.submit(job)
    sync(device)
    t = time.perf_counter()
    session.train_execs                      # builds the host store
    sync(device)
    pin_s = time.perf_counter() - t
    job.params = None
    report = session.run()
    if state["t1"] is None:
        raise RuntimeError("the evaluation ended before its window closed")
    if tracer:
        tracer.stop(state["t1_ns"])
    losses = report.evals[jid]["losses"]
    window = losses[warm:]
    window_s = state["t1"] - state["t0"]
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    del session, report, job
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    pick = _sample(r, seed, len(losses))
    t_ref = time.perf_counter()
    refs = _references(r, seed, pick, device)
    readings, where = check.compare_eval([losses[k] for k in pick], refs)
    where["losses"] = [[losses[k], v] for k, v in zip(pick, refs)]
    tokens = len(window) * batch * seq
    return {"kind": "eval", "t0_epoch": state["t0_epoch"],
            "window_s": window_s, "steps": len(window), "tokens": tokens,
            "flops": tokens * flop_count.per_token(fam, arch, seq,
                                                   train=False),
            "pin_s": pin_s, "pin_bytes": gen.weight_bytes(fam, arch),
            "window_losses": window, "peak": peak,
            "readings": readings, "where": where,
            "reference_s": time.perf_counter() - t_ref}


def _sample(r, seed, n_batches) -> list[int]:
    """The checked batches: a sample of the window's, drawn from the seed."""
    warm = r["traffic"]["warm_batches"]
    return random.Random(gen.derive_seed(seed, "sample")).sample(
        range(warm, n_batches), min(r["traffic"]["sample"], n_batches - warm))


def _references(r, seed, pick, device, **kw) -> list[float]:
    fam, arch, traffic = r["init"], r["arch"], r["traffic"]
    ref = reference_module(r["config"])
    w = gen.make_weights(fam, arch, seed, 0, device)
    return [ref.eval_loss(arch, w, gen.make_batch(
        fam, arch, traffic["seq"], traffic["batch"], seed, 0, k, device),
        **kw) for k in pick]


def control_readings(r, seed, device, n_window: int = 150) -> dict:
    """The float8 control and the half-batch fault over the batches a
    window of ``n_window`` batches would check, each compared with the
    float32 reference as a run compares the program."""
    pick = _sample(r, seed, r["traffic"]["warm_batches"] + n_window)
    f32 = _references(r, seed, pick, device)
    return {k: check.compare_eval(_references(r, seed, pick, device, **kw),
                                  f32)[0]
            for k, kw in (("control", {"precision": "fp8"}),
                          ("half_batch", {"rows": "half"}))}
