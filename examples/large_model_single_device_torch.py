"""The paper's scalability claim (§4.2) on the PyTorch port —
``examples/large_model_single_device.py`` through ``hydra_torch``: "even
a trillion-parameter model can now be trained on a single GPU out of the
box, given sufficient DRAM."

    PYTHONPATH=src python examples/large_model_single_device_torch.py [--device cpu]

Through one ``hydra.Session``, a model whose parameters + gradients +
Adam state are ~8x the device budget trains on ONE device purely through
model spilling — the planner cuts it into shards that fit, the memory
manager stages them through the device, and training proceeds normally.
The same session machinery then evaluates the trained model forward-only
under a budget three times tighter (paper §6: spilled large-model
inference) via an ``EvalJob``.  Runs on a CUDA device, or on the CPU when
asked; raises if the model is not larger than the budget.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import hydra_torch as hydra  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.partitioner import tree_bytes  # noqa: E402
from repro_torch.data import DataConfig, SyntheticTokens  # noqa: E402


def loader(cfg, seed, batch=2, seq=64):
    return SyntheticTokens(DataConfig(batch_size=batch, seq_len=seq,
                                      vocab_size=cfg.vocab_size, seed=seed))


def main(device="cuda", cfg=None, params=None, budget=14 * 10**6, steps=4,
         batch=2, seq=64, eval_budget=None) -> dict:
    """Returns the run's numbers: ``model_bytes``, ``budget``,
    ``eval_budget``, ``shards`` (index, first and last segment, bytes),
    ``losses``, ``units_executed``, ``promoted_bytes``, ``demoted_bytes``,
    the train exec as ``train_exec`` and the spilled eval's record as
    ``eval``.  ``cfg`` defaults to an 8-layer qwen3-0.6b smoke model,
    ``params`` to its weights from seed 0 and ``eval_budget`` to a third
    of ``budget``."""
    # an 8-layer model, budget sized so only ~1/4 of it fits at once
    cfg = cfg or get_config("qwen3-0.6b", smoke=True).replace(n_layers=8)

    session = hydra.Session(hydra.HydraConfig(
        n_devices=1, device_budget_bytes=budget), device=device)
    session.submit(hydra.TrainJob(cfg, loader(cfg, 0, batch, seq), lr=1e-3,
                                  epochs=1, steps_per_epoch=steps,
                                  batch=batch, seq=seq, params=params))
    plan = session.plan()

    m = session.train_execs[0]
    model_bytes = tree_bytes(m.store.params) * 4   # params+grads+adam
    print(f"model + optimizer state : {model_bytes / 1e6:7.1f} MB")
    print(f"device budget           : {budget / 1e6:7.1f} MB")
    print(f"shards                  : {len(m.partition.shards)}")
    shards = []
    for s in m.partition.shards:
        segs = m.plan.segments[s.seg_lo:s.seg_hi]
        print(f"  shard {s.index}: segments [{segs[0].name} .. "
              f"{segs[-1].name}]  {s.param_bytes / 1e6:6.1f} MB")
        shards.append((s.index, segs[0].name, segs[-1].name, s.param_bytes))

    report = session.run(plan)
    train = report.train
    print(f"\nlosses: {[round(l, 4) for l in train.losses[0]]}")
    dev = train.transfer[0]
    print(f"promoted {dev.promoted_bytes / 1e6:.0f} MB / "
          f"demoted {dev.demoted_bytes / 1e6:.0f} MB through the device")
    if not model_bytes > budget:
        raise AssertionError(
            f"the model's {model_bytes} B of params + grads + Adam state "
            f"fit the {budget} B device: it is not larger than the device")
    print("OK: larger-than-device model trained on one device via spilling")

    # paper §6: the same machinery serves larger-than-device INFERENCE —
    # an EvalJob under a 3x tighter budget, forward-only through the
    # shard queue, on the weights the session just trained
    eval_budget = eval_budget or budget // 3
    evaler = hydra.Session(hydra.HydraConfig(
        n_devices=1, device_budget_bytes=eval_budget), device=device)
    jid = evaler.submit(hydra.EvalJob(cfg, loader(cfg, 7, batch, seq),
                                      n_batches=1,
                                      params=m.store.model_params(),
                                      batch=batch, seq=seq))
    rec = evaler.run().evals[jid]
    print(f"spilled eval: {rec['n_shards']} shards, "
          f"{rec['bytes_moved'] / 1e6:.0f} MB moved, "
          f"loss {rec['mean_loss']:.4f}, ppl {rec['perplexity']:.1f}")
    return {"model_bytes": model_bytes, "budget": budget,
            "eval_budget": eval_budget, "shards": shards,
            "losses": list(train.losses[0]),
            "units_executed": train.units_executed,
            "promoted_bytes": dev.promoted_bytes,
            "demoted_bytes": dev.demoted_bytes, "train_exec": m,
            "eval": rec}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
