"""Quickstart of the PyTorch port — ``examples/quickstart.py`` through
``hydra_torch``: the paper's Fig-4 API in 20 lines.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Trains two BERT*-class models concurrently with SHARP on 2 virtual
devices of 6 MB (plan first, then run the same Plan) on a CUDA device, or
on the CPU when asked, then checks that model 0's losses equal plain
sequential training's (rtol = atol = 3e-4) and raises if they do not.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import hydra_torch as hydra  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import ModelTask, train_sequential_reference  # noqa: E402
from repro_torch.data import DataConfig, SyntheticTokens  # noqa: E402

TOL = 3e-4


def loader(cfg, seed):
    return SyntheticTokens(DataConfig(batch_size=2, seq_len=64,
                                      vocab_size=cfg.vocab_size, seed=seed))


def main(device="cuda", cfg=None, params=(None, None)) -> dict:
    """Returns ``{model id: losses, "reference": model 0's sequential
    losses}``.  ``cfg`` and ``params`` (one tree or None per model)
    default to the bert-large-1b smoke config and weights from seed 0."""
    cfg = cfg or get_config("bert-large-1b", smoke=True)

    session = hydra.Session(hydra.HydraConfig(
        n_devices=2, device_budget_bytes=6 * 10**6), device=device)
    session.submit(hydra.TrainJob(cfg, loader(cfg, 0), lr=1e-3, epochs=1,
                                  steps_per_epoch=3, batch=2, seq=64,
                                  params=params[0]))
    session.submit(hydra.TrainJob(cfg, loader(cfg, 1), lr=1e-4, epochs=1,
                                  steps_per_epoch=3, batch=2, seq=64,
                                  params=params[1]))

    plan = session.plan()        # partitions + spill placement + estimate
    for jid, rec in plan.summary()["jobs"].items():
        print(f"{jid}: {rec['n_shards']} shards, host {rec['host_mb']} MB")

    report = session.run(plan)   # the dry-run's Plan IS the executed one
    train = report.train
    print(f"makespan          {train.makespan * 1e3:.1f} ms (virtual)")
    print(f"avg utilization   {train.avg_utilization:.0%}")
    for mid, losses in train.losses.items():
        print(f"model {mid} losses    {[round(l, 4) for l in losses]}")

    # Hydra's desideratum: no effect on accuracy
    _, ref = train_sequential_reference(
        ModelTask(cfg, loader(cfg, 0), lr=1e-3, epochs=1,
                  steps_per_epoch=3, batch=2, seq=64, params=params[0]),
        device=device)
    print(f"sequential ref    {[round(l, 4) for l in ref]}  (model 0)")
    for got, want in zip(train.losses[0], ref):
        if abs(got - want) > TOL + TOL * abs(want):
            raise AssertionError(
                f"model 0's SHARP losses {train.losses[0]} differ from "
                f"sequential training's {ref} (rtol = atol = {TOL})")
    return {**train.losses, "reference": ref}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
