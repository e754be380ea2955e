"""End-to-end model selection on the PyTorch port (the paper's core
workload) — ``examples/model_selection.py`` through ``hydra_torch``: a
hyper-parameter grid trained concurrently under SHARP through one
``hydra.Session``, with the schedule compared against model, pipeline and
task parallelism — a miniature of paper Fig 8.

    PYTHONPATH=src python examples/model_selection_torch.py [--device cpu]

Runs on a CUDA device, or on the CPU when asked.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import hydra_torch as hydra  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import baselines as bl  # noqa: E402
from repro_torch.data import DataConfig, SyntheticTokens  # noqa: E402

N_DEVICES = 4
BUDGET = 4500 * 10**3
GRID = tuple((lr, bs) for lr in (1e-3, 1e-4, 1e-5) for bs in (2, 4))


def main(device="cuda", cfg=None, params=None, grid=GRID, budget=BUDGET,
         n_devices=N_DEVICES, steps=2, seq=64, link_bw=None) -> dict:
    """Returns the run's numbers: SHARP's ``losses`` per model and its
    ``units_executed``, the ``makespan`` and ``utilization`` of each
    paradigm (task parallelism's makespan ``None`` when it runs out of
    memory, with its ``task_parallel_error``), the ``best`` model and its
    (lr, batch), and the ``session``.  ``cfg`` defaults to the
    bert-large-1b smoke config; ``params`` (one tree or None per grid
    point) to weights from each point's seed; ``link_bw`` (bytes/s of
    the host link SHARP's timeline charges transfers at) to
    ``HydraConfig``'s."""
    cfg = cfg or get_config("bert-large-1b", smoke=True)
    params = params or (None,) * len(grid)

    link = {} if link_bw is None else {"link_bw": link_bw}
    session = hydra.Session(hydra.HydraConfig(
        n_devices=n_devices, device_budget_bytes=budget, **link),
        device=device)
    for i, (lr, bs) in enumerate(grid):
        data = SyntheticTokens(DataConfig(batch_size=bs, seq_len=seq,
                                          vocab_size=cfg.vocab_size, seed=i))
        session.submit(hydra.TrainJob(cfg, data, lr=lr, epochs=1,
                                      steps_per_epoch=steps, seed=i,
                                      batch=bs, seq=seq, params=params[i]))

    report = session.run(session.plan())
    train = report.train

    job_steps = [j.epochs * j.steps_per_epoch
                 for j in session.jobs().values()
                 if isinstance(j, hydra.TrainJob)]
    models = session.train_execs
    mp = bl.model_parallel(models, n_devices, job_steps)
    pipe = bl.pipeline(models, n_devices, job_steps)

    print(f"{'paradigm':18s} {'makespan':>12s} {'util':>6s}")
    print(f"{'hydra (SHARP)':18s} {train.makespan:12.4f} "
          f"{train.avg_utilization:6.0%}")
    print(f"{'model parallel':18s} {mp.makespan:12.4f} "
          f"{mp.avg_utilization:6.0%}")
    print(f"{'pipeline':18s} {pipe.makespan:12.4f} "
          f"{pipe.avg_utilization:6.0%}")
    out = {"losses": dict(train.losses),
           "units_executed": train.units_executed,
           "makespan": {"sharp": train.makespan, "model_parallel":
                        mp.makespan, "pipeline": pipe.makespan},
           "utilization": {"sharp": train.avg_utilization,
                           "model_parallel": mp.avg_utilization,
                           "pipeline": pipe.avg_utilization},
           "session": session}
    try:
        tp = bl.task_parallel(models, n_devices, job_steps, budget)
        print(f"{'task parallel':18s} {tp.makespan:12.4f} "
              f"{tp.avg_utilization:6.0%}")
        out["makespan"]["task_parallel"] = tp.makespan
        out["utilization"]["task_parallel"] = tp.avg_utilization
    except MemoryError as e:
        print(f"{'task parallel':18s} {'CRASH (OOM)':>12s}   — {e}")
        out["makespan"]["task_parallel"] = None
        out["task_parallel_error"] = str(e)

    best = min(train.losses, key=lambda m: train.losses[m][-1])
    lr, bs = grid[best]
    print(f"\nbest config: model {best} (lr={lr}, batch={bs}) "
          f"final loss {train.losses[best][-1]:.4f}")
    out["best"] = (best, lr, bs)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    main(device=ap.parse_args().device)
