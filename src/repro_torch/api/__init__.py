"""Session API of the port, train and eval half (port of ``repro.api``).

    from repro_torch.api import Session, TrainJob, EvalJob, HydraConfig

    session = Session(HydraConfig(n_devices=2, device_budget_bytes=6 * 10**6),
                      device="cpu")
    session.submit(TrainJob(cfg, loader, lr=1e-3, epochs=1))
    plan = session.plan()        # JSON-serializable
    report = session.run(plan)
"""

from repro_torch.api.jobs import (EvalJob, JobSpec, ServeJob, SpmdTrainJob,
                                  TrainJob)
from repro_torch.api.plan import JobPlan, Plan
from repro_torch.api.session import JobState, Session, SessionReport
from repro_torch.core.sharp import HydraConfig

__all__ = ["Session", "SessionReport", "JobState", "JobSpec", "TrainJob",
           "EvalJob", "ServeJob", "SpmdTrainJob", "Plan", "JobPlan",
           "HydraConfig"]
