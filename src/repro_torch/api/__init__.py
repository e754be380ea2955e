"""Session API of the port (port of ``repro.api``): train, serve and eval
jobs under one device budget.

    from repro_torch.api import (Session, TrainJob, ServeJob, EvalJob,
                                 HydraConfig)

    session = Session(HydraConfig(n_devices=2, device_budget_bytes=6 * 10**6),
                      device="cpu")
    session.submit(TrainJob(cfg, loader, lr=1e-3, epochs=1))
    session.submit(ServeJob(cfg, params=weights, cold=True))
    plan = session.plan()        # JSON-serializable
    plan.save("plan.json")       # ... and Plan.load("plan.json") later
    report = session.run(plan)   # or session.run_async(plan).result()
"""

from repro_torch.api.jobs import (EvalJob, JobSpec, ServeJob, SpmdTrainJob,
                                  TrainJob)
from repro_torch.api.plan import JobPlan, Plan
from repro_torch.api.session import (AsyncRun, JobState, Session,
                                     SessionReport)
from repro_torch.core.sharp import HydraConfig

__all__ = ["Session", "SessionReport", "AsyncRun", "JobState", "JobSpec",
           "TrainJob", "EvalJob", "ServeJob", "SpmdTrainJob", "Plan",
           "JobPlan", "HydraConfig"]
