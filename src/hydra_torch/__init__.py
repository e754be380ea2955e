"""``import hydra_torch`` — the paper-named alias for ``repro_torch.api``,
the PyTorch port's counterpart of the JAX package's ``hydra``.

It re-exports the session API under the paper's name, the same names as
``hydra`` does, so an example reads the same on either package:

    import hydra_torch as hydra

    session = hydra.Session(hydra.HydraConfig(n_devices=2))
    session.submit(hydra.TrainJob(cfg, loader))
    report = session.run(session.plan())

The capability registry and decode-backend surface are re-exported too:
``family_spec(cfg)`` answers what a model family can do, and
``SlotBackend`` / ``PagedBackend`` / ``SpecDecodeBackend`` are the
decode-state layouts serving engines select between.

Everything here is a re-export; the implementation lives in
``repro_torch``.
"""

from repro_torch.api import (AsyncRun, EvalJob, HydraConfig, JobPlan,
                             JobSpec, JobState, Plan, ServeJob, Session,
                             SessionReport, SpmdTrainJob, TrainJob)
from repro_torch.models.api import family_spec
from repro_torch.models.registry import (CapabilityFallbackWarning,
                                         FamilySpec, families_with,
                                         registered_families)
from repro_torch.serving import (DecodeBackend, InferenceEngine,
                                 PagedBackend, SlotBackend,
                                 SpecDecodeBackend)

__all__ = ["Session", "SessionReport", "AsyncRun", "JobState",
           "JobSpec", "TrainJob", "ServeJob", "EvalJob", "SpmdTrainJob",
           "Plan", "JobPlan", "HydraConfig",
           "FamilySpec", "family_spec", "families_with",
           "registered_families", "CapabilityFallbackWarning",
           "DecodeBackend", "SlotBackend", "PagedBackend",
           "SpecDecodeBackend", "InferenceEngine"]
