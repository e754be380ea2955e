"""The explicit plan/execute split: ``Session.plan(jobs) -> Plan`` (port
of ``repro.api.plan``).

A ``Plan`` is pure data — per-job partitions (shard boundaries, byte sizes,
runtime estimates), spill placement (what stays host-resident), a
schedule estimate from the same greedy list scheduler the executor uses,
and the provenance of every price (analytic or measured).
It serializes to JSON, and ``Session.run(plan)`` consumes the *same*
object: a Plan re-loaded from disk reconstructs identical ``Shard`` lists,
so the executed schedule reproduces the planned one.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Optional

from repro_torch.core.partitioner import PartitionResult, Shard


def cfg_to_dict(cfg) -> dict:
    # the port's ArchConfig holds dtype names already: JSON-ready
    return dataclasses.asdict(cfg)


def cfg_from_dict(d: dict):
    from repro_torch.configs.base import ArchConfig
    return ArchConfig(**d)


def partition_to_dict(p: PartitionResult) -> dict:
    return {
        "shards": [dataclasses.asdict(s) for s in p.shards],
        "shared_bytes": p.shared_bytes,
        "budget_bytes": p.budget_bytes,
        "oracle": p.oracle,
    }


def partition_from_dict(d: dict) -> PartitionResult:
    return PartitionResult(
        shards=[Shard(**s) for s in d["shards"]],
        shared_bytes=d["shared_bytes"],
        budget_bytes=d["budget_bytes"],
        oracle=d["oracle"])


@dataclass
class JobPlan:
    """Planned placement for one job."""
    job_id: str
    kind: str                                   # train | eval
    arch: dict                                  # cfg_to_dict(cfg)
    partition: Optional[dict] = None
    # spill placement: bytes resident on host vs. promoted per unit
    host_bytes: int = 0
    max_shard_bytes: int = 0
    # workload shape
    meta: dict = field(default_factory=dict)

    def shards(self) -> PartitionResult:
        if self.partition is None:
            raise ValueError(f"{self.job_id}: no partition in plan")
        return partition_from_dict(self.partition)

    def cfg(self):
        return cfg_from_dict(self.arch)


@dataclass
class Plan:
    """Everything ``Session.run`` needs, and nothing it recomputes."""
    hydra: dict                                 # HydraConfig fields
    jobs: list[JobPlan] = field(default_factory=list)
    schedule: dict = field(default_factory=dict)
    # which cost facts priced which decision (profiler.CostModel
    # provenance_summary): {"profile": ... | None, "n_measured", "queries"}
    provenance: dict = field(default_factory=dict)
    version: int = 1

    def job(self, job_id: str) -> JobPlan:
        for jp in self.jobs:
            if jp.job_id == job_id:
                return jp
        raise KeyError(f"no job {job_id!r} in plan "
                       f"(have {[j.job_id for j in self.jobs]})")

    # -- serialization ------------------------------------------------------
    def to_json(self, **kw) -> str:
        return json.dumps({
            "version": self.version,
            "hydra": self.hydra,
            "schedule": self.schedule,
            "provenance": self.provenance,
            "jobs": [dataclasses.asdict(j) for j in self.jobs],
        }, **kw)

    @classmethod
    def from_json(cls, text: str) -> "Plan":
        d = json.loads(text)
        if d.get("version") != 1:
            raise ValueError(f"unsupported plan version {d.get('version')!r}")
        # .get: plans written before measured-cost planning carry none
        return cls(hydra=d["hydra"], schedule=d["schedule"],
                   provenance=d.get("provenance", {}),
                   jobs=[JobPlan(**j) for j in d["jobs"]],
                   version=d["version"])

    # -- reporting ----------------------------------------------------------
    def summary(self) -> dict:
        out: dict[str, Any] = {
            "n_jobs": len(self.jobs),
            "n_devices": self.hydra.get("n_devices"),
            "scheduler": self.schedule.get("scheduler"),
            "est_makespan_s": self.schedule.get("est_makespan_s"),
            "jobs": {},
        }
        if self.provenance:
            out["cost_source"] = ("measured"
                                  if self.provenance.get("n_measured")
                                  else "analytic")
            out["n_measured_queries"] = self.provenance.get("n_measured", 0)
        for jp in self.jobs:
            rec: dict[str, Any] = {"kind": jp.kind, "arch": jp.arch["name"]}
            if jp.partition is not None:
                rec["n_shards"] = len(jp.partition["shards"])
                rec["host_mb"] = round(jp.host_bytes / 1e6, 1)
                rec["max_shard_mb"] = round(jp.max_shard_bytes / 1e6, 1)
            rec.update(jp.meta)
            out["jobs"][jp.job_id] = rec
        return out
