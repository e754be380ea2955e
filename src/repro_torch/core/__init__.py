"""Hydra core: the paper's primary contribution (port of ``repro.core``).

Spilling (§4.2) + automated partitioning (§4.3) + SHARP (§4.4) + shard
orchestration (§4.5) + double buffering (§4.6) + Sharded-LRTF (§4.7).
The Fig 8 baselines are the submodule ``baselines``, imported by name
(``from repro_torch.core import baselines``), as in the JAX package.
"""

from repro_torch.core.orchestrator import (ModelOrchestrator, ModelTask,
                                           train_sequential_reference)
from repro_torch.core.partitioner import PartitionResult, Shard, partition
from repro_torch.core.scheduler import (ModelProgress, get_scheduler,
                                        greedy_list_makespan,
                                        optimal_makespan, sharded_lrtf)
from repro_torch.core.shard_graph import Segment, ShardPlan, build_plan
from repro_torch.core.sharp import (HydraConfig, RunReport, SharpExecutor,
                                    UnitEvent)

__all__ = ["ModelTask", "ModelOrchestrator", "train_sequential_reference",
           "HydraConfig", "SharpExecutor", "RunReport", "UnitEvent",
           "partition", "PartitionResult", "Shard",
           "build_plan", "ShardPlan", "Segment",
           "sharded_lrtf", "get_scheduler", "optimal_makespan",
           "greedy_list_makespan", "ModelProgress"]
