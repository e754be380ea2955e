r"""Request objects + per-request latency/throughput metrics.

Lifecycle (see docs/serving.md):

    QUEUED --admit--> RUNNING --last token--> FINISHED
      |  ^  \          |  |      \
      |  |   cancel    |  |       cancel (released next tick)
      |  |      \      |  |          \
      |  |       +-----+--|------> CANCELLED
      |  +---resume----+  +--preempt--> PREEMPTED (back in queue,
      |   (prefill skipped)              KV blocks snapshot-held)
      +--shed (hard overload)---> REJECTED
      arrival_time       admit_time / first_token_time ... finish_time

``cancel`` is first-class (``InferenceEngine.cancel``): a queued request
is retired at the next admission pass without ever being reserved or
prefilled; a running one keeps CANCELLED through retirement while its
lane and KV reservation release normally.  PREEMPTED is the one
non-terminal detour: a paged request descheduled by the SLO policy keeps
its refcounted KV blocks (and its byte reservation) in a backend-side
snapshot and rejoins the queue; resume needs only a free lane and skips
prefill, so its output stays token-identical to an uninterrupted run.
REJECTED is terminal: shed under hard overload before ever running.
All timestamps come from the engine's injectable clock so tests can
freeze time; durations are derived lazily in ``metrics()``.
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from repro_torch.serving.slo import SLO

_ids = itertools.count()


class Status(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"
    CANCELLED = "cancelled"      # withdrawn (queued or mid-decode)
    PREEMPTED = "preempted"      # descheduled, KV held; NOT terminal
    REJECTED = "rejected"        # shed under hard overload; terminal


@dataclass(eq=False)
class Request:
    """One generation request: prompt tokens + a decode budget.

    Identity semantics (``eq=False``): requests live in queues and
    completion rings that remove/compare by object, and field equality
    would compare the prompt array elementwise.
    """
    prompt: np.ndarray                       # (plen,) int32
    max_new_tokens: int
    request_id: str = ""
    model: Optional[str] = None              # routing key (multi-model)
    eos_id: Optional[int] = None             # optional early stop
    arrival_time: Optional[float] = None     # stamped by the queue
    admit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    status: Status = Status.QUEUED
    slot: Optional[int] = None               # pool slot / decode lane
    generated: list[int] = field(default_factory=list)
    # SLO-aware scheduling (serving/slo.py): the request's declared
    # objective, the queue's monotonic arrival stamp (deterministic
    # tie-break), how often it was preempted, how many tokens it had at
    # its last admit/resume (anti-thrash floor), and — if shed — why
    slo: Optional[SLO] = None                # defaulted in __post_init__
    arrival_seq: Optional[int] = None        # stamped by the queue
    preemptions: int = 0
    resume_generated: int = 0
    shed_reason: Optional[str] = None
    # online serving: a TokenStream the engine feeds as tokens appear and
    # closes (with the terminal status) at retirement; None for batch use
    stream: Optional[Any] = None
    # paged engines only: blocks reserved at admission (the byte guarantee),
    # the high-water mark of blocks actually allocated while running, and
    # how many physical blocks were aliased from a prompt-prefix donor
    reserved_blocks: Optional[int] = None
    peak_blocks: Optional[int] = None
    shared_blocks: Optional[int] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if not self.request_id:
            self.request_id = f"req-{next(_ids)}"
        if self.slo is None:
            self.slo = SLO()
        self.slo.validate()

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def done(self) -> bool:
        if self.status in (Status.CANCELLED, Status.REJECTED):
            return True
        if len(self.generated) >= self.max_new_tokens:
            return True
        return bool(self.generated and self.eos_id is not None
                    and self.generated[-1] == self.eos_id)

    def remaining_tokens(self) -> int:
        return max(0, self.max_new_tokens - len(self.generated))

    def metrics(self) -> dict:
        """JSON-ready per-request latency/throughput record."""
        out = {
            "request_id": self.request_id,
            "model": self.model,
            "status": self.status.value,
            "prompt_len": self.prompt_len,
            "n_generated": len(self.generated),
        }

        def dur(a, b):
            return round(b - a, 6) if a is not None and b is not None else None

        if self.reserved_blocks is not None:
            out["kv_reserved_blocks"] = self.reserved_blocks
            out["kv_peak_blocks"] = self.peak_blocks
            out["kv_shared_blocks"] = self.shared_blocks
        out["queue_wait_s"] = dur(self.arrival_time, self.admit_time)
        out["ttft_s"] = dur(self.arrival_time, self.first_token_time)
        out["e2e_s"] = dur(self.arrival_time, self.finish_time)
        decode_s = dur(self.first_token_time, self.finish_time)
        out["decode_s"] = decode_s
        if decode_s and len(self.generated) > 1:
            out["decode_tok_per_s"] = round(
                (len(self.generated) - 1) / decode_s, 1)
        else:
            out["decode_tok_per_s"] = None
        # SLO outcome: deadline_met/ttft_met are None when no budget was
        # declared, False when the request never finished (shed/cancelled)
        out["priority"] = self.slo.priority
        out["preemptions"] = self.preemptions
        if self.shed_reason is not None:
            out["shed_reason"] = self.shed_reason
        if self.slo.deadline_ms is not None:
            out["deadline_ms"] = self.slo.deadline_ms
            e2e = out["e2e_s"]
            out["deadline_met"] = (e2e is not None
                                   and e2e * 1000.0 <= self.slo.deadline_ms
                                   and self.status is Status.FINISHED)
        else:
            out["deadline_met"] = None
        if self.slo.max_ttft_ms is not None:
            out["max_ttft_ms"] = self.slo.max_ttft_ms
            ttft = out["ttft_s"]
            out["ttft_met"] = (ttft is not None
                               and ttft * 1000.0 <= self.slo.max_ttft_ms)
        else:
            out["ttft_met"] = None
        return out
