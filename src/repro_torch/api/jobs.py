"""Typed job specs accepted by ``repro_torch.api.Session`` (port of
``repro.api.jobs``).

* ``TrainJob`` — one model-selection candidate trained under SHARP
  (the fields of ``repro_torch.core.ModelTask``).
* ``ServeJob`` — one loaded model behind the continuous-batching engine;
  ``cold=True`` keeps the params spilled in the session's host store
  until the first request promotes them (SHARP-for-inference).
* ``EvalJob``  — fixed-batch loss/perplexity over a dataloader, executed
  forward-only through the same shard queue as training.

* ``SpmdTrainJob`` — one model trained over a device mesh (DTensor
  params laid out by ``sharding.specs``; ``launch/train.py``'s surface).

A job is inert data; ``Session.plan`` turns submitted jobs into a ``Plan``
and ``Session.run`` executes one.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence


@dataclass
class JobSpec:
    """Base spec: subclasses add workload fields; the session assigns ids."""
    cfg: Any                                    # ArchConfig

    kind: str = ""                              # set by subclasses


@dataclass
class TrainJob(JobSpec):
    """One SHARP training candidate (paper Fig. 4's ModelTask, spec form)."""
    dataloader: Optional[Any] = None            # iterable of batches
    lr: float = 1e-3
    epochs: int = 1
    steps_per_epoch: int = 4
    optimizer: str = "adamw"
    params: Optional[Any] = None                # init'd from seed if None
    seed: int = 0
    batch: int = 2                              # partitioning pilot shape
    seq: int = 128
    early_stop: Optional[Callable[[list], bool]] = None
    kind: str = field(default="train", init=False)

    @classmethod
    def from_task(cls, task) -> "TrainJob":
        """Adapter from ``repro_torch.core.orchestrator.ModelTask``."""
        return cls(cfg=task.cfg, dataloader=task.dataloader, lr=task.lr,
                   epochs=task.epochs, steps_per_epoch=task.steps_per_epoch,
                   optimizer=task.optimizer, params=task.params,
                   seed=task.seed, batch=task.batch, seq=task.seq,
                   early_stop=task.early_stop)

    def opt_config(self):
        from repro_torch.optim import optimizers as opt
        # per-shard stepping composes with sequential training only when
        # gradient clipping is off (clipping needs the global norm, which
        # no single shard sees) — Hydra therefore disables it
        return opt.OptimizerConfig(kind=self.optimizer, lr=self.lr,
                                   grad_clip=0.0)


@dataclass
class EvalJob(JobSpec):
    """Fixed-batch loss/perplexity over a dataloader, forward-only through
    the shard queue — a model bounded only by host DRAM evaluates on one
    device, sharing the partition/spill machinery with training."""
    dataloader: Optional[Any] = None
    n_batches: int = 1
    params: Optional[Any] = None                # init'd from seed if None
    seed: int = 0
    batch: int = 2                              # partitioning pilot shape
    seq: int = 128
    kind: str = field(default="eval", init=False)


@dataclass
class ServeJob(JobSpec):
    """One served model over the continuous-batching engine.

    ``backend`` selects the decode backend by name — ``"slot"`` (default),
    ``"paged"`` (``paged=True`` is the legacy spelling) or ``"spec"``
    (speculative decode: a ``draft_model`` drafts ``draft_k`` tokens a
    round and the target verifies them in one batched forward over a
    ``spec_inner`` slot or paged backend).  With ``kv_budget_bytes=None``
    paged and spec pages charge the SESSION's device-0 ``DeviceMemory``
    ledger — the budget SHARP shard promotions charge — so mixed
    train + serve plans stay byte-accurate; a non-None ``kv_budget_bytes``
    keeps a private ledger of that size.  ``cold=True`` defers promotion:
    the params live spilled in the session's host store and move to the
    device when the first request arrives.  ``params_from`` names a
    TrainJob of the same session whose trained weights this job serves
    straight out of its host store.  A family whose ``FamilySpec`` lacks
    the requested capability falls back (spec -> inner -> slot) with a
    ``CapabilityFallbackWarning``; the *effective* backend is recorded in
    the plan meta and ``session.poll``.

    ``verify_impl`` picks the spec backend's paged-verify path: the
    port's ``"cuda"`` (the kernel) or ``"ref"`` (the plain version), or
    the JAX spellings ``"pallas"`` / ``"jnp"``, which map to them
    (``checkpoint.convert.verify_impl_from_jax``).

    ``bucket_sizes``: length buckets for prefill admission — a sequence of
    ints, the string ``"pow2"`` for power-of-two buckets up to
    ``max_seq``, or None for exact-length groups.  A family that cannot
    prefill right-padded prompts falls back to exact-length groups, with
    the reason in the plan meta's ``capability_fallbacks``.

    Tiered memory: ``residency="shard"`` (a cold or ``params_from`` job)
    serves from the host store shard by shard, holding up to
    ``hot_bytes`` of shards on the device and streaming the rest each
    tick; ``tiered_kv`` (paged backend) demotes parked requests' pages to
    host DRAM and prefetches them back ``prefetch_ticks`` ticks later.
    """
    params: Optional[Any] = None                # init'd from seed if None
    seed: int = 0
    name: Optional[str] = None                  # routing key; cfg.name default
    capacity: int = 4
    max_seq: int = 256
    kv_budget_bytes: Optional[int] = None
    window: Optional[int] = None
    bucket_sizes: Optional[Any] = None          # Sequence[int] | "pow2" | None
    cold: bool = False
    backend: Optional[str] = None               # "slot"|"paged"|"spec"|None
    paged: bool = False                         # legacy alias: backend="paged"
    block_size: int = 16                        # KV rows per physical block
    prefix_share: bool = True                   # COW prefix sharing (paged)
    kv_dtype: Optional[str] = None              # None|"fp"|"int8"
    verify_impl: Optional[str] = None           # "cuda"|"ref" (or JAX names)
    # "auto" lets Session.submit pick the draft and/or k from the cost
    # model's draft-vs-target step times; resolved before validation and
    # recorded in plan meta as ``draft_auto``
    draft_model: Optional[Any] = None           # ArchConfig|"auto" (spec)
    draft_params: Optional[Any] = None          # init'd from draft_seed if None
    draft_seed: int = 0
    draft_k: Any = 4                            # int | "auto"
    spec_inner: Optional[str] = None            # "slot" (default) | "paged"
    # HTTP front-end options (whether the model streams tokens, an extra
    # route alias clients may pass as "model")
    stream: bool = True
    endpoint: Optional[str] = None
    # SLO scheduling (serving/slo.py): admission policy plus per-MODEL
    # defaults any request may override
    policy: str = "slo"
    deadline_ms: Optional[float] = None         # default e2e deadline budget
    priority: str = "normal"                    # default tier: high|normal|low
    max_ttft_ms: Optional[float] = None         # default first-token budget
    slo_aging_s: float = 30.0                   # starvation aging interval
    soft_overload_s: float = float("inf")       # queued-seconds: degrade spec
    hard_overload_s: float = float("inf")       # queued-seconds: shed/reject
    # tiered memory: weight residency of a cold job ("model": the whole
    # tree at the first request; "shard": hot shards + streamed shards)
    # and the host-DRAM KV tier
    residency: str = "model"                    # "model" | "shard"
    hot_bytes: Optional[int] = None             # shard residency: pin target
    tiered_kv: bool = False                     # host-DRAM KV tier (paged)
    prefetch_ticks: int = 1                     # host->device prefetch latency
    params_from: Optional[str] = None           # TrainJob id to serve from
    kind: str = field(default="serve", init=False)

    def http_options(self) -> dict:
        """The per-model options dict an HTTP front end consumes."""
        return {"stream": bool(self.stream), "endpoint": self.endpoint}

    def resolved_policy(self):
        """Validated scheduling policy instance for this model's engine."""
        from repro_torch.serving.slo import POLICIES, make_policy
        if self.policy not in POLICIES:
            raise ValueError(
                f"policy={self.policy!r}: known admission policies are "
                f"{sorted(POLICIES)}")
        if self.policy != "slo":
            return make_policy(self.policy)
        if self.slo_aging_s <= 0:
            raise ValueError(
                f"slo_aging_s={self.slo_aging_s}: the starvation-aging "
                "interval is the seconds of waiting that promote a request "
                "one priority tier; it must be positive")
        if self.soft_overload_s > self.hard_overload_s:
            raise ValueError(
                f"soft_overload_s={self.soft_overload_s} > hard_overload_s="
                f"{self.hard_overload_s}: shedding (hard) must not engage "
                "before degradation (soft); order the thresholds")
        return make_policy("slo", aging_s=self.slo_aging_s,
                           soft_overload_s=self.soft_overload_s,
                           hard_overload_s=self.hard_overload_s)

    def default_slo(self):
        """Validated per-model SLO defaults, or None when all unset —
        requests merge their own fields over these (request wins)."""
        from repro_torch.serving.slo import SLO
        if (self.deadline_ms is None and self.max_ttft_ms is None
                and self.priority == "normal"):
            return None
        return SLO(deadline_ms=self.deadline_ms, priority=self.priority,
                   max_ttft_ms=self.max_ttft_ms).validate()

    def validate_tiering(self) -> None:
        """Fail fast on tiered-memory misconfiguration (submit time, not
        mid-run): the tiering knobs only compose certain ways."""
        if self.residency not in ("model", "shard"):
            raise ValueError(
                f"residency={self.residency!r}: weight residency is "
                "'model' (whole-tree promotion on first request) or "
                "'shard' (pinned hot shards + streamed cold shards)")
        if self.residency == "shard" and not self.cold \
                and self.params_from is None:
            raise ValueError(
                "residency='shard' streams weights out of the session's "
                "host store, which only cold jobs have — set cold=True "
                "(or params_from=<train job id>, which implies it)")
        if self.hot_bytes is not None:
            if self.residency != "shard":
                raise ValueError(
                    "hot_bytes only applies to residency='shard' (it caps "
                    "the pinned hot-shard bytes); drop it or switch "
                    "residency")
            if self.hot_bytes < 0:
                raise ValueError(
                    f"hot_bytes={self.hot_bytes}: the pinned hot-shard "
                    "target must be >= 0 (0 streams every shard)")
        if self.prefetch_ticks < 1:
            raise ValueError(
                f"prefetch_ticks={self.prefetch_ticks}: host->device "
                "prefetch takes at least one engine step")
        if self.tiered_kv and self.requested_backend() != "paged":
            raise ValueError(
                f"tiered_kv=True needs the paged backend (KV pages are "
                f"the demotion unit), but this job requests "
                f"{self.requested_backend()!r}")
        if self.params_from is not None and self.params is not None:
            raise ValueError(
                "conflicting spec: params_from names a TrainJob to serve "
                "from, but explicit params were also given; drop one")
        self._validate_kv_dtype()

    def _validate_kv_dtype(self) -> None:
        """Fail fast on KV-quantization misconfiguration: int8 needs a
        paged pool and a family that declares the quantized layout."""
        if self.kv_dtype not in (None, "fp", "int8"):
            raise ValueError(
                f"kv_dtype={self.kv_dtype!r}: expected None, 'fp', or "
                "'int8'")
        req = self.requested_backend()
        has_pages = req == "paged" or (
            req == "spec" and self.resolved_spec_inner() == "paged")
        if self.kv_dtype == "int8":
            if not has_pages:
                raise ValueError(
                    "kv_dtype='int8' quantizes the paged block pool, but "
                    f"this job requests {req!r} — serve with "
                    "backend='paged' (or backend='spec', "
                    "spec_inner='paged')")
            from repro_torch.models.registry import spec as family_spec
            fspec = family_spec(self.cfg)
            if not fspec.kv_quant:
                raise ValueError(
                    f"{self.cfg.name} ({self.cfg.family}): "
                    f"{fspec.why_not('kv_quant')}")
        if self.verify_impl is not None and req != "spec":
            raise ValueError(
                "verify_impl selects the spec backend's paged-verify "
                f"kernel, but this job requests {req!r}")
        self.resolved_verify_impl()

    def resolved_verify_impl(self) -> Optional[str]:
        """``verify_impl`` in the port's names: 'cuda' / 'ref' as given,
        the JAX spellings mapped (None: verify follows the decode impl)."""
        if self.verify_impl in (None, "cuda", "ref"):
            return self.verify_impl
        from repro_torch.checkpoint.convert import verify_impl_from_jax
        return verify_impl_from_jax(self.verify_impl)

    def requested_backend(self) -> str:
        """The backend this spec asks for, before capability fallback."""
        if self.backend is not None:
            if self.backend not in ("slot", "paged", "spec"):
                raise ValueError(
                    f"backend={self.backend!r}: known decode backends are "
                    "'slot', 'paged', and 'spec'")
            if self.paged and self.backend != "paged":
                raise ValueError(
                    "conflicting spec: paged=True but backend="
                    f"{self.backend!r}; drop one of them (spec over pages "
                    "is spelled backend='spec', spec_inner='paged')")
            if self.backend == "spec":
                self._validate_draft()
            return self.backend
        return "paged" if self.paged else "slot"

    def _validate_draft(self) -> None:
        """Fail at submit/plan time — not mid-run in the backend ctor —
        when the draft side of a spec job can never execute.  (The TARGET
        lacking ``spec_draftable`` is a planned fallback, not an error;
        a bad DRAFT is a configuration mistake with no fallback.)"""
        if self.draft_model == "auto" or self.draft_k == "auto":
            raise ValueError(
                "draft_model/draft_k='auto' are resolved by Session.submit "
                "from the machine profile (the profiler's CostModel picks "
                "them from draft-vs-target step times); outside a Session "
                "pass an explicit ArchConfig draft_model and int draft_k")
        if self.draft_model is None:
            raise ValueError(
                "backend='spec' needs a draft member model: pass "
                "draft_model=<ArchConfig> (and optionally "
                "draft_params/draft_seed, draft_k, spec_inner)")
        from repro_torch.models.registry import spec as family_spec
        dspec = family_spec(self.draft_model)
        if not dspec.spec_draftable:
            raise ValueError(
                f"draft {self.draft_model.name} "
                f"({self.draft_model.family}): "
                f"{dspec.why_not('spec_draftable')} — pick a "
                "spec_draftable draft family")
        if self.draft_model.vocab_size != self.cfg.vocab_size:
            raise ValueError(
                f"draft vocab {self.draft_model.vocab_size} != target "
                f"vocab {self.cfg.vocab_size}: greedy-exact acceptance "
                "compares token ids, so the models must share a tokenizer")

    def resolved_spec_inner(self) -> str:
        """The inner backend a spec job wraps, before capability checks."""
        if self.spec_inner is None:
            return "slot"
        if self.spec_inner not in ("slot", "paged"):
            raise ValueError(f"spec_inner={self.spec_inner!r}: the spec "
                             "backend wraps 'slot' or 'paged'")
        return self.spec_inner

    def effective_backend(self) -> str:
        """The backend the engine will actually run, after checking the
        family's declared capabilities (mirrors the engine's fallback)."""
        from repro_torch.models.registry import spec as family_spec
        req = self.requested_backend()
        spec = family_spec(self.cfg)
        if req == "spec" and not spec.spec_draftable:
            req = self.resolved_spec_inner()
        if req == "paged" and not spec.paging:
            return "slot"
        return req

    def effective_spec_inner(self) -> Optional[str]:
        """For an effective spec backend: the inner backend after the
        paging capability check; None when the job is not spec."""
        if self.effective_backend() != "spec":
            return None
        from repro_torch.models.registry import spec as family_spec
        inner = self.resolved_spec_inner()
        if inner == "paged" and not family_spec(self.cfg).paging:
            return "slot"
        return inner

    def resolved_buckets(self) -> Optional[Sequence[int]]:
        """The prefill length buckets (None: exact-length groups)."""
        if self.bucket_sizes is None:
            return None
        if isinstance(self.bucket_sizes, str):
            if self.bucket_sizes != "pow2":
                raise ValueError(
                    f"bucket_sizes={self.bucket_sizes!r}: the only named "
                    "scheme is 'pow2'; otherwise pass explicit ints")
            from repro_torch.serving.engine import pow2_buckets
            return pow2_buckets(self.max_seq)
        buckets = [int(b) for b in self.bucket_sizes]
        if any(b < 1 for b in buckets):
            raise ValueError(f"bucket_sizes={self.bucket_sizes!r}: "
                             "buckets must be positive lengths")
        if any(b > self.max_seq for b in buckets):
            # the engine would silently drop these, making the plan's
            # bucket list diverge from the live engine's
            raise ValueError(f"bucket_sizes={self.bucket_sizes!r}: buckets "
                             f"cannot exceed max_seq={self.max_seq}")
        return buckets


@dataclass
class SpmdTrainJob(JobSpec):
    """Single-model training over a device mesh (no spilling — the model
    fits; Hydra's multi-model layer schedules over sub-meshes of this
    substrate).  Mirrors the ``launch/train.py`` CLI surface.  ``mesh``
    is "auto" (every rank of the process group: (1, 1) for a world of
    one), "production" (``launch.mesh.make_production_mesh``) or a
    ``DeviceMesh``."""
    steps: int = 100
    batch: int = 8
    seq: int = 256
    accum: int = 1
    lr: float = 3e-4
    optimizer: str = "adamw"
    seed: int = 0
    data: Optional[str] = None                  # token .bin (else synthetic)
    mesh: Any = "auto"                          # "auto" | "production" | mesh
    multi_pod: bool = False
    log_every: int = 10
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 100
    kind: str = field(default="spmd", init=False)
