"""``MachineFacts`` — the versioned, JSON-serializable record of what the
profiler measured on THIS host (port of ``repro.profiler.facts``): probe
once, persist to ``results/profile_latest_torch.json``, plan against the
cached facts.

The schema is the JAX package's (version 1, the same fields and JSON):

* ``fingerprint``  — platform/device identity; a loaded profile whose
  fingerprint no longer matches the running host is *stale* and every
  consumer falls back to the analytic constants (with a
  ``StaleProfileWarning``) rather than pricing plans with another
  machine's numbers.  Here it names torch and CUDA, so a profile written
  by the JAX package is stale in the port, and the reverse.
* ``hardware``     — the roofline constants (``ANALYTIC_HARDWARE`` unless a
  profile overrides them; ``hardware_constants()`` is the accessor).
* ``transfer``     — host<->device bandwidth rows (both directions, a few
  payload sizes) from ``probes.probe_transfer``.
* ``decode``       — per-family prefill/decode step latency over a small
  rectangular (batch, seq) grid from ``probes.probe_decode``.
* ``kernels``      — kernel-vs-plain-version timings from
  ``probes.probe_kernels``.

Everything here is pure data plus (de)serialization;
``current_fingerprint`` reads torch's device state only when called.
"""

from __future__ import annotations

import dataclasses
import json
import os
import platform
import time
import warnings
from dataclasses import dataclass, field
from typing import Optional

SCHEMA_VERSION = 1

# not the JAX package's results/profile_latest.json: that one's tests load
# it automatically and must not see a profile of the port's
DEFAULT_PATH = os.path.join("results", "profile_latest_torch.json")

# -- analytic defaults ------------------------------------------------------
# One NVIDIA H100 SXM (NVIDIA's data sheet, dense rates).  With no profile
# on disk ``CostModel.hardware`` reads exactly these values.
PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor-core rate
HBM_BW = 3.35e12                # HBM3 bytes/s
ICI_BW = 900e9                  # NVLink 4 bytes/s per GPU (450 each way)
# host<->device prior: the paper's 16 GB/s link (PCIe3 x16), which SHARP's
# ``link_bw`` models — a planning constant, not a measurement of a card
H2D_BW = 16e9

ANALYTIC_HARDWARE = {
    "peak_flops_bf16": PEAK_FLOPS_BF16,
    "hbm_bw": HBM_BW,
    "ici_bw": ICI_BW,
    "h2d_bw": H2D_BW,
}


class StaleProfileWarning(UserWarning):
    """A persisted profile's fingerprint no longer matches this host."""


def current_fingerprint(device=None) -> dict:
    """Identity of the running host and ``device`` (default: the card
    when there is one, else the CPU), compared on profile load."""
    import torch
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    on_cuda = torch.device(device).type == "cuda"
    return {
        "backend": "cuda" if on_cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if on_cuda else "cpu",
        "n_devices": torch.cuda.device_count() if on_cuda else 1,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "machine": platform.machine(),
        "system": platform.system(),
    }


@dataclass
class MachineFacts:
    """Everything the probes measured, ready to price a plan."""
    fingerprint: dict
    created_unix: float = 0.0
    schema_version: int = SCHEMA_VERSION
    hardware: dict = field(default_factory=lambda: dict(ANALYTIC_HARDWARE))
    transfer: dict = field(default_factory=dict)    # {"h2d":[rows],"d2h":[..]}
    decode: dict = field(default_factory=dict)      # family -> grid record
    kernels: dict = field(default_factory=dict)     # name -> timing record
    # family -> measured draft-acceptance record from probe_accept_rates
    # ({"target","draft","draft_k","accept_rate","rounds"})
    accept_rates: dict = field(default_factory=dict)
    notes: dict = field(default_factory=dict)       # probe provenance/knobs

    # -- identity -----------------------------------------------------------
    def is_stale(self, fingerprint: Optional[dict] = None) -> bool:
        fp = fingerprint if fingerprint is not None else current_fingerprint()
        return fp != self.fingerprint

    # -- (de)serialization --------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "MachineFacts":
        v = d.get("schema_version")
        if v != SCHEMA_VERSION:
            raise ValueError(
                f"unsupported MachineFacts schema_version {v!r} (this build "
                f"reads version {SCHEMA_VERSION}); re-run "
                "`python -m repro_torch.profiler` to regenerate the profile")
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_json(cls, text: str) -> "MachineFacts":
        return cls.from_dict(json.loads(text))

    def save(self, path: str = DEFAULT_PATH) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            f.write(self.to_json(indent=1))
        return path

    @classmethod
    def load(cls, path: str = DEFAULT_PATH) -> "MachineFacts":
        with open(path) as f:
            return cls.from_json(f.read())

    # -- summaries ----------------------------------------------------------
    def age_seconds(self) -> float:
        return max(0.0, time.time() - self.created_unix)

    def summary(self) -> dict:
        return {
            "created_unix": self.created_unix,
            "fingerprint": self.fingerprint,
            "hardware": self.hardware,
            "transfer_points": {d: len(rows)
                                for d, rows in self.transfer.items()},
            "decode_families": sorted(self.decode),
            "kernels": sorted(self.kernels),
            "accept_rate_families": sorted(self.accept_rates),
        }


def load_facts(path: str = DEFAULT_PATH, *, missing_ok: bool = False,
               require_fresh: bool = True) -> Optional[MachineFacts]:
    """Load + staleness-gate a persisted profile.

    Returns None (never raises) when ``missing_ok`` and the file does not
    exist — the Session auto-load path, where "no profile yet" is normal.
    A stale profile returns None with a ``StaleProfileWarning`` so callers
    fall back to analytic pricing instead of trusting another machine's
    measurements.
    """
    if missing_ok and not os.path.exists(path):
        return None
    facts = MachineFacts.load(path)
    if require_fresh and facts.is_stale():
        here = current_fingerprint()
        warnings.warn(
            f"profile {path} was measured on "
            f"{facts.fingerprint.get('device_kind')!r} "
            f"({facts.fingerprint.get('backend')}/torch "
            f"{facts.fingerprint.get('torch')}) but this host is "
            f"{here.get('device_kind')!r} ({here.get('backend')}/torch "
            f"{here.get('torch')}) — ignoring it; re-run "
            "`python -m repro_torch.profiler` to refresh",
            StaleProfileWarning, stacklevel=2)
        return None
    return facts


def hardware_constants(facts: Optional[MachineFacts] = None) -> dict:
    """The roofline constants, with their provenance tag: with no facts (or
    facts that never overrode hardware), the analytic table."""
    out = dict(ANALYTIC_HARDWARE)
    source = "analytic"
    if facts is not None:
        for k, v in (facts.hardware or {}).items():
            if k in out and v != out[k]:
                out[k] = v
                source = "measured"
    out["source"] = source
    return out
