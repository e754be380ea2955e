"""Data pipeline: tokenized-LM batches with host-side prefetch (port of
``repro.data.pipeline``).

Two sources, both numpy streams that give the JAX package's numbers for
the same seed:
  * ``SyntheticTokens`` — seeded random token streams (benchmarks / smoke).
  * ``FileTokens`` — memory-mapped ``.bin`` uint16/uint32 token files.

Both yield ``{"tokens": (b, s), "labels": (b, s)}`` int32 numpy arrays
with next-token labels; ``as_tensors`` turns one into int64 tensors on a
device.  ``Prefetcher`` does that on a background thread, overlapping
host batch assembly with device compute.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    batch_size: int = 8
    seq_len: int = 512
    vocab_size: int = 32000
    seed: int = 0
    path: Optional[str] = None      # None -> synthetic
    dtype: str = "int32"


class SyntheticTokens:
    """Deterministic synthetic LM stream (a different stream per seed)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._rng = np.random.default_rng(cfg.seed)

    def __iter__(self) -> Iterator[dict]:
        cfg = self.cfg
        while True:
            toks = self._rng.integers(
                0, cfg.vocab_size, (cfg.batch_size, cfg.seq_len + 1),
                dtype=np.int64).astype(np.int32)
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class FileTokens:
    """Memory-mapped contiguous token file -> random-crop LM batches."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        dt = np.uint16 if cfg.dtype == "uint16" else np.uint32
        self.data = np.memmap(cfg.path, dtype=dt, mode="r")
        if len(self.data) < cfg.seq_len + 1:
            raise ValueError("token file shorter than one sequence")
        self._rng = np.random.default_rng(cfg.seed)

    def __iter__(self) -> Iterator[dict]:
        cfg = self.cfg
        hi = len(self.data) - cfg.seq_len - 1
        while True:
            starts = self._rng.integers(0, hi, cfg.batch_size)
            rows = np.stack([self.data[s:s + cfg.seq_len + 1] for s in starts])
            rows = rows.astype(np.int32)
            yield {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def make_dataset(cfg: DataConfig):
    return FileTokens(cfg) if cfg.path else SyntheticTokens(cfg)


def as_tensors(batch: dict, device) -> dict:
    """A numpy (or tensor) batch as tensors on ``device``: integer leaves
    (tokens, labels) as int64, floating leaves (the ``embeds`` /
    ``enc_embeds`` of the vlm and audio families) in their own dtype — a
    numpy bfloat16 array (``ml_dtypes``) becomes a bf16 tensor."""
    def conv(v):
        if isinstance(v, np.ndarray):
            if v.dtype.name == "bfloat16":
                return torch.from_numpy(v.astype(np.float32)).to(
                    device=device, dtype=torch.bfloat16)
            v = torch.from_numpy(np.ascontiguousarray(v))
        t = torch.as_tensor(v)
        if t.is_floating_point():
            return t.to(device=device)
        return t.to(device=device, dtype=torch.int64)

    return {k: conv(v) for k, v in batch.items()}


class Prefetcher:
    """Background-thread prefetch of ``depth`` batches onto ``device``."""

    def __init__(self, it: Iterator[dict], depth: int = 2, device="cuda"):
        from repro_torch import resolve_device
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._device = resolve_device(device)
        self._src = iter(it)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for batch in self._src:
                if self._stop.is_set():
                    return
                self._q.put(as_tensors(batch, self._device))
        finally:
            self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        self._stop.set()
