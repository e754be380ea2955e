"""Per-request token streams: the engine-to-client hand-off for online
serving.

A ``TokenStream`` is a small thread-safe pipe between the engine tick
thread (producer) and whoever is delivering tokens to a client — the SSE
writer in ``serving/server.py``, or a test iterating the stream directly.
The engine side never blocks: ``put`` appends, ``close`` marks the
terminal status; the consumer side blocks on ``get`` (with an optional
timeout, so an SSE writer can interleave keep-alive probes that detect a
dead socket even while decode is stalled).

Attach one via ``InferenceEngine.submit(..., stream=True)`` — the engine
then pushes every generated token the moment it exists (first token at
prefill, one per decode tick, speculative backends included since they
drain through the same per-tick surface) and closes the stream with the
request's terminal ``Status`` at retirement.  A cancelled request's
stream closes with ``Status.CANCELLED`` so the consumer can distinguish
"finished" from "withdrawn" without touching the request object.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

from repro_torch.serving.request import Status


class TokenStream:
    """Thread-safe single-producer token pipe with a terminal status."""

    _CLOSE = object()           # sentinel: no more tokens

    def __init__(self, request_id: str = ""):
        self.request_id = request_id
        self._q: queue.Queue = queue.Queue()
        self._status: Optional[Status] = None
        self._closed = threading.Event()

    # -- producer side (engine tick thread) ---------------------------------
    def put(self, token: int) -> None:
        self._q.put(int(token))

    def close(self, status: Status) -> None:
        """Mark the stream finished; idempotent (a double retirement must
        not enqueue a second sentinel and desync the consumer)."""
        if self._closed.is_set():
            return
        self._status = status
        self._closed.set()
        self._q.put(self._CLOSE)

    # -- consumer side ------------------------------------------------------
    @property
    def closed(self) -> bool:
        return self._closed.is_set()

    @property
    def status(self) -> Optional[Status]:
        """Terminal status, or None while the request is still live."""
        return self._status

    @property
    def cancelled(self) -> bool:
        return self._status is Status.CANCELLED

    def get(self, timeout: Optional[float] = None) -> Optional[int]:
        """Next token; None on timeout (stream still live) or raises
        ``StopIteration`` once the close sentinel is reached.  Termination
        is sticky: the sentinel is re-queued so every later ``get`` (or a
        second consumer) sees end-of-stream too, never a timeout."""
        try:
            item = self._q.get(timeout=timeout)
        except queue.Empty:
            return None
        if item is self._CLOSE:
            self._q.put(self._CLOSE)
            raise StopIteration
        return item

    def __iter__(self) -> Iterator[int]:
        while True:
            item = self._q.get()
            if item is self._CLOSE:
                self._q.put(self._CLOSE)
                return
            yield item
