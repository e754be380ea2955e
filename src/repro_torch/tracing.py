"""Spans at the port's layer boundaries, recorded only while a
``torch.profiler`` session records on the calling thread.

    with torch.profiler.profile(activities=[...]) as prof:
        session.run()
    for s in tracing.spans():
        print(s.name, s.attrs, s.device_ns)

Off, ``span(name, **attrs)`` costs one check of the profiler's flag and
returns a shared no-op context: no profiler range, no CUDA event, no clock
reading, no record and no synchronisation.  The flag is checked at each
span's entry, so a profiler started in the middle of a run records the
spans entered after its start.  Where torch lacks the private profiler
bindings this module uses, spans are always off.

On, a span records its name, its parent (the enclosing recorded span of
the same thread), its attributes, its host interval on ``time.time_ns()``
and a pair of timing CUDA events on the current stream, which give its
device interval (on the CPU, where work is synchronous, the device
interval is the host interval).  It also opens a profiler range of its
name, so the span lies in the profiler's trace beside the ops it ran and
the kernels they launched, and names what the host was doing in the
device's idle gaps.  The range is a function-scope record, not a user
annotation: the profiler gives each user annotation a device-side copy
(``gpu_user_annotation``) that a reader of the trace would count as a
kernel and as busy time.

Recorded spans go into a ring of the last ``RING``; ``spans()`` waits for
their events and returns plain records.  Nothing is resolved while the
program runs.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

import torch

RING = 1 << 16

# private bindings of torch; a build without either records no span
_profiling = getattr(getattr(torch._C, "_autograd", None),
                     "_profiler_enabled", None)
_range = getattr(getattr(torch._C, "_profiler", None),
                 "_RecordFunctionFast", None)
if _profiling is None or _range is None:
    def _profiling() -> bool:
        return False
_now = time.time_ns
_ids = itertools.count(1)
_ring: deque = deque(maxlen=RING)
_local = threading.local()


@dataclass(frozen=True)
class Span:
    """One recorded span: host interval on the epoch clock, device
    interval's length, both in ns."""
    id: int
    parent: Optional[int]
    name: str
    attrs: dict
    start_ns: int
    end_ns: int
    device_ns: int


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def set(self, **attrs):
        pass


_OFF = _Off()


class _On:
    __slots__ = ("id", "parent", "name", "attrs", "start_ns", "end_ns",
                 "events", "device_ns", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs
        self.events = None
        self.device_ns = None

    def set(self, **attrs):
        """Attributes known only inside the span (bytes moved)."""
        self.attrs.update(attrs)

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        stack.append(self)
        self._range = _range(self.name)
        self._range.__enter__()
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.start_ns = _now()
        return self

    def __exit__(self, *exc):
        self.end_ns = _now()
        if self.events is not None:
            self.events[1].record()
        self._range.__exit__(*exc)
        _stack().pop()
        _ring.append(self)
        return False

    def resolve(self) -> Span:
        if self.device_ns is None:
            if self.events is None:
                self.device_ns = self.end_ns - self.start_ns
            else:
                self.events[1].synchronize()
                self.device_ns = round(
                    self.events[0].elapsed_time(self.events[1]) * 1e6)
                self.events = None
        return Span(self.id, self.parent, self.name, dict(self.attrs),
                    self.start_ns, self.end_ns, self.device_ns)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def span(name: str, **attrs):
    """A context manager around one call of a layer: recorded while a
    profiler records on this thread, a shared no-op otherwise.  The
    value it gives is false when off; ``set(**attrs)`` adds attributes."""
    if not _profiling():
        return _OFF
    return _On(name, attrs)


def spans(since_ns: Optional[int] = None,
          until_ns: Optional[int] = None) -> list[Span]:
    """The ring's spans whose host start lies in ``[since_ns, until_ns]``,
    in the order they were entered; waits for their device events."""
    out = [s.resolve() for s in list(_ring)
           if (since_ns is None or s.start_ns >= since_ns)
           and (until_ns is None or s.start_ns <= until_ns)]
    return sorted(out, key=lambda s: s.id)


def clear() -> None:
    """Drop every recorded span."""
    _ring.clear()
