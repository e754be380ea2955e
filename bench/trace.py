"""The traced window: ``torch.profiler`` over CPU and CUDA from the
window's start to its end, reduced to what the per-layer metrics read.

Device events are the kernels, copies and memsets the card ran; the busy
time is the length of their union inside the window, the copy time that
of the host<->device copies alone.  Each idle gap of the device is named
by what the host's main thread was doing at its middle: the innermost
traced CPU op there, or "python (no traced op)".
"""

from __future__ import annotations

import time
import warnings
from collections import Counter, defaultdict

import numpy as np
import torch

TOP = 10


class Tracer:
    """Starts and stops one profile; ``warm`` readies CUPTI in set-up so
    the start inside the window costs little."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile
        self.device = device
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._make = lambda: profile(activities=acts)
        self.prof = None
        self.t0_ns = self.t1_ns = 0

    def warm(self):
        # a second profile in one process warns that the first's events
        # are gone; the warm one keeps none on purpose
        warnings.filterwarnings("ignore", message="Profiler clears events")
        p = self._make()
        p.start()
        torch.ones(8, device=self.device).add_(1)
        _sync(self.device)
        p.stop()

    def start(self):
        self.prof = self._make()
        self.t0_ns = time.time_ns()
        self.prof.start()

    def stop(self, t1_ns: int):
        _sync(self.device)
        self.prof.stop()
        self.t1_ns = t1_ns


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _union(starts: np.ndarray, ends: np.ndarray) -> list[tuple[int, int]]:
    if starts.size == 0:
        return []
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    out = []
    cs, ce = int(s[0]), int(e[0])
    for a, b in zip(s[1:].tolist(), e[1:].tolist()):
        if a > ce:
            out.append((cs, ce))
            cs, ce = a, b
        elif b > ce:
            ce = b
    out.append((cs, ce))
    return out


def _label_gaps(gaps, cpu):
    """Name each gap (start, end) by the innermost CPU op of the main
    thread spanning its middle."""
    labels = {}
    if not cpu:
        return {g: "python (no traced op)" for g in gaps}
    tid = Counter(t for _, _, _, t in cpu).most_common(1)[0][0]
    ev = sorted(((s, -e, n) for s, e, n, t in cpu if t == tid))
    stack: list = []
    j = 0
    for g in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = (g[0] + g[1]) // 2
        while j < len(ev) and ev[j][0] <= mid:
            s, ne, n = ev[j]
            while stack and -stack[-1][1] <= s:
                stack.pop()
            stack.append(ev[j])
            j += 1
        while stack and -stack[-1][1] < mid:
            stack.pop()
        labels[g] = stack[-1][2] if stack else "python (no traced op)"
    return labels


def reduce(tracer: Tracer) -> dict:
    """busy_s, copy_s, kernels, window_s and the breakdown's lists."""
    t0, t1 = tracer.t0_ns, tracer.t1_ns
    kr = tracer.prof.profiler.kineto_results
    dev_s, dev_e, names, copies = [], [], [], []
    cpu = []
    cuda = torch.autograd.DeviceType.CUDA
    for ev in kr.events():
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if e <= t0 or s >= t1:
            continue
        s, e = max(s, t0), min(e, t1)
        if ev.device_type() == cuda:
            name = ev.name()
            dev_s.append(s)
            dev_e.append(e)
            names.append(name)
            copies.append(name.startswith("Memcpy")
                          and ("HtoD" in name or "DtoH" in name))
        else:
            cpu.append((s, e, ev.name(), ev.start_thread_id()))
    ds, de = np.asarray(dev_s, np.int64), np.asarray(dev_e, np.int64)
    cp = np.asarray(copies, bool)
    busy = _union(ds, de)
    copy = _union(ds[cp], de[cp]) if cp.any() else []
    per_op: dict = defaultdict(int)
    kernels = 0
    for n, s, e in zip(names, dev_s, dev_e):
        per_op[n[:120]] += e - s
        if not (n.startswith("Memcpy") or n.startswith("Memset")):
            kernels += 1
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    by_host: dict = defaultdict(int)
    for g, label in _label_gaps(gaps, cpu).items():
        by_host[label[:120]] += g[1] - g[0]
    top_ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:TOP]
    top_gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (t1 - t0) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "copy_s": sum(e - s for s, e in copy) / 1e9,
        "kernels": kernels,
        "device_events": len(names),
        "cpu_events": len(cpu),
        "device_ops": [[n, v / 1e9] for n, v in top_ops],
        "idle_gaps": [[n, v / 1e9] for n, v in top_gaps],
    }
