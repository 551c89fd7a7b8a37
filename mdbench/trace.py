"""Reading a `torch.profiler` window: device busy time as the union of the
device's kernel and memset intervals (the arithmetic of
tools/profile_torch_md.py, with overlapping intervals counted once), the
idle share, launches, device time by kernel name, and what the host was
doing in the longest idle gaps.  The modes record the device's activity and
the CUDA runtime's calls alone, not every host operator, which would slow
the host's enqueue and so stretch the window; a gap is named by the
runtime call the host was in.  The per-layer metrics' readers
(`metrics/*.py`) read a `Traced`."""

from __future__ import annotations

import bisect
from collections import defaultdict

TOP = 10
HOST_SCAN = 2000


def _merge(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(host, starts, t):
    """Name of the latest-starting host event that covers time t."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - HOST_SCAN), -1):
        if host[j][2] >= t:
            return host[j][0]
    # the host ran the program's Python and operators between CUDA calls
    return "(host, outside CUDA calls)"


class Traced:
    """One traced window.  `evals` force evaluations (or optimiser steps)
    ran in it; `counters` are the program's counters over the run; `extra`
    anything the mode hands its metrics (such as the live-pair counts)."""

    def __init__(self, prof, evals, counters=None, extra=None):
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        device, host = [], []
        for e in prof.events():
            tr = e.time_range
            (device if e.device_type == cuda else host).append(
                (e.name, tr.start, tr.end))
        if not device:
            raise RuntimeError("the profiler recorded no device activity")
        self.device = device                      # (name, start us, end us)
        ops = [(s, e) for n, s, e in device if not n.startswith("Memcpy")]
        self.launches = len(ops)
        busy = _merge(ops)
        times = [s for _, s, _ in device + host] + \
            [e for _, _, e in device + host]
        w0, w1 = min(times), max(times)
        self.window_s = (w1 - w0) * 1e-6
        self.busy_s = sum(e - s for s, e in busy) * 1e-6
        self.evals = evals
        self.counters = counters or {}
        self.extra = extra or {}
        host.sort(key=lambda h: h[1])
        starts = [h[1] for h in host]
        gaps = [(b[0] - a[1], a[1], b[0]) for a, b in zip(
            [[w0, w0]] + busy, busy + [[w1, w1]]) if b[0] > a[1]]
        idle = defaultdict(float)
        for length, s, e in gaps:
            idle[_innermost(host, starts, 0.5 * (s + e))] += length * 1e-6
        by_name = defaultdict(float)
        for n, s, e in device:
            by_name[n] += (e - s) * 1e-6
        self.by_name = dict(by_name)
        self.breakdown = {
            "device_ops": [[n[:160], t] for n, t in sorted(
                by_name.items(), key=lambda kv: -kv[1])[:TOP]],
            "idle_gaps": [[n[:160], t] for n, t in sorted(
                idle.items(), key=lambda kv: -kv[1])[:TOP]]}

    @property
    def idle_share(self):
        return 1.0 - self.busy_s / self.window_s

    def kernel_seconds(self, names):
        """Summed device time of the launches whose name holds one of
        `names` (a template's demangled name carries its arguments)."""
        return sum(t for n, t in self.by_name.items()
                   if any(k in n for k in names))
