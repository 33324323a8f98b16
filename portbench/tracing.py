"""The traced stretch of a ``--trace 1`` run, reduced to what the
per-layer metrics read.

A ``torch.profiler`` session records the host's torch ops and, on the
card, every kernel, copy and set; each traced request sits inside a
``portbench.request`` annotation, and the stretch runs from the first
annotation's start to the last one's end.  The reduction keeps:

* device intervals (kernels, copies, sets) clipped to the stretch, and
  their union, the device's busy time;
* the host's top-level torch ops (an op inside another op of the same
  thread is that op's work, not another op);
* the gaps between device intervals, each labelled by the host op in
  flight at its middle.
"""

from __future__ import annotations

import bisect
import collections
from dataclasses import dataclass, field

REQUEST = "portbench.request"


def session(device_type: str):
    """A profiler over the host, and the card when ``device_type`` is cuda."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _kind(ev) -> str:
    """"device" (a kernel, copy or set on the card), "op" (a torch op on
    the host: a namespaced name such as ``aten::add``) or "other" (the
    annotations, the CUDA runtime's calls)."""
    name = ev.name()
    if name == REQUEST:
        return "other"
    if "CUDA" in str(ev.device_type()):
        return "device"
    return "op" if "::" in name else "other"


@dataclass
class Trace:
    """The reduced stretch (times in ns on the profiler's clock)."""

    t0: int
    t1: int
    device: list = field(default_factory=list)  # (start, end, name)
    host_ops: list = field(default_factory=list)  # (start, end, name), top level

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def busy_intervals(self):
        """The union of the device intervals, merged and sorted."""
        out = []
        for s, e, _ in sorted(self.device):
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-9

    def kernel_time(self, names) -> tuple:
        """(calls, seconds) of the device intervals whose name contains one
        of ``names``."""
        hits = [e - s for s, e, n in self.device if any(k in n for k in names)]
        return len(hits), sum(hits) * 1e-9

    def device_ops(self, top: int = 10):
        """[[name, seconds]] of the device operations that took most time."""
        acc = collections.Counter()
        for s, e, n in self.device:
            acc[n[:160]] += (e - s) * 1e-9
        return [[n, v] for n, v in acc.most_common(top)]

    def idle_gaps(self, top: int = 10):
        """[[host op, seconds]]: the device's idle time in the stretch,
        summed by the top-level host op in flight at each gap's middle."""
        busy = self.busy_intervals()
        gaps, cur = [], self.t0
        for s, e in busy:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if self.t1 > cur:
            gaps.append((cur, self.t1))
        ops = sorted(self.host_ops)
        starts = [o[0] for o in ops]
        acc = collections.Counter()
        for s, e in gaps:
            mid = (s + e) // 2
            i = bisect.bisect_right(starts, mid) - 1
            label = ops[i][2] if i >= 0 and ops[i][1] >= mid else "host (between torch ops)"
            acc[label] += (e - s) * 1e-9
        return [[n, v] for n, v in acc.most_common(top)]


def reduce(prof) -> "Trace | None":
    """The stretch of a finished session, or None when it holds no request."""
    events = prof.profiler.kineto_results.events()
    marks = [(ev.start_ns(), ev.start_ns() + ev.duration_ns()) for ev in events if ev.name() == REQUEST]
    if not marks:
        return None
    t0, t1 = min(m[0] for m in marks), max(m[1] for m in marks)
    tr = Trace(t0=t0, t1=t1)
    by_thread = collections.defaultdict(list)
    for ev in events:
        s = ev.start_ns()
        e = s + ev.duration_ns()
        kind = _kind(ev)
        if kind == "device":
            s, e = max(s, t0), min(e, t1)
            if e > s:
                tr.device.append((s, e, ev.name()))
        elif kind == "op" and t0 <= s < t1:
            by_thread[ev.start_thread_id()].append((s, e, ev.name()))
    for ops in by_thread.values():
        ops.sort(key=lambda o: (o[0], -o[1]))
        end = -1
        for s, e, n in ops:
            if s >= end:  # not inside the previous top-level op
                tr.host_ops.append((s, e, n))
                end = e
    return tr
