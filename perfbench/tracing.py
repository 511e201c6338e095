"""Reading a torch.profiler trace of the measured window.

The window runs inside `torch.profiler.profile` (host and device
activity); the harness marks the window and each request with
`record_function` spans of its own (WINDOW, REQUEST). After the window
the trace is exported in Chrome's format and read here:

- device intervals: every kernel, copy and memset the card ran;
- busy time: the union of the device intervals, inside the window, in
  each request's span, and of the kernels alone in each request's span;
- the device operations that took most time, by name;
- the idle gaps of the device inside the window, each labelled with the
  innermost host span that was open at its middle on the harness's
  thread (a torch operation, or a harness span where the host ran
  Python or numpy outside any torch operation).

None of it reads a kernel's name to decide what is work: a later system
that renames, splits or merges its kernels is measured the same way.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
from collections import defaultdict

WINDOW = "perfbench.window"
REQUEST = "perfbench.request"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")


def merge(intervals) -> list:
    """Sorted, disjoint union of (start, end) intervals."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1][1] = b
        else:
            out.append([a, b])
    return out


class Union:
    """A union of intervals, with the length of its overlap with any
    interval in O(log n) after the first."""

    def __init__(self, intervals):
        self.iv = merge(intervals)
        self.starts = [a for a, _ in self.iv]
        self.cum = [0.0]
        for a, b in self.iv:
            self.cum.append(self.cum[-1] + (b - a))

    def covered(self, a: float, b: float) -> float:
        """Length of the union inside [a, b]."""
        if b <= a or not self.iv:
            return 0.0
        i = max(0, bisect.bisect_right(self.starts, a) - 1)
        j = bisect.bisect_left(self.starts, b)
        if i >= j:
            return 0.0
        total = self.cum[j] - self.cum[i]
        s0, e0 = self.iv[i]
        total -= max(0.0, min(e0, a) - s0)       # the part before a
        s1, e1 = self.iv[j - 1]
        total -= max(0.0, e1 - max(s1, b))       # the part after b
        return max(0.0, total)

    def gaps(self, a: float, b: float) -> list:
        """The intervals of [a, b] outside the union."""
        out, t = [], a
        for s, e in self.iv:
            if e <= a:
                continue
            if s >= b:
                break
            if s > t:
                out.append((t, min(s, b)))
            t = max(t, e)
        if t < b:
            out.append((t, b))
        return out


@dataclasses.dataclass
class Analysis:
    """What the per-layer readers read (times in seconds)."""

    window_s: float
    busy_s: float
    requests: list          # (wall, device busy, kernels) per request
    device_ops: list        # [name, seconds], most time first
    idle_gaps: list         # [label, seconds], most time first

    def mean(self, i: int) -> float | None:
        if not self.requests:
            return None
        return sum(r[i] for r in self.requests) / len(self.requests)


def _label_gaps(gaps, host) -> dict:
    """Idle seconds by the innermost host span open at each gap's
    middle. `host` is [(start, end, name)] of one thread, properly
    nested."""
    ev = sorted(host, key=lambda e: (e[0], -e[1]))
    out: dict = defaultdict(float)
    stack: list = []
    k = 0
    for a, b in gaps:
        m = 0.5 * (a + b)
        while k < len(ev) and ev[k][0] <= m:
            while stack and stack[-1][1] <= ev[k][0]:
                stack.pop()
            stack.append(ev[k])
            k += 1
        while stack and stack[-1][1] <= m:
            stack.pop()
        out[stack[-1][2] if stack else "no host span"] += (b - a)
    return out


def analyze(trace_path: str, top: int = 10) -> Analysis:
    """Reads a Chrome trace written by torch.profiler."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    dev, kern, host_by_tid = [], [], defaultdict(list)
    by_name: dict = defaultdict(float)
    window = None
    requests = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        a = float(e["ts"]) * 1e-6
        b = a + float(e.get("dur", 0.0)) * 1e-6
        if cat in DEVICE_CATS:
            dev.append((a, b))
            by_name[e.get("name", "?")] += b - a
            if cat == "kernel":
                kern.append((a, b))
        elif cat in HOST_CATS:
            name = e.get("name", "?")
            if name == WINDOW:
                window = (a, b, e.get("tid"))
            elif name == REQUEST:
                requests.append((a, b))
            host_by_tid[e.get("tid")].append((a, b, name))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW} span")
    w0, w1, tid = window
    busy = Union(dev)
    kernels = Union(kern)
    per_req = [(b - a, busy.covered(a, b), kernels.covered(a, b))
               for a, b in sorted(requests)]
    gaps = busy.gaps(w0, w1)
    host = [h for h in host_by_tid.get(tid, []) if h[2] != WINDOW]
    labelled = _label_gaps(gaps, host)
    return Analysis(
        window_s=w1 - w0, busy_s=busy.covered(w0, w1), requests=per_req,
        device_ops=[[n, s] for n, s in sorted(by_name.items(),
                                               key=lambda x: -x[1])[:top]],
        idle_gaps=[[n, s] for n, s in sorted(labelled.items(),
                                              key=lambda x: -x[1])[:top]])
