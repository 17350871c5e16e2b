"""What a ``torch.profiler`` stretch says: device activity (kernels, copies,
sets) and the host's runtime calls and operators, read from the Chrome trace
the profiler exports.

``busy_s`` is the union of the device's activity intervals, so overlapping
streams count once; the stretch's length is the host clock's between two
device synchronisations (``Stretch.window_s``), so the device ran nothing
outside it. A kernel group's time is the summed time of the kernels whose
names match its pattern file (``bench_port/kernels/<group>.txt``: one
regular expression a line, ``!`` before a pattern that excludes).
"""
from __future__ import annotations

import bisect
import json
import os
import re
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
KERNEL_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "kernels")
GAP_MIN_US = 2.0       # shorter idle gaps are launch jitter, not attributed
NEAR_CALLS = 400       # host calls searched back from a gap before the long ones
LONG_CALL_US = 1000.0


class Stretch:
    """One profiled stretch: ``steps`` training steps in ``window_s`` seconds."""

    def __init__(self, events: List[dict], window_s: float, steps: int):
        self.window_s = window_s
        self.steps = steps
        self.device = sorted(((e["name"], float(e["ts"]), float(e.get("dur", 0.0)), e["cat"])
                              for e in events if e.get("cat") in DEVICE_CATS),
                             key=lambda x: x[1])
        self.host = sorted(((e["name"], float(e["ts"]), float(e.get("dur", 0.0)), e["cat"])
                            for e in events if e.get("cat") in HOST_CATS and e.get("ph") == "X"),
                           key=lambda x: x[1])
        self.busy = _union([(ts, ts + dur) for _, ts, dur, _ in self.device])

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) * 1e-6

    def kernel_s(self, group: str) -> Optional[float]:
        """Summed seconds of the kernels of ``group``; None when none ran."""
        include, exclude = patterns(group)
        total, hit = 0.0, False
        for name, _, dur, cat in self.device:
            if cat == "kernel" and any(p.search(name) for p in include) \
                    and not any(p.search(name) for p in exclude):
                total += dur
                hit = True
        return total * 1e-6 if hit else None

    def runtime_calls(self, pattern: str) -> int:
        rx = re.compile(pattern)
        return sum(1 for name, _, _, cat in self.host
                   if cat in ("cuda_runtime", "cuda_driver") and rx.search(name))

    def device_ops(self, top: int = 10) -> List[list]:
        by_name: Dict[str, float] = {}
        for name, _, dur, _ in self.device:
            by_name[name] = by_name.get(name, 0.0) + dur * 1e-6
        return [[n, s] for n, s in sorted(by_name.items(), key=lambda x: -x[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        """The device's idle time between its busy intervals, summed by what
        the host was doing when each gap began: the innermost traced host
        call or operator around that moment."""
        if not self.busy:
            return []
        starts = [h[1] for h in self.host]
        long_calls = [h for h in self.host if h[2] > LONG_CALL_US]
        by_name: Dict[str, float] = {}
        for (_, a1), (b0, _) in zip(self.busy, self.busy[1:]):
            gap = b0 - a1
            if gap < GAP_MIN_US:
                continue
            i = bisect.bisect_right(starts, a1) - 1
            near = self.host[max(0, i - NEAR_CALLS):i + 1][::-1]
            around = [h for h in near if h[1] + h[2] >= a1]
            if not around:
                around = sorted((h for h in long_calls if h[1] <= a1 <= h[1] + h[2]),
                                key=lambda h: -h[1])
            name = around[0][0] if around else "host: no traced call"
            by_name[name] = by_name.get(name, 0.0) + gap * 1e-6
        return [[n, s] for n, s in sorted(by_name.items(), key=lambda x: -x[1])[:top]]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


_PATTERNS: Dict[str, tuple] = {}


def patterns(group: str):
    """(include, exclude) regular expressions of a kernel group's file."""
    if group not in _PATTERNS:
        include, exclude = [], []
        with open(os.path.join(KERNEL_DIR, f"{group}.txt")) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                if line.startswith("!"):
                    exclude.append(re.compile(line[1:]))
                else:
                    include.append(re.compile(line))
        _PATTERNS[group] = (include, exclude)
    return _PATTERNS[group]


def load(profiler, path: str, window_s: float, steps: int) -> Stretch:
    """The stretch ``profiler`` (stopped) recorded; its Chrome trace is
    written to ``path`` and removed once read."""
    profiler.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return Stretch(events, window_s, steps)
