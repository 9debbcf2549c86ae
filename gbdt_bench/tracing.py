"""Arithmetic on a ``torch.profiler`` Chrome trace: device intervals and
their union, kernels by name (K1 found by its CUDA symbol), device time
under a host range, and the device's idle gaps named by what the host was
doing.  The union-of-intervals idle share follows ``chip_smoke.py
profile_iteration`` (1 - device busy / the unprofiled iteration); the
range attribution follows ``lightgbm_tpu_torch/obs/xprof.py attribute``.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
RANGE_PREFIX = "bench/"
NAME_CHARS = 120


class Trace:
    """The events of one trace file (microseconds, as Kineto writes)."""

    def __init__(self, events: list):
        self.device = []          # (start, end, name, correlation)
        self.host = []            # (start, end, name, cat, tid)
        self.launch = {}          # correlation -> launch start on the host
        for ev in events:
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            cat = ev.get("cat", "")
            ts, dur = float(ev["ts"]), float(ev["dur"])
            args = ev.get("args") or {}
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, ev.get("name", "?"),
                                    args.get("correlation")))
            elif cat in HOST_CATS:
                self.host.append((ts, ts + dur, ev.get("name", "?"), cat,
                                  ev.get("tid")))
            elif cat == "cuda_runtime" and "correlation" in args:
                self.launch[args["correlation"]] = ts
        self.device.sort()
        self.host.sort()

    @classmethod
    def load(cls, path) -> "Trace":
        with open(path) as f:
            return cls(json.load(f).get("traceEvents", []))

    def busy_us(self) -> float:
        """Length of the union of the device's intervals."""
        total, end = 0.0, float("-inf")
        for s, e, _, _ in self.device:
            if e <= end:
                continue
            total += e - max(s, end)
            end = e
        return total

    def kernel_us(self, needle: str) -> float:
        """Device time of the operations whose name holds ``needle``."""
        return sum(e - s for s, e, n, _ in self.device if needle in n)

    def ranges(self, name: str) -> list:
        return [(s, e) for s, e, n, cat, _ in self.host
                if cat == "user_annotation" and n == name]

    def under_range_us(self, name: str) -> float:
        """Device time of the work launched inside the host range
        ``name``."""
        spans = self.ranges(name)
        if not spans:
            return 0.0
        starts = [s for s, _ in spans]
        total = 0.0
        for s, e, _, corr in self.device:
            t = self.launch.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= spans[i][1]:
                total += e - s
        return total

    def top_ops(self, k: int = 10) -> list:
        """[[name, seconds]] of the ``k`` device operations that took the
        most time."""
        by = defaultdict(float)
        for s, e, n, _ in self.device:
            by[n[:NAME_CHARS]] += e - s
        return [[n, t / 1e6] for n, t in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, window, k: int = 10) -> list:
        """[[what the host was doing, seconds]] of the device's idle time
        inside ``window`` (start, end), summed by the innermost harness
        range and host operation at each gap's middle; the ``k`` largest."""
        lo, hi = window
        merged = []
        for s, e, _, _ in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        gaps, prev = [], lo
        for s, e in merged:
            if s > prev and s > lo:
                gaps.append((max(prev, lo), min(s, hi)))
            prev = max(prev, e)
            if prev >= hi:
                break
        if prev < hi:
            gaps.append((prev, hi))
        gaps = [(a, b) for a, b in gaps if b > a]
        main = self._main_tid()
        host = [h for h in self.host if h[4] == main]
        by = defaultdict(float)
        stack, j = [], 0
        for a, b in sorted(gaps, key=lambda g: (g[0] + g[1]) / 2):
            mid = (a + b) / 2
            while j < len(host) and host[j][0] <= mid:
                while stack and stack[-1][1] <= host[j][0]:
                    stack.pop()
                stack.append(host[j])
                j += 1
            live = [h for h in stack if h[1] > mid]
            rng = next((h[2] for h in reversed(live)
                        if h[2].startswith(RANGE_PREFIX)), "outside ranges")
            op = next((h[2] for h in reversed(live)
                       if not h[2].startswith(RANGE_PREFIX)), "python")
            by[f"{rng} > {op}"[:NAME_CHARS]] += b - a
        return [[n, t / 1e6] for n, t in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def _main_tid(self):
        for _, _, n, cat, tid in self.host:
            if cat == "user_annotation" and n.startswith(RANGE_PREFIX):
                return tid
        return None
