"""Reading a ``torch.profiler`` chrome trace: the device's busy intervals,
the benchmark's own host spans (``bench.*`` annotations), and what the
host was doing while the device sat idle.

Times are seconds on the trace's clock, on which the host spans and the
device's operations are laid out together.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import tempfile
import time
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
Interval = Tuple[float, float]


def merge(intervals: List[Interval]) -> List[Interval]:
    out: List[Interval] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Trace:
    """One traced window. ``ops``: (start, end, name, args) of every device
    operation, sorted; ``spans``: name -> [(start, end)] of the bench
    annotations; ``busy``: the union of the operations' intervals."""

    def __init__(self, path: str):
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        ops, cpu = [], []
        self.spans: Dict[str, List[Interval]] = collections.defaultdict(list)
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            a = float(e["ts"]) * 1e-6
            b = a + float(e["dur"]) * 1e-6
            cat = e.get("cat", "")
            if cat in DEVICE_CATS:
                ops.append((a, b, e.get("name", ""), e.get("args", {})))
            elif cat == "user_annotation" and e["name"].startswith("bench."):
                self.spans[e["name"]].append((a, b))
            elif cat == "cpu_op":
                cpu.append((a, b, e.get("name", "")))
        ops.sort(key=lambda o: o[0])
        cpu.sort()
        self.ops = ops
        self._op_starts = [o[0] for o in ops]
        self._cpu = cpu
        self._cpu_starts = [c[0] for c in cpu]
        win = self.spans.get("bench.window")
        if not win:
            raise ValueError("the trace holds no bench.window span")
        self.window: Interval = win[0]
        lo, hi = self.window
        self.busy = [(max(a, lo), min(b, hi))
                     for a, b in merge([(o[0], o[1]) for o in ops])
                     if b > lo and a < hi]
        self._busy_starts = [a for a, _ in self.busy]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy)

    def busy_in(self, a: float, b: float) -> float:
        """Seconds of ``[a, b]`` in which some operation ran."""
        i = max(0, bisect.bisect_right(self._busy_starts, a) - 1)
        total = 0.0
        while i < len(self.busy) and self.busy[i][0] < b:
            x, y = self.busy[i]
            total += max(0.0, min(y, b) - max(x, a))
            i += 1
        return total

    def ops_in(self, a: float, b: float, needle: str) -> List[tuple]:
        """The operations whose name holds ``needle`` that start in
        ``[a, b]``, in order."""
        i = bisect.bisect_left(self._op_starts, a)
        out = []
        while i < len(self.ops) and self.ops[i][0] <= b:
            if needle in self.ops[i][2]:
                out.append(self.ops[i])
            i += 1
        return out

    def _host_at(self, t: float) -> str:
        """The innermost bench span and host operation running at ``t``."""
        span = "outside"
        best = None
        for name, ivs in self.spans.items():
            if name == "bench.window":
                continue
            for a, b in ivs:
                if a <= t <= b and (best is None or a > best):
                    best, span = a, name.split("#")[0]
        op = ""
        i = bisect.bisect_right(self._cpu_starts, t)
        for j in range(i - 1, max(-1, i - 500), -1):
            a, b, name = self._cpu[j]
            if b >= t:
                op = name
                break
        return f"{span}/{op}" if op else span

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by what the host was doing, at most ``top`` of each."""
        lo, hi = self.window
        by_op: Dict[str, float] = collections.defaultdict(float)
        for a, b, name, _ in self.ops:
            if a >= lo and b <= hi:
                by_op[name[:120]] += b - a
        gaps = []
        prev = lo
        for a, b in self.busy:
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if hi > prev:
            gaps.append((prev, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        by_host: Dict[str, float] = collections.defaultdict(float)
        for a, b in gaps[:2000]:
            by_host[self._host_at((a + b) / 2)] += b - a
        rest = sum(b - a for a, b in gaps[2000:])
        if rest:
            by_host["shorter gaps"] += rest

        def ranked(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]

        return {"device_ops": ranked(by_op), "idle_gaps": ranked(by_host)}


class Profiled:
    """A ``torch.profiler`` over a part of the window, on the card only:
    started at ``at`` seconds, stopped ``seconds`` later, its chrome trace
    written under ``TMPDIR`` and read back by :class:`Trace`."""

    def __init__(self, at: float, seconds: float, on: bool):
        self.at, self.seconds, self.until = at, seconds, None
        self.on = on
        self.prof = None
        self.done = False
        self.trace = None
        self._window = None
        self.started_at = None
        self.timings = {}
        if on:
            # the profiler's first start initialises CUPTI, seconds of host
            # time: paid here, in set-up, not inside the window
            with torch.profiler.profile(activities=self._activities()):
                torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    @staticmethod
    def _activities():
        return [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]

    def active(self) -> bool:
        return self.prof is not None

    def poll(self, now: float) -> None:
        if not self.on or self.done:
            return
        if self.prof is None and now >= self.at:
            self.prof = torch.profiler.profile(activities=self._activities())
            self.prof.start()
            self._window = torch.profiler.record_function("bench.window")
            self._window.__enter__()
            self.started_at = time.perf_counter()
            self.timings["start_s"] = self.started_at - now
            self.until = self.started_at + self.seconds
        elif self.prof is not None and now >= self.until:
            self.stop()

    def stop(self) -> None:
        if self.prof is None:
            return
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self.prof.stop()
        self.timings["stop_s"] = time.perf_counter() - t0
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench-trace-")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            self.trace = Trace(path)
        finally:
            os.remove(path)
        self.timings["read_s"] = time.perf_counter() - t0
        self.prof = None
        self.done = True

    def span(self, name: str):
        if self.prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)
