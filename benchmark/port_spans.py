"""What the readers of the port's own spans share (``tpusched_torch.
tracing``, read after the run): the spans as the recorder returns them,
placed on the trace's clock through the benchmark's own spans, and the
card's idle time inside them.

The recorder keeps host times (``time.perf_counter_ns()``), the clock of
``records["ticks"]`` and ``records["steps"]``. A traced tick's
``bench.tick#i`` has its start on the trace's clock in ``Trace.spans`` and
its host start ``t0`` in ``records["ticks"]``: their difference is that
tick's offset, which every port span inside the tick takes.

A program without the recorder (no ``tpusched_torch.tracing``), or one
that recorded nothing, gives None here, and each reader then returns None.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

from benchmark import readers
from benchmark.trace import merge

NS = 1e-9


def recorded() -> Optional[List[dict]]:
    """The port's spans (host times in seconds under ``t0``/``t1``), or
    None."""
    try:
        from tpusched_torch import tracing
    except ImportError:
        return None
    spans = tracing.spans()
    if not spans:
        return None
    for s in spans:
        s["t0"], s["t1"] = s["start_ns"] * NS, s["end_ns"] * NS
    return spans


def inside(spans: List[dict], name: str, lo: float, hi: float
           ) -> List[dict]:
    """The spans ``name`` that lie wholly in ``[lo, hi]`` on the host
    clock."""
    return [s for s in spans if s["name"] == name and lo <= s["t0"]
            and s["t1"] <= hi]


def idle(tr, intervals, lo: float, hi: float) -> float:
    """Seconds of the merged ``intervals``, cut to ``[lo, hi]``, in which
    no operation ran on the card."""
    total = 0.0
    for a, b in merge(intervals):
        a, b = max(a, lo), min(b, hi)
        if b > a:
            total += (b - a) - tr.busy_in(a, b)
    return total


def traced_ticks(records: dict) -> Iterator[Tuple[dict, float, float]]:
    """Every traced tick wholly in the traced window, admitting or not, in
    order."""
    ticks = list(readers.traced_ticks(records, admitting=True))
    ticks += readers.traced_ticks(records, admitting=False)
    return iter(sorted(ticks, key=lambda x: x[1]))


def tick_idle(records: dict) -> Optional[List[Dict[str, float]]]:
    """For each traced tick that holds a ``serve.tick``, the card's idle
    seconds inside ``bench.tick#i`` (``whole``), split three ways:
    while the host is inside ``program.stage`` (``stage``), inside
    ``serve.tick`` but outside the stages (``engine``), and outside
    ``serve.tick`` (``outside``); and the tick's clock ``offset``."""
    tr = records.get("trace")
    spans = recorded() if tr is not None else None
    if spans is None:
        return None
    out = []
    for t, a, b in traced_ticks(records):
        ticks = inside(spans, "serve.tick", t["t0"], t["t1"])
        if not ticks:
            continue
        off = a - t["t0"]
        stages = inside(spans, "program.stage", t["t0"], t["t1"])
        whole = (b - a) - tr.busy_in(a, b)
        in_tick = idle(tr, [(s["t0"] + off, s["t1"] + off) for s in ticks],
                       a, b)
        stage = idle(tr, [(s["t0"] + off, s["t1"] + off) for s in stages],
                     a, b)
        out.append({"whole": whole, "stage": stage, "engine": in_tick - stage,
                    "outside": whole - in_tick, "offset": off})
    return out or None


def mean_ms(xs: List[float]) -> Optional[float]:
    return 1e3 * sum(xs) / len(xs) if xs else None


def admissions(records: dict) -> Optional[List[Tuple[dict, dict]]]:
    """(``serve.admit``, its ``serve.tick``) of every admission in the
    window's admit ticks outside the profiled part
    (``readers.window_ticks``)."""
    spans = recorded()
    if spans is None:
        return None
    out = []
    for t in readers.window_ticks(records, admitting=True):
        for tick in inside(spans, "serve.tick", t["t0"], t["t1"]):
            for adm in inside(spans, "serve.admit", tick["t0"], tick["t1"]):
                out.append((adm, tick))
    return out or None


def capture_seconds(records: dict) -> Optional[float]:
    """Host seconds of the ``program.warmup`` and ``program.capture`` spans
    that ended before the window (a process runs one cell: set-up's
    captures are all there are)."""
    spans = recorded()
    if spans is None:
        return None
    got = [s["t1"] - s["t0"] for s in spans
           if s["name"] in ("program.warmup", "program.capture")
           and s["t1"] <= records["window"][0]]
    return sum(got) if got else None


def window_steps(records: dict) -> List[dict]:
    """The window's train steps before the profiler started."""
    lo, hi = records["window"]
    if records.get("trace_started") is not None:
        hi = min(hi, records["trace_started"])
    return [s for s in records.get("steps") or ()
            if lo <= s["t0"] and s["t1"] <= hi and not s["traced"]]


def phase_ms(records: dict, phase: str) -> Optional[float]:
    """Mean device milliseconds a step of ``phase`` (``train.forward``,
    ``train.backward``, ``train.optimizer``; summed within a step) over
    the window's steps whose every reading of it arrived, timed by the
    port's device events (``device_ns``). A step with a reading the port
    counted unread (``unread`` 1: a program launched again before its
    last replay had run) is left out."""
    spans = recorded()
    if spans is None:
        return None
    parent = {s["id"]: s for s in spans}
    per_step: Dict[int, float] = {}
    unread = set()
    for s in spans:
        if s["name"] != phase:
            continue
        up = parent.get(s["parent"])
        while up is not None and up["name"] != "train.step":
            up = parent.get(up["parent"])
        if up is None:
            continue
        if s["attrs"].get("unread"):
            unread.add(up["id"])
        elif s["device_ns"] is not None:
            per_step[up["id"]] = per_step.get(up["id"], 0.0) + s["device_ns"]
    got = []
    for st in window_steps(records):
        for s in inside(spans, "train.step", st["t0"], st["t1"]):
            if s["id"] in per_step and s["id"] not in unread:
                got.append(per_step[s["id"]] * 1e-6)
    return sum(got) / len(got) if got else None
