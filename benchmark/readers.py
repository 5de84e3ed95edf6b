"""What the per-layer metrics' readers (``metrics/``) share: the window's
ticks as the host clock saw them, and the traced ticks with their
device-busy time.

A metric reads ``records``: ``conf`` (the configuration file),
``counts`` (:class:`flops.Counts`, the architecture's sizes a layer),
``peak`` ((FLOP/s, bytes/s) of the card, None off it), ``ticks`` (one dict a tick: host ``t0``/``t1``, ``admits`` as
(true prompt length, bucket) in the order the prefills ran, ``contexts``
(each decoding slot's position), ``traced``, ``idx``), ``window``,
``trace_started`` (the host time the profiler started, None when
untraced) and ``trace`` (:class:`trace.Trace` of the traced part).
A metric with nothing to read returns None and is left out.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Tuple


def window_ticks(records: dict, admitting: bool) -> List[dict]:
    """The window's ticks before the profiler started (its start and its
    stop stall the host), admit ticks or the others."""
    lo, hi = records["window"]
    if records.get("trace_started") is not None:
        hi = min(hi, records["trace_started"])
    return [t for t in records["ticks"]
            if lo <= t["t0"] and t["t1"] <= hi and not t["traced"]
            and bool(t["admits"]) == admitting]


def mean_tick_ms(records: dict, admitting: bool) -> Optional[float]:
    ticks = window_ticks(records, admitting)
    if not ticks:
        return None
    return 1e3 * sum(t["t1"] - t["t0"] for t in ticks) / len(ticks)


def traced_ticks(records: dict, admitting: bool
                 ) -> Iterator[Tuple[dict, float, float]]:
    """(tick, start, end on the trace's clock) of each traced tick whose
    span lies wholly in the traced window."""
    tr = records["trace"]
    if tr is None:
        return
    lo, hi = tr.window
    for t in records["ticks"]:
        if not t["traced"] or bool(t["admits"]) != admitting:
            continue
        span = tr.spans.get(f"bench.tick#{t['idx']}")
        if span and lo <= span[0][0] and span[0][1] <= hi:
            yield t, span[0][0], span[0][1]


def traced_steps(records: dict) -> Iterator[Tuple[dict, float, float]]:
    """(step, start, end on the trace's clock) of each traced train step
    whose span lies wholly in the traced window."""
    tr = records["trace"]
    if tr is None:
        return
    lo, hi = tr.window
    for s in records["steps"]:
        span = tr.spans.get(f"bench.step#{s['idx']}") if s["traced"] else None
        if span and lo <= span[0][0] and span[0][1] <= hi:
            yield s, span[0][0], span[0][1]

