"""Open-loop serving: requests due by the wall clock at the cell's fixed
rate, whatever the engine has finished.

The arrivals begin ``warm_s`` seconds before the window, so the window
opens on a loaded engine (that pre-roll is set-up). No request is
submitted once the window has closed; the loop goes on until every
request due in the window has its first token, at most ``close_wait_s``
past the close.

- ``ttft_p95_s``: over every request due in the window, the 95th
  percentile (nearest rank) of its time from due to the tick that
  delivered its first token; a request with none by the end of the wait
  counts at that wait and as failed.
- ``itl_p95_s``: over every gap between consecutive tokens of a request
  that begins in the window (tokens that one tick delivers together are
  0 apart), the 95th percentile.
"""
from __future__ import annotations

import math
import time

from .. import serving, trace, traffic


def p95(xs) -> float:
    ys = sorted(xs)
    return ys[max(0, math.ceil(0.95 * len(ys)) - 1)]


def gaps(srv, window):
    times = [t for t, n in srv.deliveries for _ in range(n)]
    return [b - a for a, b in zip(times, times[1:])
            if window[0] <= a < window[1]]


check = serving.check


def run(ctx) -> dict:
    t = time.perf_counter()
    eng = serving.build_engine(ctx.weights, ctx.cfg, ctx.cell, ctx.device)
    eng.warmup()
    ctx.sync()
    parts = dict(ctx.parts, engine_warmup_s=time.perf_counter() - t,
                 pre_roll_s=ctx.mix["warm_s"])
    reqs = traffic.generate(ctx.mix, ctx.cell, ctx.seed, ctx.seconds,
                            ctx.conf["vocab_size"])
    start = time.perf_counter()
    window = (start + ctx.mix["warm_s"],
              start + ctx.mix["warm_s"] + ctx.seconds)
    tr = ctx.mix["trace"]
    prof = trace.Profiled(window[0] + tr["at"] * ctx.seconds,
                          tr["seconds"], ctx.trace and ctx.on_card)
    loop = serving.Loop(eng, reqs, start, window, prof, ctx.sync)
    last = window[1] + ctx.mix["close_wait_s"]

    def due_in_window(s):
        return window[0] <= s.due < window[1]

    def stop(now):
        if now < window[1]:
            return False
        return now >= last or all(
            s.first_token_at is not None
            for s in loop.served.values() if due_in_window(s))

    loop.run(stop)
    end = time.perf_counter()
    due = [s for s in loop.pending if due_in_window(s)]
    due += [s for s in loop.served.values() if due_in_window(s)]
    due += [s for s in loop.refused if due_in_window(s)]
    refused = {s.rid for s in loop.refused}
    ttft = [(s.first_token_at if s.first_token_at is not None else end)
            - s.due for s in due]
    never = [s.rid for s in due
             if s.first_token_at is None and s.rid not in refused]
    itl = [g for s in loop.served.values() for g in gaps(s, window)]
    half = window[0] + ctx.seconds / 2
    first = [x for s, x in zip(due, ttft) if s.due < half]
    second = [x for s, x in zip(due, ttft) if s.due >= half]
    queue = [t["queue"] for t in loop.ticks if window[0] <= t["t0"] < window[1]]
    del eng
    return {
        "setup_s": window[0] - ctx.t_start,
        "e2e": {"ttft_p95_s": p95(ttft), "itl_p95_s": p95(itl)},
        "attempted": len(due),
        "failed": len(never) + sum(1 for s in due if s.rid in refused),
        "never": never,
        "loop": loop,
        "records": {"ticks": loop.ticks, "trace_started": prof.started_at},
        "window": window,
        "trace": prof.trace,
        "notes": {"setup_parts_s": parts, "profiler_s": prof.timings,
                  "requests_due": len(due), "gaps": len(itl),
                  "ticks": len(loop.ticks),
                  "generator_late_max_s": loop.lateness,
                  "ttft_mean_first_half_s": sum(first) / max(1, len(first)),
                  "ttft_mean_second_half_s": sum(second) / max(1, len(second)),
                  "queue_max": max(queue, default=0),
                  "queue_last": queue[-1] if queue else 0,
                  "ttft_p50_s": sorted(ttft)[len(ttft) // 2] if ttft else 0.0},
    }
