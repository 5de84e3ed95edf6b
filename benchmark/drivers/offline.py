"""Offline generation: every request queued at the start, more than the
window can finish, so every slot stays busy.

The first ``warm_s`` seconds fill the arena and spread the slots over
their requests' lengths (set-up the traffic needs); the window then counts
``output_tokens_per_s``: every token delivered in it, by requests finished
or not, over the window's seconds.
"""
from __future__ import annotations

import time

from .. import serving, trace, traffic


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
    loop.run(lambda now: now >= window[1])
    tokens = sum(n for s in loop.served.values() for t, n in s.deliveries
                 if window[0] <= t < window[1])
    got = [s for s in loop.served.values()
           if any(window[0] <= t < window[1] for t, _ in s.deliveries)]
    del eng
    return {
        "setup_s": window[0] - ctx.t_start,
        "e2e": {"output_tokens_per_s": tokens / ctx.seconds},
        "attempted": len(got) + len(loop.refused),
        "failed": len(loop.refused),
        "never": [],
        "loop": loop,
        "records": {"ticks": loop.ticks, "trace_started": prof.started_at},
        "window": window,
        "trace": prof.trace,
        "notes": {"setup_parts_s": parts, "profiler_s": prof.timings,
                  "window_tokens": tokens, "ticks": len(loop.ticks)},
    }
