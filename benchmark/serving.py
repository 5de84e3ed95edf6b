"""The serving cells' loop around ``tpusched_torch.serve.ServeEngine``:
requests submitted when due by the wall clock, ``tick()`` called while the
engine holds work, and every token's delivery time recorded when the tick
that made it returns.

Spans (the benchmark's own, around the calls into the engine): ``submit``,
and each ``tick``, which ends in ``torch.cuda.synchronize()`` and is an
admit tick when the engine's ``prefills`` counter rose in it. In a traced
run the profiler covers a few seconds of the window, each span there also a
``bench.*`` annotation (``trace.Profiled``); the host-clock metrics leave
those ticks out.
"""
from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional

import numpy as np

from . import model


class Served:
    """What one request got: its due time, and every tick that delivered
    tokens to it, as (time, count)."""
    __slots__ = ("rid", "due", "prompt", "max_new", "deliveries", "slot",
                 "tokens", "delivered")

    def __init__(self, req: dict, t0: float):
        self.rid = req["rid"]
        self.due = t0 + req["due_s"]
        self.prompt = req["prompt"]
        self.max_new = req["max_new"]
        self.deliveries: List[tuple] = []
        self.slot = None
        self.tokens: Optional[np.ndarray] = None
        self.delivered = 0

    @property
    def first_token_at(self) -> Optional[float]:
        return self.deliveries[0][0] if self.deliveries else None


def build_engine(weights, cfg, cell: dict, device):
    from tpusched_torch.serve import ServeEngine
    eng = cell["engine"]
    return ServeEngine(weights, cfg, slots=eng["slots"],
                       max_seq=eng["max_seq"],
                       prompt_bucket=tuple(eng["prompt_buckets"]),
                       device=device)


class Loop:
    """Drives one engine through a run's requests.

    ``arrivals_at``: when the first request's due clock starts;
    ``window``: (start, end) of the measured window. No request is
    submitted once the window has closed."""

    def __init__(self, eng, requests: List[dict], arrivals_at: float,
                 window: tuple, profiled, sync):
        self.eng = eng
        self.window = window
        self.prof = profiled
        self.sync = sync
        self.pending = collections.deque(
            Served(r, arrivals_at) for r in requests)
        self.served: Dict[int, Served] = {}
        self.ticks: List[dict] = []
        self.refused: List[Served] = []
        self.lateness = 0.0

    def _submit_due(self, now: float) -> None:
        from tpusched_torch.serve import Request
        while (self.pending and self.pending[0].due <= now
               and self.pending[0].due < self.window[1]):
            s = self.pending.popleft()
            self.lateness = max(self.lateness, now - s.due)
            with self.prof.span("bench.submit"):
                try:
                    self.eng.submit(Request(rid=s.rid, prompt=s.prompt,
                                            max_new_tokens=s.max_new))
                except ValueError:
                    self.refused.append(s)
                    continue
            self.served[s.rid] = s

    def _tick(self) -> None:
        eng = self.eng
        resident = [(s, eng.req[s].rid, int(eng.pos[s]))
                    for s in range(eng.slots) if eng.req[s] is not None]
        n_done = len(eng.completions)
        prefills = eng.prefills
        idx = len(self.ticks)
        traced = self.prof.active()
        t0 = time.perf_counter()
        with self.prof.span(f"bench.tick#{idx}"):
            eng.tick()
            self.sync()
        t1 = time.perf_counter()
        with self.prof.span("bench.book"):
            was = {rid for _, rid, _ in resident}
            done = {c.rid: c for c in eng.completions[n_done:]}
            admitted = []
            for s in range(eng.slots):
                r = eng.req[s]
                if r is not None and r.rid not in was:
                    admitted.append(r.rid)
                    self.served[r.rid].slot = s
            admitted += [rid for rid in done if rid not in was
                         and rid not in admitted]
            contexts = [pos for _, _, pos in resident]
            buckets = eng.prompt_buckets
            admits = []
            for rid in admitted:
                n = len(self.served[rid].prompt)
                admits.append((n, next(b for b in buckets if b >= n)))
            for rid in list(was) + admitted:
                srv = self.served[rid]
                if rid in done:
                    srv.tokens = done[rid].tokens
                    count = len(srv.tokens)
                else:
                    count = len(eng.generated[srv.slot])
                new = count - srv.delivered
                if new:
                    srv.deliveries.append((t1, new))
                    srv.delivered = count
                if rid in admitted and count >= 2:
                    contexts.append(len(srv.prompt))
            self.ticks.append({"t0": t0, "t1": t1, "admits": admits,
                               "contexts": contexts, "traced": traced,
                               "prefills": eng.prefills - prefills,
                               "queue": len(eng.queue),
                               "idx": idx})

    def run(self, stop) -> None:
        """Submit and tick until ``stop(now)``; sleep when the engine is
        idle and the next request is not yet due."""
        while True:
            now = time.perf_counter()
            self.prof.poll(now)
            self._submit_due(now)
            if stop(now):
                break
            eng = self.eng
            if eng.queue or any(r is not None for r in eng.req):
                self._tick()
            elif self.pending and self.pending[0].due < self.window[1]:
                with self.prof.span("bench.sleep"):
                    time.sleep(max(0.0, min(self.pending[0].due - now,
                                            0.01)))
            elif now >= self.window[1]:
                break
            else:
                with self.prof.span("bench.sleep"):
                    time.sleep(min(0.01, self.window[1] - now))
        self.prof.stop()


def sample_finished(loop: Loop, n: int, seed: int) -> List[Served]:
    """``n`` finished requests drawn from the seed, the one with the most
    served tokens always among them."""
    done = sorted((s for s in loop.served.values() if s.tokens is not None),
                  key=lambda s: s.rid)
    if not done:
        return []
    longest = max(done, key=lambda s: (len(s.tokens), s.rid))
    rest = [s for s in done if s is not longest]
    from .traffic import rng
    pick = rng(seed, 5).permutation(len(rest))[:max(0, n - 1)]
    return [longest] + [rest[i] for i in sorted(pick)]


def check(out: dict, ctx, control: bool = False) -> dict:
    """The served tokens of a sample of finished requests against the
    reference: the widest or the mean logit gap (whichever the cell's
    ``limits`` name), and every finished request's length.
    Runs after the engine is freed. ``control`` (``benchmark.calibrate``;
    a benchmark run never does) also puts the fp8 reference in the
    program's place: the gaps of the tokens it ranks first, at the same
    positions, judged by the same limits (``control_correct``)."""
    from .reference import judge as ref
    loop = out["loop"]
    wrong_len = [s.rid for s in loop.served.values()
                 if s.tokens is not None and len(s.tokens) != s.max_new]
    sample = sample_finished(loop, ctx.mix["check_requests"], ctx.seed)
    items = [(s.prompt, np.asarray(s.tokens, dtype=np.int64))
             for s in sample]
    g = ref.gaps(ctx.weights, ctx.conf, items, ctx.device)
    others = {"wrong_length": len(wrong_len),
              "never_served": len(out["never"])}
    verdict = judge(g, others, ctx.cell["limits"])
    if control:
        c = ref.gaps(ctx.weights, ctx.conf, items, ctx.device,
                     control="fp8")
        as_program = judge(c, others, ctx.cell["limits"])
        verdict["stats"] = {"program": gap_stats(g),
                            "control": gap_stats(c),
                            "control_correct": as_program["correct"],
                            "control_compared": as_program["compared"]}
        if model.arch(ctx.conf).experts_per_token(ctx.conf):
            verdict["stats"]["routing"] = routing_look(ctx, items, g)
    return verdict


def routing_look(ctx, items, g) -> dict:
    """Whether an MoE cell's gaps come from routing (``benchmark.
    calibrate`` only). Over the sample's teacher-forced sequences: the
    share of (token, layer) routing decisions whose top-k set differs
    between the program's forward (``workload.forward``, dropless, in the
    served dtype; each layer's experts recorded where its router picks
    them) and the float32 reference's, the share of tokens with such a
    flip in some layer, and the reference's gaps of the served tokens
    with each layer given the program's experts (``forced``) beside its
    own (``free``, the check's gaps)."""
    import torch
    from tpusched_torch import workload
    from .reference import judge as ref
    k = model.arch(ctx.conf).experts_per_token(ctx.conf)
    original = workload._router_gates
    flips = decisions = flipped = tokens = 0
    programs = []
    for prompt, served in items:
        theirs, mine = [], {}

        def recording(x, p, cfg, theirs=theirs):
            probs, gate, idx = original(x, p, cfg)
            theirs.append(idx.clone())
            return probs, gate, idx

        def own(i, probs, mine=mine):
            mine[i] = probs.topk(k, dim=-1).indices
            return mine[i]

        seq, _ = ref._sequence(prompt, served, ctx.device)
        n = len(seq)
        # causal: tokens padded on at the end change no earlier position,
        # and keep the forward's length a multiple of the kernels' tiles
        padded = torch.cat([seq, seq.new_zeros(-n % 128)])
        workload._router_gates = recording
        try:
            with torch.no_grad():
                workload.forward(ctx.weights, padded[None], ctx.cfg,
                                 dropless=True)
        finally:
            workload._router_gates = original
        theirs[:] = [idx[:n] for idx in theirs]
        ref.gaps(ctx.weights, ctx.conf, [(prompt, served)], ctx.device,
                 routes=[own])
        differs = torch.stack([(a.sort(-1).values != mine[i].sort(-1).values)
                               .any(-1) for i, a in enumerate(theirs)])
        flips += int(differs.sum())
        decisions += differs.numel()
        flipped += int(differs.any(0).sum())
        tokens += differs.shape[1]
        programs.append(lambda i, probs, theirs=theirs: theirs[i])
    forced = ref.gaps(ctx.weights, ctx.conf, items, ctx.device,
                      routes=programs)
    return {"flip_share": flips / max(1, decisions),
            "tokens_with_a_flip": flipped / max(1, tokens),
            "free": gap_stats(g), "forced": gap_stats(forced)}


def judge(g, others: dict, limits: dict) -> dict:
    """``correct`` and the numbers compared, each beside its limit: the gap
    readings that ``limits`` name, the tokens judged, and ``others``
    (counts whose limit is 0)."""
    judged = int(g.size)
    readings = {"max_logit_gap": float(g.max()) if judged else 0.0,
                "mean_logit_gap": float(g.mean()) if judged else 0.0}
    gap_limits = {k: v for k, v in limits.items() if k in readings}
    compared = {k: {"value": readings[k], "limit": v}
                for k, v in gap_limits.items()}
    compared["tokens_judged"] = {"value": judged,
                                 "limit": limits["min_tokens_judged"]}
    compared.update({k: {"value": v, "limit": 0} for k, v in others.items()})
    correct = (bool(gap_limits)
               and all(readings[k] <= v for k, v in gap_limits.items())
               and judged >= limits["min_tokens_judged"]
               and not any(others.values()))
    return {"correct": correct, "compared": compared, "stats": {}}


def gap_stats(g) -> dict:
    """The widest, 99th-percentile and mean gap, and the share of tokens
    the reference does not rank first."""
    if not g.size:
        return {}
    return {"max": float(g.max()), "p99": float(np.quantile(g, 0.99)),
            "mean": float(g.mean()), "not_first": float((g > 0).mean()),
            "tokens": int(g.size)}
