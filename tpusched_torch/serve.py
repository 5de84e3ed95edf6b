"""Continuous-batching serving engine over the KV-cache decode path.

Counterpart of ``tpusched/jaxbridge/serve.py`` (its single-card,
non-speculative path). A fixed arena of ``slots`` sequences, (slots,
max_seq) rows per layer, exact or int8, decodes in lock-step; requests join
and leave slots mid-flight. A joining request's prompt is padded to the
smallest prompt bucket that fits and prefilled alone through the configured
attention (the flash kernel for ``attn="flash"``); its K/V rows are written
into its slot in place, so resident slots are untouched and continuous
batching gives each request exactly the tokens it would get alone. With
``chunk_prefill=C`` the prompt instead streams in C rows per tick through
the decode step's cached attention, so a long prompt stalls resident slots
for one chunk a tick rather than a whole prefill; a chunked engine also
serves registered shared prefixes (``register_prefix``), whose K/V are
computed once and copied into each tenant's leading rows.

Pad keys land at positions >= the prompt's true length, which the causal
cursor masks until the decode step overwrites them. Idle slots decode
garbage at their stale cursor; the host discards it.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .decode import (KVCache, cache_update, decode_step, init_kv_cache,
                     prefill, sample_token, score_span)
from .workload import ModelConfig, Params, resolve_device


@dataclasses.dataclass
class Request:
    """One generation request: at most ``max_new_tokens`` tokens, ended
    early by ``eos_token`` when set. With ``prefix_id`` (chunked engines
    only) ``prompt`` is the suffix after a prefix registered through
    ``ServeEngine.register_prefix``."""
    rid: int
    prompt: np.ndarray                  # (true_len,) int32
    max_new_tokens: int
    eos_token: Optional[int] = None
    prefix_id: Optional[str] = None


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: np.ndarray                  # generated tokens (<= max_new_tokens)
    prompt_len: int
    admitted_tick: int
    finished_tick: int


def _slot_view(cache: KVCache, slot: int) -> KVCache:
    """One slot's rows of the arena as a batch-1 cache of views: the decode
    path's in-place writes through it (``cache_update``, quantizing into an
    int8 arena, scale planes included) land in the arena."""
    return [{n: t[slot:slot + 1] for n, t in c.items()} for c in cache]


def _prefill_slot(params: Params, cache: KVCache, prompt: torch.Tensor,
                  slot: int, true_len: int,
                  cfg: ModelConfig) -> torch.Tensor:
    """Prefill one padded prompt (bucket,) into ``slot``'s rows with the
    configured attention; returns the next-token logits (vocab,) of the
    last real prompt position."""
    logits, _ = prefill(params, _slot_view(cache, slot), prompt[None], cfg)
    return logits[0, true_len - 1]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP '{item}'")


class ServeEngine:
    """Continuous-batching engine: submit() requests, tick() until done.

    Greedy by default (temperature 0); temperature/top_k/top_p sample from
    one generator shared by the engine, seeded with ``seed``. Runs on the
    CUDA card unless ``device="cpu"``; ``params`` must already be there."""

    def __init__(self, params: Params, cfg: ModelConfig, *,
                 slots: int = 8, max_seq: int = 1024,
                 prompt_bucket: "int | Tuple[int, ...]" = 128,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int = 0,
                 request_keyed: bool = False, mesh=None,
                 chunk_prefill: Optional[int] = None,
                 draft_params: Optional[Params] = None,
                 draft_cfg: Optional[ModelConfig] = None, device=None):
        if mesh is not None:
            raise _not_ported("tensor-parallel serving (mesh)",
                              "tp serving, then dp/fsdp/tp")
        if draft_params is not None or draft_cfg is not None:
            raise _not_ported("speculative serving (draft_params/draft_cfg)",
                              "speculative decoding and request-keyed "
                              "sampling")
        if request_keyed:
            raise _not_ported("request_keyed sampling", "speculative "
                              "decoding and request-keyed sampling")
        self.device = resolve_device(device)
        if params["embed"].device != self.device:
            raise ValueError(f"params are on {params['embed'].device}, the "
                             f"engine runs on {self.device}")
        buckets = ((prompt_bucket,) if isinstance(prompt_bucket, int)
                   else tuple(sorted(set(prompt_bucket))))
        if not buckets or buckets[-1] >= max_seq:
            raise ValueError("prompt buckets must be non-empty and leave "
                             "generation room under max_seq")
        if cfg.kv_cache_dtype is not None and chunk_prefill is not None:
            # a chunk's queries would attend earlier chunks through the
            # dequantized cache where monolithic prefill and solo generate
            # attend fresh values: the tokens could differ
            raise ValueError(
                "int8 KV arena composes with monolithic admission only: "
                "chunked prefill would attend dequantized history where "
                "monolithic attends fresh values, breaking result parity "
                "(kv_cache_dtype=None for chunk_prefill/prefix caching)")
        if chunk_prefill is not None:
            if chunk_prefill < 1:
                raise ValueError("chunk_prefill must be >= 1")
            # every chunk writes a full chunk_prefill-row extent; the
            # longest prompt's last chunk must still fit the arena
            worst = -(-buckets[-1] // chunk_prefill) * chunk_prefill
            if worst > max_seq:
                raise ValueError(
                    f"chunk_prefill={chunk_prefill}: a {buckets[-1]}-token "
                    f"prompt's chunk-aligned writes span {worst} rows > "
                    f"max_seq {max_seq}")
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.max_seq = max_seq
        self.prompt_buckets = buckets
        self.prompt_bucket = buckets[-1]   # largest (admission bound)
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.chunk_prefill = chunk_prefill
        # registered shared prefixes: id -> {"len", "kv"}
        self._prefixes: Dict[str, dict] = {}
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.cache = init_kv_cache(cfg, slots, max_seq, device=self.device)
        # host-side slot state
        self.pos = np.zeros(slots, dtype=np.int64)       # next write position
        self.next_tok = np.zeros(slots, dtype=np.int64)  # last sampled token
        self.req: List[Optional[Request]] = [None] * slots
        # the prompt row a chunk-prefilling slot streams in next; None once
        # its prompt is resident (always None under monolithic admission)
        self.prefill_off: List[Optional[int]] = [None] * slots
        self.slot_prefix = np.zeros(slots, dtype=np.int64)  # tenant prefix len
        self.generated: List[List[int]] = [[] for _ in range(slots)]
        self.admitted_at = np.zeros(slots, dtype=np.int64)
        self.queue: List[Tuple[Request, Optional[dict]]] = []
        self.completions: List[Completion] = []
        self.tick_count = 0
        self.decode_tokens = 0          # real (non-idle) tokens decoded
        # monolithic slot prefills run (each through the configured
        # attention), warmup included; chunked admission runs none
        self.prefills = 0

    # -- submission -----------------------------------------------------------

    @torch.no_grad()
    def register_prefix(self, prefix_id: str, tokens: np.ndarray) -> None:
        """Compute a shared prefix's K/V once (a system prompt): requests
        submitted with this ``prefix_id`` get the rows copied into their
        slot and prefill only their suffix. Chunked engines only: the
        suffix streams in from the prefix boundary."""
        if self.chunk_prefill is None:
            raise ValueError("prefix caching requires chunk_prefill")
        p = int(len(tokens))
        # the least admissible request is a 1-token suffix (one chunk extent
        # past the prefix) that generates 1 token
        if p < 1 or p + max(self.chunk_prefill, 2) > self.max_seq:
            raise ValueError("prefix must leave room for a chunk-aligned "
                             "suffix and generation under max_seq")
        tokens = torch.as_tensor(np.asarray(tokens, dtype=np.int64),
                                 device=self.device)
        # the K/V through the configured attention (the flash kernel for
        # attn="flash") at rotary positions 0..p-1: a prefix always takes a
        # slot's leading rows. Exact: the engine refuses int8 with chunking
        kv = prefill(self.params, init_kv_cache(self.cfg, 1, p, self.device),
                     tokens[None], self.cfg)[1]
        self._prefixes[prefix_id] = {"len": p, "kv": kv}

    def submit(self, req: Request) -> None:
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (prefill always "
                             "samples the first token)")
        prefix_len, entry = 0, None
        if req.prefix_id is not None:
            if self.chunk_prefill is None:
                raise ValueError("prefix_id requires a chunked engine")
            entry = self._prefixes.get(req.prefix_id)
            if entry is None:
                raise ValueError(f"unknown prefix_id {req.prefix_id!r}")
            if len(req.prompt) < 1:
                raise ValueError("prefix requests need a non-empty suffix "
                                 "(first-token logits come from its last "
                                 "real row)")
            prefix_len = entry["len"]
        if len(req.prompt) < 1:
            raise ValueError("prompt must hold at least one token")
        if len(req.prompt) > self.prompt_bucket:
            raise ValueError(
                f"prompt len {len(req.prompt)} > bucket {self.prompt_bucket}")
        if prefix_len + len(req.prompt) + req.max_new_tokens > self.max_seq:
            # keeps every in-place cache write inside the arena
            raise ValueError("prompt + max_new_tokens exceeds max_seq")
        if self.chunk_prefill is not None:
            # the suffix's last chunk writes a full chunk extent
            C = self.chunk_prefill
            span = prefix_len + -(-len(req.prompt) // C) * C
            if span > self.max_seq:
                raise ValueError(
                    f"chunk-aligned prompt span {span} exceeds max_seq "
                    f"{self.max_seq}")
        # the resolved prefix entry rides with the request: registering the
        # id again later leaves a queued request as it was validated
        self.queue.append((req, entry))

    def warmup(self) -> None:
        """Requests through the real path, then reset the metric counters:
        monolithic, one full-length request per bucket (the first generates
        2 tokens so the decode tick runs too); chunked, one full-bucket
        request that generates 2. ``prefills`` is not reset: it counts every
        prefill the engine ran."""
        if self.chunk_prefill is not None:
            # one chunk program serves every bucket and chunk offset
            warm = [(self.prompt_bucket, 2)]
        else:
            warm = [(bucket, 2 if i == 0 else 1)
                    for i, bucket in enumerate(self.prompt_buckets)]
        for bucket, new_tokens in warm:
            self.submit(Request(rid=-1,
                                prompt=np.zeros(bucket, dtype=np.int32),
                                max_new_tokens=min(new_tokens,
                                                   self.max_seq - bucket)))
            self.run_until_drained()
        self.completions.clear()
        self.tick_count = 0
        self.decode_tokens = 0

    # -- engine loop ----------------------------------------------------------

    def _admit(self) -> None:
        for slot in range(self.slots):
            if self.req[slot] is not None or not self.queue:
                continue
            req, prefix = self.queue.pop(0)
            self.req[slot] = req
            self.admitted_at[slot] = self.tick_count
            if self.chunk_prefill is not None:
                # claim the slot; tick() streams the prompt in. The decode
                # step still runs this slot meanwhile: its cursor is parked
                # at the prompt's end, the one row every chunk's mask hides
                # and the first real decode step overwrites
                p = 0
                if prefix is not None:
                    p = prefix["len"]
                    for c, kv in zip(_slot_view(self.cache, slot),
                                     prefix["kv"]):
                        cache_update(c, kv["k"], kv["v"], 0)
                self.slot_prefix[slot] = p
                self.prefill_off[slot] = p
                self.pos[slot] = p + len(req.prompt)
                continue
            true_len = len(req.prompt)
            bucket = next(b for b in self.prompt_buckets if b >= true_len)
            padded = np.zeros(bucket, dtype=np.int64)
            padded[:true_len] = req.prompt
            first_logits = _prefill_slot(
                self.params, self.cache,
                torch.from_numpy(padded).to(self.device), slot, true_len,
                self.cfg)
            self.prefills += 1
            tok = int(self._sample(first_logits[None, :])[0])
            self.slot_prefix[slot] = 0
            self.pos[slot] = true_len
            self.next_tok[slot] = tok
            self.generated[slot] = [tok]
            self._maybe_finish(slot)

    def _advance_prefills(self) -> None:
        """One chunk per prefilling slot. The final chunk's last real row
        gives the first sampled token and turns the slot to decoding."""
        C = self.chunk_prefill
        for slot in range(self.slots):
            off = self.prefill_off[slot]
            if off is None:
                continue
            req = self.req[slot]
            p = int(self.slot_prefix[slot])        # the suffix starts at row p
            true_len = p + len(req.prompt)
            n = min(C, true_len - off)
            chunk = np.zeros(C, dtype=np.int64)
            chunk[:n] = req.prompt[off - p:off - p + n]
            # the chunk's K/V go into rows [off, off+C) and its queries
            # attend the slot's whole row space through the decode path's
            # position mask (earlier chunks live, later rows hidden); no
            # kernel runs, as no Pallas call runs in the reference's chunk
            # program
            logits, _ = score_span(
                self.params, _slot_view(self.cache, slot),
                torch.from_numpy(chunk).to(self.device)[None], off, self.cfg)
            next_logits = logits[0, n - 1]     # the last real row
            off += n
            if off < true_len:
                self.prefill_off[slot] = off
                continue
            self.prefill_off[slot] = None          # the prompt is resident
            tok = int(self._sample(next_logits[None, :])[0])
            self.next_tok[slot] = tok
            self.generated[slot] = [tok]
            self._maybe_finish(slot)

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        return sample_token(logits, self.generator, self.temperature,
                            self.top_k, self.top_p).cpu().numpy()

    def _maybe_finish(self, slot: int) -> None:
        req = self.req[slot]
        gen = self.generated[slot]
        done = len(gen) >= req.max_new_tokens or (
            req.eos_token is not None and gen and gen[-1] == req.eos_token)
        if not done:
            return
        self.completions.append(Completion(
            rid=req.rid, tokens=np.asarray(gen, dtype=np.int32),
            prompt_len=int(self.slot_prefix[slot]) + len(req.prompt),
            admitted_tick=int(self.admitted_at[slot]),
            finished_tick=self.tick_count))
        self.req[slot] = None
        self.generated[slot] = []

    @torch.no_grad()
    def tick(self) -> int:
        """Admit waiting requests into free slots, advance each chunked
        prefill by one chunk, then one decode step over the arena. Returns
        the number of active (decoding) slots, 0 for an idle tick."""
        self._admit()
        if self.chunk_prefill is not None:
            self._advance_prefills()
        active = [s for s in range(self.slots)
                  if self.req[s] is not None and self.prefill_off[s] is None]
        if not active:
            self.tick_count += 1
            return 0
        # one lock-step decode over the whole arena, idle slots included
        logits, _ = decode_step(
            self.params, self.cache,
            torch.from_numpy(self.next_tok).to(self.device),
            torch.from_numpy(self.pos).to(self.device), self.cfg)
        toks = self._sample(logits)
        self.tick_count += 1
        for s in active:
            self.pos[s] += 1
            self.next_tok[s] = toks[s]
            self.generated[s].append(int(toks[s]))
            self.decode_tokens += 1
            self._maybe_finish(s)
        return len(active)

    def run_until_drained(self, max_ticks: int = 100_000,
                          on_tick: Optional[Callable[[], None]] = None
                          ) -> List[Completion]:
        """Tick until every submitted request completed. Returns completions
        in finish order; ``on_tick`` runs after every tick."""
        while self.queue or any(r is not None for r in self.req):
            self.tick()
            if on_tick is not None:
                on_tick()
            if self.tick_count >= max_ticks:
                raise RuntimeError("serve engine did not drain (cap hit)")
        return self.completions


def _reporter_not_ported(reporter) -> None:
    if reporter is not None:
        raise _not_ported("reporter (GoodputReporter)", "checkpoint, data, "
                          "the rest of measure, and budget")


def _tick_sync(eng: ServeEngine) -> Callable[[], None]:
    """What ends a measured tick: ``torch.cuda.synchronize()`` on the card,
    so each tick pays for its own work (a tick in which every slot is
    chunk-prefilling samples nothing and would not wait otherwise)."""
    return (torch.cuda.synchronize if eng.device.type == "cuda"
            else (lambda: None))


def measure_serving(cfg: ModelConfig, params: Params, requests: List[Request],
                    *, slots: int = 8, max_seq: int = 1024,
                    prompt_bucket: "int | Tuple[int, ...]" = 128,
                    chunk_prefill: Optional[int] = None, reporter=None,
                    device=None) -> Dict[str, float]:
    """Serve ``requests`` on a warmed engine: tokens/s, occupancy (real
    tokens per slot-tick), ticks, the largest gap between ticks (the
    head-of-line stall an admission inflicts on residents: a whole prompt's
    prefill under monolithic admission, one chunk and the decode step under
    ``chunk_prefill``), and the monolithic slot prefills the engine ran,
    warmup included. On the card every tick ends in
    ``torch.cuda.synchronize()``. ``reporter`` must be None until
    ``GoodputReporter`` is ported."""
    _reporter_not_ported(reporter)
    eng = ServeEngine(params, cfg, slots=slots, max_seq=max_seq,
                      prompt_bucket=prompt_bucket,
                      chunk_prefill=chunk_prefill, device=device)
    sync = _tick_sync(eng)
    eng.warmup()
    for r in requests:
        eng.submit(r)
    sync()
    t0 = time.perf_counter()
    state = {"last": t0, "max_gap": 0.0}

    def stamp():
        sync()
        now = time.perf_counter()
        state["max_gap"] = max(state["max_gap"], now - state["last"])
        state["last"] = now

    completions = eng.run_until_drained(on_tick=stamp)
    elapsed = time.perf_counter() - t0
    total_tokens = sum(len(c.tokens) for c in completions)
    ticks = max(1, eng.tick_count)
    return {
        "tokens": float(total_tokens),
        "elapsed_s": elapsed,
        "tokens_per_s": total_tokens / max(elapsed, 1e-9),
        "occupancy": eng.decode_tokens / (ticks * slots),
        "ticks": float(ticks),
        "max_tick_gap_s": state["max_gap"],
        "prefills": float(eng.prefills),
    }


def _pctl(xs: List[float], q: float) -> float:
    ys = sorted(xs)
    return ys[min(len(ys) - 1, int(round(q * (len(ys) - 1))))] if ys else 0.0


def measure_serving_slo(cfg: ModelConfig, params: Params,
                        requests: List[Request],
                        arrival_ticks: List[int], *,
                        slots: int = 8, max_seq: int = 1024,
                        prompt_bucket: "int | Tuple[int, ...]" = 128,
                        chunk_prefill: Optional[int] = None,
                        prefix_tokens: Optional[np.ndarray] = None,
                        ttft_slo_ticks: Optional[int] = None,
                        reporter=None, device=None) -> Dict[str, float]:
    """Serving statistics under arrivals by tick: each request is submitted
    at the first tick >= its ``arrival_ticks`` entry, and its time to first
    token (TTFT) runs from its submission to the tick that gave it a token.

    Ticks (``ttft_ticks_p50``/``_p99``, ``ticks``, ``tokens_per_tick`` and,
    with ``ttft_slo_ticks``, ``slo_attainment`` and
    ``goodput_tokens_per_tick``) depend only on the geometry when no
    request has an EOS token; seconds (``ttft_s_*``, ``per_token_s``,
    ``tokens_per_s``, ``goodput_tokens_per_s``) are wall time, each tick
    ending in ``torch.cuda.synchronize()`` on the card. ``prefix_tokens``
    registers a shared prefix (chunked engines only) that every request's
    prompt follows. Goodput counts the tokens of requests whose tick TTFT
    is within ``ttft_slo_ticks``. ``reporter`` must be None until
    ``GoodputReporter`` is ported."""
    _reporter_not_ported(reporter)
    eng = ServeEngine(params, cfg, slots=slots, max_seq=max_seq,
                      prompt_bucket=prompt_bucket,
                      chunk_prefill=chunk_prefill, device=device)
    sync = _tick_sync(eng)
    eng.warmup()
    prefix_id = None
    if prefix_tokens is not None:
        prefix_id = "slo-shared-prefix"
        eng.register_prefix(prefix_id, prefix_tokens)
    order = sorted(zip(arrival_ticks, range(len(requests))))
    pending = collections.deque((t, requests[i]) for t, i in order)
    submit_tick: Dict[int, int] = {}
    submit_wall: Dict[int, float] = {}
    first_tick: Dict[int, int] = {}
    first_wall: Dict[int, float] = {}
    sync()
    t0 = time.perf_counter()
    while pending or eng.queue or any(r is not None for r in eng.req):
        while pending and pending[0][0] <= eng.tick_count:
            _, req = pending.popleft()
            if prefix_id is not None:
                req = dataclasses.replace(req, prefix_id=prefix_id)
            eng.submit(req)
            submit_tick[req.rid] = eng.tick_count
            submit_wall[req.rid] = time.perf_counter()
        eng.tick()
        sync()
        now = time.perf_counter()
        for s in range(eng.slots):
            req = eng.req[s]
            if (req is not None and req.rid not in first_tick
                    and eng.generated[s]):
                first_tick[req.rid] = eng.tick_count
                first_wall[req.rid] = now
        for c in eng.completions:
            # a request that finishes in its admission tick has left its
            # slot before the scan above
            if c.rid not in first_tick:
                first_tick[c.rid] = eng.tick_count
                first_wall[c.rid] = now
        if eng.tick_count > 100_000:
            raise RuntimeError("serving SLO harness did not drain")
    elapsed = time.perf_counter() - t0
    completions = eng.completions
    total_tokens = sum(len(c.tokens) for c in completions)
    ttft_ticks = [first_tick[r.rid] - submit_tick[r.rid] for r in requests]
    ttft_s = [first_wall[r.rid] - submit_wall[r.rid] for r in requests]
    out = {
        "ttft_ticks_p50": _pctl(ttft_ticks, 0.50),
        "ttft_ticks_p99": _pctl(ttft_ticks, 0.99),
        "ttft_s_p50": _pctl(ttft_s, 0.50),
        "ttft_s_p99": _pctl(ttft_s, 0.99),
        "per_token_s": elapsed / max(total_tokens, 1),
        "tokens_per_s": total_tokens / max(elapsed, 1e-9),
        "tokens": float(total_tokens),
        "ticks": float(eng.tick_count),
        "tokens_per_tick": total_tokens / max(eng.tick_count, 1),
        "elapsed_s": elapsed,
    }
    if ttft_slo_ticks is not None:
        ok = {r.rid for r, t in zip(requests, ttft_ticks)
              if t <= ttft_slo_ticks}
        ok_tokens = sum(len(c.tokens) for c in completions if c.rid in ok)
        out["slo_attainment"] = len(ok) / max(len(requests), 1)
        out["goodput_tokens_per_s"] = ok_tokens / max(elapsed, 1e-9)
        out["goodput_tokens_per_tick"] = ok_tokens / max(eng.tick_count, 1)
    return out
