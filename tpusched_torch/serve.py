"""Continuous-batching serving engine over the KV-cache decode path.

Counterpart of ``tpusched/jaxbridge/serve.py`` (its plain path). A fixed
arena of ``slots`` sequences, (slots, max_seq) rows per layer, decodes in
lock-step; requests join and leave slots mid-flight. A joining request's
prompt is padded to the smallest prompt bucket that fits and prefilled
alone through the configured attention (the flash kernel for
``attn="flash"``); its K/V rows are written into its slot in place, so
resident slots are untouched and continuous batching gives each request
exactly the tokens it would get alone.

Pad keys land at positions >= the prompt's true length, which the causal
cursor masks until the decode step overwrites them. Idle slots decode
garbage at their stale cursor; the host discards it.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .decode import KVCache, decode_step, init_kv_cache, sample_token
from .workload import (ModelConfig, Params, _finish_block, _qkv,
                       _resolve_attn_fn, _rmsnorm, cast_params_for_compute,
                       resolve_device)


@dataclasses.dataclass
class Request:
    """One generation request: at most ``max_new_tokens`` tokens, ended
    early by ``eos_token`` when set."""
    rid: int
    prompt: np.ndarray                  # (true_len,) int32
    max_new_tokens: int
    eos_token: Optional[int] = None


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: np.ndarray                  # generated tokens (<= max_new_tokens)
    prompt_len: int
    admitted_tick: int
    finished_tick: int


def _arena_write(c: Dict[str, torch.Tensor], k: torch.Tensor,
                 v: torch.Tensor, slot: int, off: int) -> None:
    """Write K/V rows (1, n, kv, hd) into ONE slot's rows [off, off+n), in
    place."""
    n = k.shape[1]
    c["k"][slot, off:off + n] = k[0]
    c["v"][slot, off:off + n] = v[0]


def _prefill_slot(params: Params, cache: KVCache, prompt: torch.Tensor,
                  slot: int, true_len: int,
                  cfg: ModelConfig) -> torch.Tensor:
    """Prefill one padded prompt (bucket,) into ``slot``'s rows with the
    configured attention; returns the next-token logits (vocab,) of the
    last real prompt position."""
    attn_fn = _resolve_attn_fn(cfg)
    params = cast_params_for_compute(params, cfg)
    x = params["embed"][prompt][None, :, :]            # (1, bucket, d)
    for layer, c in zip(params["layers"], cache):
        h = _rmsnorm(x, layer["ln_attn"])
        q, k, v = _qkv(h, layer, cfg)
        _arena_write(c, k, v, slot, 0)
        x, _ = _finish_block(x, layer, attn_fn(q, k, v), cfg, dropless=True)
    x = _rmsnorm(x, params["ln_f"])
    logits = x[0] @ params["out"]                      # (bucket, vocab)
    return logits[true_len - 1]


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
        if chunk_prefill is not None:
            raise _not_ported("chunk_prefill", "int8 KV, chunked prefill and "
                              "prefix caching")
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
        self.params = params
        self.cfg = cfg
        self.slots = slots
        self.max_seq = max_seq
        self.prompt_buckets = buckets
        self.prompt_bucket = buckets[-1]   # largest (admission bound)
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.cache = init_kv_cache(cfg, slots, max_seq, device=self.device)
        # host-side slot state
        self.pos = np.zeros(slots, dtype=np.int64)       # next write position
        self.next_tok = np.zeros(slots, dtype=np.int64)  # last sampled token
        self.req: List[Optional[Request]] = [None] * slots
        self.generated: List[List[int]] = [[] for _ in range(slots)]
        self.admitted_at = np.zeros(slots, dtype=np.int64)
        self.queue: List[Request] = []
        self.completions: List[Completion] = []
        self.tick_count = 0
        self.decode_tokens = 0          # real (non-idle) tokens decoded
        self.prefills = 0               # slot prefills run, warmup included

    # -- submission -----------------------------------------------------------

    def submit(self, req: Request) -> None:
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (prefill always "
                             "samples the first token)")
        if len(req.prompt) < 1:
            raise ValueError("prompt must hold at least one token")
        if len(req.prompt) > self.prompt_bucket:
            raise ValueError(
                f"prompt len {len(req.prompt)} > bucket {self.prompt_bucket}")
        if len(req.prompt) + req.max_new_tokens > self.max_seq:
            # keeps every in-place cache write inside the arena
            raise ValueError("prompt + max_new_tokens exceeds max_seq")
        self.queue.append(req)

    def warmup(self) -> None:
        """One full-length request per bucket through the real path (the
        first generates 2 tokens so the decode tick runs too), then reset
        the metric counters. ``prefills`` is not reset: it counts every
        prefill the engine ran."""
        for i, bucket in enumerate(self.prompt_buckets):
            self.submit(Request(rid=-1,
                                prompt=np.zeros(bucket, dtype=np.int32),
                                max_new_tokens=min(2, self.max_seq - bucket)
                                if i == 0 else 1))
            self.run_until_drained()
        self.completions.clear()
        self.tick_count = 0
        self.decode_tokens = 0

    # -- engine loop ----------------------------------------------------------

    def _admit(self) -> None:
        for slot in range(self.slots):
            if self.req[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
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
            self.req[slot] = req
            self.pos[slot] = true_len
            self.next_tok[slot] = tok
            self.generated[slot] = [tok]
            self.admitted_at[slot] = self.tick_count
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
            prompt_len=len(req.prompt),
            admitted_tick=int(self.admitted_at[slot]),
            finished_tick=self.tick_count))
        self.req[slot] = None
        self.generated[slot] = []

    @torch.no_grad()
    def tick(self) -> int:
        """Admit waiting requests into free slots, then one decode step over
        the arena. Returns the number of active slots (0 = idle tick)."""
        self._admit()
        active = [s for s in range(self.slots) if self.req[s] is not None]
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


def measure_serving(cfg: ModelConfig, params: Params, requests: List[Request],
                    *, slots: int = 8, max_seq: int = 1024,
                    prompt_bucket: "int | Tuple[int, ...]" = 128,
                    device=None) -> Dict[str, float]:
    """Serve ``requests`` on a warmed engine: tokens/s, occupancy (real
    tokens per slot-tick), ticks, the largest gap between ticks (the
    head-of-line stall an admission inflicts on residents), and the slot
    prefills the engine ran, warmup included. On the card every tick ends
    in ``torch.cuda.synchronize()`` so each pays for its own work."""
    eng = ServeEngine(params, cfg, slots=slots, max_seq=max_seq,
                      prompt_bucket=prompt_bucket, device=device)
    sync = (torch.cuda.synchronize if eng.device.type == "cuda"
            else (lambda: None))
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
