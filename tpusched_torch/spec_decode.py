"""Speculative decoding: a small draft model proposes, the target verifies.

Counterpart of ``tpusched/jaxbridge/spec_decode.py``. The draft decodes k
tokens one at a time (``decode.draft_rollout``), then the target scores the
last emitted token and all k proposals in ONE span (``decode.score_span``),
so one weight stream of the target can emit up to k + 1 tokens. Greedy
acceptance keeps a proposal while it equals the target's argmax at its row,
emits the target's own token at the first mismatch (or its bonus token
after k matches), so the output is exactly the target's greedy decode.
Sampled speculation accepts a proposal with probability min(1, q/p) and
resamples from the residual norm(max(q - p, 0)) on rejection, which keeps
the target's sampling distribution exactly. Its randomness is keyed by row
(``decode.fold_in``'s convention; an int key where the reference takes a
JAX key).

Rejected rows need no rollback: cursors move only through accepted rows,
every later query's causal mask hides the rows above it, and each row is
written again before any query attends it.

A round's device work runs as programs (:mod:`.program`) over the two
caches, with the cursors ``t_pos`` and ``d_pos`` copied in, the
counterparts of the reference's jitted ``_span``, ``_draft`` and
``_sampling_draft``: built once a call (or once for a
:class:`Speculation`, which keeps them between calls), captured as CUDA
graphs on the card and replayed every round; on the CPU the bodies run as
they are. The greedy draft keeps one program per catch-up feed length (1
or 2 rows), as the reference compiles one per shape. A sampled round is
three programs, since its draws are made on the host: the draft's ingest,
its one-token step replayed k - 1 times, and the verify span's adjusted
logits. The prompt's prefill is a plain call; the prompt's device is the
device everything runs on.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .decode import (ACCEPT_SALT, RESIDUAL_SALT, KVCache,
                     _adjusted_span_program, _keyed_proposals, draft_rollout,
                     host_adjusted_logits, init_kv_cache, keyed_categorical,
                     keyed_uniform, prefill, probs_from_adjusted, score_span)
from .program import Program
from .workload import ModelConfig, Params, cast_params_for_compute

def _check(prompt: torch.Tensor, target_cfg: ModelConfig,
           draft_cfg: ModelConfig, k: int, single: str) -> None:
    if prompt.shape[0] != 1:
        raise ValueError(single)
    _check_pair(target_cfg, draft_cfg, k)


def _check_pair(target_cfg: ModelConfig, draft_cfg: ModelConfig,
                k: int) -> None:
    if target_cfg.vocab != draft_cfg.vocab:
        raise ValueError("draft and target must share a vocabulary")
    if k < 1:
        raise ValueError("k must be >= 1")


def _program_factory(device: torch.device):
    """``Program`` with this call's ``graphed`` (on the card) and graph pool
    bound: its programs run one at a time on one stream and share one
    pool."""
    graphed = device.type == "cuda"
    return functools.partial(
        Program, graphed=graphed,
        pool=torch.cuda.graph_pool_handle() if graphed else None)


def _greedy_draft_program(params: Params, cache: KVCache, cfg: ModelConfig,
                          width: int, k: int, program) -> Program:
    """A greedy round's draft, ``decode.draft_rollout`` of a ``width``-row
    catch-up ``feed`` (1, width) at row ``pos`` (a device scalar):
    proposals (1, k) out."""
    device = cache[0]["k"].device
    feed = torch.zeros((1, width), dtype=torch.long, device=device)
    pos = torch.zeros((), dtype=torch.long, device=device)

    def body():
        return draft_rollout(params, cache, feed, pos, cfg, k)[0]

    return program(body, {"feed": feed, "pos": pos})


def _greedy_span_program(params: Params, cache: KVCache, cfg: ModelConfig,
                         k: int, program) -> Program:
    """A greedy round's verification, ``decode.score_span`` of ``scored``
    (1, k + 1) at row ``pos`` (a device scalar): the target's argmax
    (1, k + 1) out."""
    device = cache[0]["k"].device
    scored = torch.zeros((1, k + 1), dtype=torch.long, device=device)
    pos = torch.zeros((), dtype=torch.long, device=device)

    def body():
        return torch.argmax(score_span(params, cache, scored, pos, cfg)[0],
                            dim=-1)

    return program(body, {"scored": scored, "pos": pos})


def _stats(target_calls: int, total: int, drafted: int,
           accepted: int) -> dict:
    return {"target_calls": target_calls,
            "plain_calls": total,
            "drafted": drafted,
            "accepted": accepted,
            "accept_rate": accepted / max(drafted, 1)}


class Speculation:
    """Greedy speculative decoding of ``steps`` steps for one-sequence
    prompts of length ``s0``, its device state kept between calls: the two
    caches and the round programs over them (the greedy draft of a 1- and
    a 2-row catch-up feed, and the target's span), built once and replayed
    by every call, as the reference's jitted programs stay compiled between
    calls. :func:`speculative_generate` builds one for a call."""

    def __init__(self, target_params: Params, target_cfg: ModelConfig,
                 draft_params: Params, draft_cfg: ModelConfig, s0: int,
                 steps: int, k: int = 4, device=None):
        _check_pair(target_cfg, draft_cfg, k)
        self.target_cfg, self.draft_cfg = target_cfg, draft_cfg
        self.s0, self.total, self.k = s0, int(steps) + 1, k
        max_seq = s0 + self.total + k + 2   # headroom for the last overshoot
        self.t_cache = init_kv_cache(target_cfg, 1, max_seq, device=device)
        self.d_cache = init_kv_cache(draft_cfg, 1, max_seq, device=device)
        self.target_params = cast_params_for_compute(target_params,
                                                     target_cfg)
        self.draft_params = cast_params_for_compute(draft_params, draft_cfg)
        program = _program_factory(self.t_cache[0]["k"].device)
        self.drafts = {n: _greedy_draft_program(
            self.draft_params, self.d_cache, draft_cfg, n, k, program)
            for n in (1, 2)}
        self.verify = _greedy_span_program(self.target_params, self.t_cache,
                                           target_cfg, k, program)

    @torch.no_grad()
    def __call__(self, prompt: torch.Tensor) -> Tuple[np.ndarray, dict]:
        """(tokens (1, steps + 1) int32, stats) for ``prompt`` (1, s0), as
        :func:`speculative_generate` returns them."""
        if tuple(prompt.shape) != (1, self.s0):
            raise ValueError(f"a prompt of shape {tuple(prompt.shape)} for "
                             f"a speculation of prompts (1, {self.s0})")
        s0, total, k = self.s0, self.total, self.k
        t_logits, _ = prefill(self.target_params, self.t_cache, prompt,
                              self.target_cfg)
        prefill(self.draft_params, self.d_cache, prompt, self.draft_cfg)
        out = [int(torch.argmax(t_logits[0, s0 - 1]))]

        # cursors: the next write row of each cache. At every round's start
        # rows [0, t_pos) of the target cache and [0, d_pos) of the draft
        # cache hold the accepted stream; out's last t_pos - d_pos + 1
        # tokens are what the draft has not ingested yet
        t_pos = d_pos = s0
        target_calls = 1                      # the prefill gave out[0]
        drafted = accepted = 0
        while len(out) < total:
            feed = out[len(out) - (t_pos - d_pos) - 1:]
            catch_up = len(feed)          # 1, or 2 after a full acceptance
            # one host read for all proposals
            span = self.drafts[catch_up](feed=[feed], pos=d_pos)[0].tolist()
            drafted += k
            # one target stream scores [last emitted] + span at
            # t_pos..t_pos+k; row i's argmax answers row t_pos+i+1, row k
            # is the bonus
            t_arg = self.verify(scored=[[out[-1]] + span],
                                pos=t_pos)[0].tolist()
            target_calls += 1
            n_ok = 0
            while n_ok < k and span[n_ok] == t_arg[n_ok]:
                n_ok += 1
            accepted += n_ok
            out.extend(span[:n_ok])
            out.append(t_arg[n_ok])       # the correction, or the bonus
            # the target's valid rows reach t_pos + n_ok; the draft's: the
            # catch-up plus the accepted proposals it fed (never span[k-1])
            t_pos += n_ok + 1
            d_pos += catch_up + min(n_ok, k - 1)
        tokens = np.asarray([out[:total]], dtype=np.int32)
        return tokens, _stats(target_calls, total, drafted, accepted)


@torch.no_grad()
def speculative_generate(target_params: Params, target_cfg: ModelConfig,
                         draft_params: Params, draft_cfg: ModelConfig,
                         prompt: torch.Tensor, steps: int,
                         k: int = 4) -> Tuple[np.ndarray, dict]:
    """Greedy speculative decoding of one sequence (prompt (1, s0)):
    ``steps + 1`` tokens, exactly the target's greedy continuation
    (``decode.generate``'s contract). Returns (tokens (1, steps + 1) int32,
    stats): ``target_calls`` (target weight streams; plain decoding makes
    ``plain_calls``), ``drafted``, ``accepted`` and ``accept_rate``."""
    _check(prompt, target_cfg, draft_cfg, k,
           "speculative_generate is single-sequence (b=1); batched "
           "speculation belongs in the serve engine")
    return Speculation(target_params, target_cfg, draft_params, draft_cfg,
                       prompt.shape[1], steps, k, prompt.device)(prompt)


# -- distribution-preserving speculative SAMPLING -----------------------------

def residual_distribution(p: np.ndarray, q: np.ndarray) -> np.ndarray:
    """The rejection-path distribution norm(max(q - p, 0)): what makes
    speculative sampling EXACTLY distribution-preserving —
    P(emit y) = p(y)·min(1, q(y)/p(y)) + P(reject)·residual(y) = q(y)
    (tests/test_spec_decode.py verifies that identity numerically against
    THIS function). Degenerate guard: when q ≤ p everywhere (q == p),
    rejection is impossible, but a caller that lands here anyway gets q."""
    r = np.maximum(np.asarray(q, np.float64) - np.asarray(p, np.float64), 0)
    s = float(r.sum())
    if s <= 1e-12:
        qq = np.asarray(q, np.float64)
        return qq / max(float(qq.sum()), 1e-30)
    return r / s


def accept_span(span, p_mat: np.ndarray, q_mat: np.ndarray,
                acc_u: np.ndarray, res_u: np.ndarray
                ) -> "Tuple[int, Optional[int]]":
    """THE acceptance/residual decision over one proposal span: proposals
    ``span`` (k,), draft distributions ``p_mat`` (k, V), target
    distributions ``q_mat`` (k, V) — float64, computed host-side from the
    adjusted logits — and the round's accept/residual uniforms.
    Returns (n_accepted, rejection_token-or-None). ONE definition shared
    by solo ``speculative_sample`` and the engine's batched sampled tick:
    the engine-vs-solo parity law depends on this math never drifting."""
    k = len(span)
    n_ok = 0
    while n_ok < k:
        x = int(span[n_ok])
        ratio = q_mat[n_ok, x] / max(p_mat[n_ok, x], 1e-30)
        if float(acc_u[n_ok]) < min(1.0, ratio):
            n_ok += 1
            continue
        res = residual_distribution(p_mat[n_ok], q_mat[n_ok])
        return n_ok, int(np.searchsorted(
            np.cumsum(res), float(res_u[n_ok]),
            side="right").clip(0, len(res) - 1))
    return k, None


def round_uniforms(key: int, t_pos: int, k: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """One round's acceptance and residual uniforms: the proposals occupy
    rows t_pos + 1 .. t_pos + k, each drawing ``(key, ACCEPT_SALT + row)``
    and ``(key, RESIDUAL_SALT + row)``."""
    rows = range(t_pos + 1, t_pos + 1 + k)
    return (np.asarray([keyed_uniform(key, ACCEPT_SALT + r) for r in rows]),
            np.asarray([keyed_uniform(key, RESIDUAL_SALT + r) for r in rows]))


@torch.no_grad()
def speculative_sample(target_params: Params, target_cfg: ModelConfig,
                       draft_params: Params, draft_cfg: ModelConfig,
                       prompt: torch.Tensor, steps: int, key: int,
                       k: int = 4, temperature: float = 1.0,
                       top_k: int = 0, top_p: float = 1.0
                       ) -> Tuple[np.ndarray, dict]:
    """Distribution-preserving speculative sampling of one sequence:
    ``steps + 1`` tokens distributed exactly as the target's adjusted
    sampling distribution; the draft changes only speed. Randomness is
    row-keyed (``decode.sample_position_keyed``'s convention): the token
    at row ``p`` draws ``(key, p)``, acceptance and residual draws the
    salted rows. So a re-proposed row draws the same key again, and a
    perfect draft (draft == target) reproduces ``sample_position_keyed``
    token for token. Returns (tokens (1, steps + 1) int32, stats)."""
    _check(prompt, target_cfg, draft_cfg, k,
           "speculative_sample is single-sequence (b=1)")
    if temperature <= 0.0:
        raise ValueError("temperature must be > 0 (use "
                         "speculative_generate for greedy)")
    device = prompt.device
    total = int(steps) + 1
    s0 = prompt.shape[1]
    max_seq = s0 + total + k + 2
    t_cache = init_kv_cache(target_cfg, 1, max_seq, device=device)
    d_cache = init_kv_cache(draft_cfg, 1, max_seq, device=device)
    target_params = cast_params_for_compute(target_params, target_cfg)
    draft_params = cast_params_for_compute(draft_params, draft_cfg)
    t_logits, t_cache = prefill(target_params, t_cache, prompt, target_cfg)
    prefill(draft_params, d_cache, prompt, draft_cfg)
    out = [keyed_categorical(host_adjusted_logits(
        t_logits[:, s0 - 1], temperature, top_k, top_p)[0], key, s0)]
    # the serving engine's sampled round at batch 1: the draft's ingest (a
    # program per catch-up length), its one-token step and the verify span
    program = _program_factory(device)
    sampling = (temperature, top_k, top_p)
    ingest = {n: _adjusted_span_program(draft_params, d_cache, draft_cfg,
                                        (1, n), sampling, program)
              for n in (1, 2)}
    step = _adjusted_span_program(draft_params, d_cache, draft_cfg, (1, 1),
                                  sampling, program)
    verify = _adjusted_span_program(target_params, t_cache, target_cfg,
                                    (1, k + 1), sampling, program,
                                    last=False)
    t_pos = d_pos = s0
    target_calls = 1
    drafted = accepted = 0
    while len(out) < total:
        feed = out[len(out) - (t_pos - d_pos) - 1:]
        catch_up = len(feed)
        # the first proposal takes row d_pos + catch_up == t_pos + 1
        span, p_mat = _keyed_proposals(
            ingest[catch_up](tokens=[feed], pos=[d_pos]),
            lambda tok, i: step(tokens=tok[:, None],
                                pos=[d_pos + catch_up + i]),
            [key], [d_pos + catch_up], k)
        span = span[0].tolist()
        drafted += k
        adj = verify(tokens=[[out[-1]] + span],
                     pos=[t_pos]).cpu().numpy()[0]            # (k+1, V)
        target_calls += 1
        q_mat = probs_from_adjusted(adj)
        acc_u, res_u = round_uniforms(key, t_pos, k)
        n_ok, rejection = accept_span(span, p_mat[0], q_mat[:k], acc_u,
                                      res_u)
        accepted += n_ok
        if rejection is None:
            # full acceptance: the bonus at row t_pos+k+1 draws its own
            # row's key, as sample_position_keyed would there
            out.extend(span)
            out.append(keyed_categorical(adj[k], key, t_pos + k + 1))
        else:
            out.extend(span[:n_ok])
            out.append(rejection)
        t_pos += n_ok + 1
        d_pos += catch_up + min(n_ok, k - 1)
    tokens = np.asarray([out[:total]], dtype=np.int32)
    return tokens, _stats(target_calls, total, drafted, accepted)
