"""KV-cache inference: prefill, single-token decode, sampling, generation.

Counterpart of ``tpusched/jaxbridge/decode.py``. One (b, max_seq, kv_heads,
head_dim) K and V per layer, exact or (``cfg.kv_cache_dtype="int8"``) int8
with one f32 scale per (row, KV head) in planes ``ks``/``vs``; queries
attend the cache through a position mask. On the card one query token in
bf16 or fp16 attends through K4 (``attention.decode_attention``), which
reads each slot's live rows in place instead. Unlike the reference, whose
arrays are immutable, the cache is written IN PLACE: ``cache_update`` and
every function that takes a cache mutate it and return the same object.

Under tensor parallelism (``tp=``, the tp axis of a ``mesh``) every
function here takes this rank's shards of the weights and a cache of its
kv_heads/tp heads; attention and cache writes stay local, and the logits
come back whole on every rank. Under expert parallelism (``ep=``) each
rank holds E/ep of an MoE layer's experts and the same whole cache; the
experts' outputs are gathered over ep before the dropless combine. Under
full sharding (``fsdp=``) each rank holds its fsdp chunk of every matrix
and the whole cache; a layer's weights, and ``embed`` and ``out``, are
gathered where they are used (``workload._gather_fsdp``). The gather is
an exact sum of zero-padded buffers, so the gathered weight is the whole
weight bit for bit and the rank computes one card's logits.

Speculative decoding's draft phase (``draft_rollout``,
``sampling_draft_rollout``) and request-keyed sampling
(``sample_position_keyed``, ``keyed_sample``) live here too. JAX's threefry
``fold_in``/``categorical`` cannot be reproduced in torch, so keyed draws
follow this module's own counter-based convention with the same laws: a
key is a 64-bit int, ``fold_in`` mixes data into it with the splitmix64
finaliser, and a draw is an inverse-CDF lookup of ``keyed_uniform`` in the
float64 distribution of the adjusted logits, on the host
(``keyed_categorical``, the law's reference) or on the device
(``keyed_draw``, inside the serving engine's decode tick).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from . import attention
from .mesh import Axis, broadcast
from .program import Program
from .workload import (ExpertAxes, ModelConfig, Params, _as_pos_vec,
                       _finish_block, _gather_fsdp, _qkv, _resolve_attn_fn,
                       _rmsnorm, cast_params_for_compute, embed,
                       resolve_device, unembed)

KVCache = List[Dict[str, torch.Tensor]]


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  device=None, tp: Optional[Axis] = None) -> KVCache:
    """Zeroed cache, one entry per layer: ``k``/``v`` (batch, max_seq,
    kv_heads, head_dim) in ``cfg.dtype``, or int8 with f32 scale planes
    ``ks``/``vs`` (batch, max_seq, kv_heads) when ``cfg.kv_cache_dtype`` is
    "int8" (half the bytes a decode step streams for the cache). Under
    ``tp`` the rank's kv_heads/tp heads: the cached attention and the
    writes are then local to the rank."""
    device = resolve_device(device)
    shards = tp.size if tp is not None else 1
    if cfg.kv_heads % shards:
        raise ValueError(f"kv_heads {cfg.kv_heads} not divisible by tp "
                         f"{shards}")
    shape = (batch, max_seq, cfg.kv_heads // shards, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        return [{"k": torch.zeros(shape, dtype=torch.int8, device=device),
                 "v": torch.zeros(shape, dtype=torch.int8, device=device),
                 "ks": torch.zeros(shape[:3], dtype=torch.float32,
                                   device=device),
                 "vs": torch.zeros(shape[:3], dtype=torch.float32,
                                   device=device)}
                for _ in range(cfg.n_layers)]
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
            for _ in range(cfg.n_layers)]


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over head_dim, one f32 scale per (row, KV head):
    (b, s, kv, hd) -> (int8 (b, s, kv, hd), f32 (b, s, kv)). The 1e-8 floor
    applies to max|x| before the division, rounding is half to even
    (``torch.round``), and the clip is ±127, as in the reference."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1), min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _cache_write(cache: torch.Tensor, new: torch.Tensor, pos,
                 slot: Optional[torch.Tensor] = None) -> None:
    """Write ``new`` (b, n, ...) into ``cache`` IN PLACE at sequence offset
    ``pos``: an int (the whole batch aligned, a slice write), or a tensor on
    the cache's device, 0-d or (b,) (each row at its own offset), written
    through index writes that a CUDA graph records, with no read to the
    host. With ``slot`` (a device index, 0-d or (1,)) ``new`` holds one row
    (1, n, ...), written into that batch row of the cache at ``pos``: an
    int (the slot prefill's, a slice write) or a 0-d tensor (the chunk
    program's, index writes). Any rank past (batch, seq), so the int8
    scale planes (b, s, kv) take the path of the values. Rows must fit:
    unlike the reference's dynamic_update_slice, which clamps an
    out-of-range start, a row past the end raises (on the card, a
    device-side assert) and a negative one counts from the end; the
    serving engine's guards keep every write in range."""
    n = new.shape[1]
    if slot is not None:
        if isinstance(pos, torch.Tensor):
            rows = _as_pos_vec(pos, cache.device)[:, None] + torch.arange(
                n, device=cache.device)
            cache[slot.reshape(1, 1), rows] = new
            return
        cache[:, pos:pos + n].index_copy_(0, slot.reshape(1), new)
        return
    if not isinstance(pos, torch.Tensor):
        p = int(pos)
        cache[:, p:p + n] = new
        return
    rows = _as_pos_vec(pos, cache.device)[:, None] + torch.arange(
        n, device=cache.device)
    batch = torch.arange(cache.shape[0], device=cache.device)[:, None]
    cache[batch, rows] = new


def cache_update(c: Dict[str, torch.Tensor], k: torch.Tensor,
                 v: torch.Tensor, pos,
                 slot: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
    """Write fresh K/V rows into the cache entry at ``pos`` (and ``slot``,
    as :func:`_cache_write` takes them), in place, quantized when the entry
    is int8; the one write path of decode, prefill and span scoring."""
    if "ks" in c:
        k, ks = _quantize_kv(k)
        v, vs = _quantize_kv(v)
        _cache_write(c["ks"], ks, pos, slot)
        _cache_write(c["vs"], vs, pos, slot)
    _cache_write(c["k"], k, pos, slot)
    _cache_write(c["v"], v, pos, slot)
    return c


def cache_kv(c: Dict[str, torch.Tensor], dtype: torch.dtype
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The entry's K/V in the compute ``dtype``. An int8 entry is
    dequantized as the reference does it: the scale is cast to ``dtype``
    first and the product taken in ``dtype`` (in bf16 the scale is rounded
    before the multiply)."""
    if "ks" in c:
        return (c["k"].to(dtype) * c["ks"].to(dtype)[..., None],
                c["v"].to(dtype) * c["vs"].to(dtype)[..., None])
    return c["k"], c["v"]


def _cached_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                      pos, n_rep: int) -> torch.Tensor:
    """q (b, s_q, h, hd) against the GQA cache up to ``pos + s_q - 1``. One
    query token on the card in bf16 or fp16 at a head dim K4 is built for
    (``attention.decode_kernel_takes``) goes through K4, which reads each
    slot's live rows in place; everything else, the CPU included, through
    :func:`_einsum_attention`."""
    if attention.decode_kernel_takes(q.device, q.shape[1], ck.dtype,
                                     q.shape[3]):
        return attention.decode_attention(q, ck, cv, pos, n_rep)
    return _einsum_attention(q, ck, cv, pos, n_rep)


def _einsum_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                      pos, n_rep: int) -> torch.Tensor:
    """The reference's einsums over the whole cache: rows past ``pos +
    s_q - 1`` are masked with the finite NEG_INF, so an idle slot decoding
    at a stale cursor stays finite. The group axis is folded, never
    expanded."""
    b, s_q, h, hd = q.shape
    kv = ck.shape[2]
    qg = q.reshape(b, s_q, kv, n_rep, hd)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, ck) / math.sqrt(hd)
    max_seq = ck.shape[1]
    off = _as_pos_vec(pos, q.device)
    q_pos = off[:, None] + torch.arange(s_q, device=q.device)[None, :]
    mask = q_pos[:, None, None, :, None] >= torch.arange(max_seq,
                                                         device=q.device)
    # masked in f32: NEG_INF (f32's min) does not fit bf16, where the
    # reference's cast rounds it to -inf; either way its softmax weight is 0
    logits = torch.where(mask, logits.float(), attention.NEG_INF)
    attn = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bgrqk,bkgd->bqgrd", attn, cv).reshape(b, s_q, h, hd)


def _layer_decode(x: torch.Tensor, layer: Dict[str, torch.Tensor], c, pos,
                  cfg: ModelConfig, tp: Optional[Axis] = None,
                  ep: Optional[Axis] = None,
                  fsdp: Optional[Axis] = None,
                  slot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One layer of span scoring; with ``slot`` (a device index) the one
    row x (1, n, d) is written into that batch row of the cache and attends
    that row's whole row space, read by ``index_select``."""
    layer = _gather_fsdp(layer, cfg, fsdp)
    h = _rmsnorm(x, layer["ln_attn"])
    q, k, v = _qkv(h, layer, cfg, pos_offset=pos, tp=tp)
    cache_update(c, k, v, pos, slot)
    if slot is not None:
        c = {n: t.index_select(0, slot.reshape(1)) for n, t in c.items()}
    ck, cv = cache_kv(c, q.dtype)
    # the group size is the config's on every rank: tp splits whole groups
    o = _cached_attention(q, ck, cv, pos, cfg.n_heads // cfg.kv_heads)
    # dropless: a decoded token's MoE output depends on that token alone
    return _finish_block(x, layer, o, cfg, dropless=True, tp=tp,
                         moe=ExpertAxes(ep))[0]


def _layer_prefill(x: torch.Tensor, layer: Dict[str, torch.Tensor], c,
                   cfg: ModelConfig, attn_fn,
                   tp: Optional[Axis] = None,
                   ep: Optional[Axis] = None,
                   fsdp: Optional[Axis] = None,
                   slot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Prefill layer: attention over the prompt through the configured
    implementation (the flash kernel when cfg.attn == 'flash'), K/V
    recorded into the cache from position 0 (into batch row ``slot`` when
    given). Attention takes the FRESH K/V, so an int8 cache's error enters
    only at later cached reads."""
    layer = _gather_fsdp(layer, cfg, fsdp)
    h = _rmsnorm(x, layer["ln_attn"])
    q, k, v = _qkv(h, layer, cfg, tp=tp)
    cache_update(c, k, v, 0, slot)
    return _finish_block(x, layer, attn_fn(q, k, v), cfg, dropless=True,
                         tp=tp, moe=ExpertAxes(ep))[0]


def prefill(params: Params, cache: KVCache, tokens: torch.Tensor,
            cfg: ModelConfig, tp: Optional[Axis] = None,
            ep: Optional[Axis] = None,
            fsdp: Optional[Axis] = None,
            slot: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, KVCache]:
    """Run the prompt (b, s), filling the cache from position 0. Returns
    (logits (b, s, vocab), cache). ``tp``: the tensor-parallel axis of
    sharded ``params`` and a cache from ``init_kv_cache(..., tp=tp)``; the
    logits are whole on every rank. ``ep``: the expert-parallel axis of
    sharded MoE ``params``. ``fsdp``: the fully-sharded axis of ``params``
    (the cache is whole over it). ``slot``: for a one-row prompt (1, s), the
    cache's batch row to fill, a device index (the serving engine's arena
    and its slot prefill program)."""
    params = cast_params_for_compute(params, cfg)
    x = embed(params, tokens, tp, cfg, fsdp)
    attn_fn = _resolve_attn_fn(cfg)
    for layer, c in zip(params["layers"], cache):
        x = _layer_prefill(x, layer, c, cfg, attn_fn, tp, ep, fsdp, slot)
    return (unembed(params, _rmsnorm(x, params["ln_f"]), cfg, tp, fsdp),
            cache)


def score_span(params: Params, cache: KVCache, tokens: torch.Tensor, pos,
               cfg: ModelConfig, tp: Optional[Axis] = None,
               ep: Optional[Axis] = None,
               fsdp: Optional[Axis] = None) -> Tuple[torch.Tensor, KVCache]:
    """Teacher-force ``tokens`` (b, n) at positions pos..pos+n-1 (``pos``
    scalar or (b,)): returns (logits (b, n, vocab), cache). ``tp``, ``ep``
    and ``fsdp`` as in :func:`prefill`."""
    return _score(params, cache, tokens, pos, cfg, tp, ep, fsdp), cache


def _score(params: Params, cache: KVCache, tokens: torch.Tensor, pos,
           cfg: ModelConfig, tp: Optional[Axis] = None,
           ep: Optional[Axis] = None, fsdp: Optional[Axis] = None,
           slot: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``score_span``'s logits. With ``slot`` (a device index) one row
    ``tokens`` (1, n) goes into that batch row of the cache at ``pos`` (a
    device scalar), its queries attending that row's whole row space
    masked at ``pos``: the serving engine's chunk program."""
    params = cast_params_for_compute(params, cfg)
    x = embed(params, tokens, tp, cfg, fsdp)
    for layer, c in zip(params["layers"], cache):
        x = _layer_decode(x, layer, c, pos, cfg, tp, ep, fsdp, slot)
    return unembed(params, _rmsnorm(x, params["ln_f"]), cfg, tp, fsdp)


def decode_step(params: Params, cache: KVCache, tokens_t: torch.Tensor, pos,
                cfg: ModelConfig, tp: Optional[Axis] = None,
                ep: Optional[Axis] = None,
                fsdp: Optional[Axis] = None) -> Tuple[torch.Tensor, KVCache]:
    """One token per sequence, tokens_t (b,), at ``pos`` (scalar or (b,)).
    Returns (logits (b, vocab), cache)."""
    logits, cache = score_span(params, cache, tokens_t[:, None], pos, cfg, tp,
                               ep, fsdp)
    return logits[:, 0], cache


def adjusted_logits(logits: torch.Tensor, temperature: float = 1.0,
                    top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Temperature, then top-k, then nucleus (top-p) over rows of logits
    (b, vocab): f32 logits whose softmax is the sampling distribution.
    Rank 0 always survives the nucleus. temperature must be > 0."""
    logits = logits.float() / temperature
    vocab = logits.shape[-1]
    if 0 < top_k < vocab:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, attention.NEG_INF, logits)
    if top_p < 1.0:
        sorted_desc = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_desc, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        ranks = torch.arange(vocab, device=logits.device)[None, :]
        dropped = ((cum - probs) >= top_p) & (ranks > 0)
        threshold = torch.where(dropped, math.inf, sorted_desc).amin(
            dim=-1, keepdim=True)
        logits = torch.where(logits >= threshold, logits, attention.NEG_INF)
    return logits


def sample_token(logits: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0) -> torch.Tensor:
    """One draw per row of logits (b, vocab) from ``adjusted_logits``'s
    distribution with the given generator; temperature 0 is argmax.

    The draw is the exponential race that ``torch.multinomial(probs, 1)``
    runs, written out: the argmax of ``probs / q`` with q ~ Exp(1) from the
    generator, the same kernels on the same generator, so the same tokens
    (``tests/test_torch_decode.py`` pins it). ``multinomial`` first checks
    the distribution with a read to the host, which a CUDA graph capture
    refuses; the race reads nothing back. Its check is kept as an assert on
    the device (``torch._assert_async``): a non-finite probability, which
    softmax makes of a NaN or infinite logit, raises on the CPU and fails
    the kernel on the card, where argmax would return a token."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    if generator is None:
        raise ValueError("sampling at temperature > 0 needs a generator")
    probs = torch.softmax(adjusted_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    torch._assert_async(torch.isfinite(probs).all(),
                        "sampling from a distribution that is not finite")
    q = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return torch.argmax(probs / q, dim=-1)


def _greedy_step(params: Params, cache: KVCache, tok: torch.Tensor,
                 pos: torch.Tensor, out: torch.Tensor, s0: int,
                 cfg: ModelConfig, tp: Optional[Axis] = None,
                 graphed: Optional[bool] = None) -> Program:
    """One greedy decode step as a :class:`Program` over device state: feed
    ``tok`` (b,) at row ``pos`` (0-d), write the argmax into ``tok`` and
    into column ``pos - s0 + 1`` of ``out`` (b, steps + 1), then advance
    ``pos``, all on the device: replayed once a token, the counterpart of
    the reference's ``lax.scan`` body. ``tok`` and ``pos`` are its inputs.
    Captured on the card unless ``graphed`` is False, under ``tp`` as a
    chain broken at each of its collectives; called as it is on the
    CPU."""
    def body():
        logits, _ = decode_step(params, cache, tok, pos, cfg, tp)
        nxt = torch.argmax(logits, dim=-1)
        tok.copy_(nxt)
        out.index_copy_(1, (pos - (s0 - 1)).reshape(1), nxt[:, None])
        pos.add_(1)

    if graphed is None:
        graphed = tok.device.type == "cuda"
    return Program(body, {"tok": tok, "pos": pos}, graphed=graphed)


def _sampled_step(params: Params, cache: KVCache, tok: torch.Tensor,
                  pos: torch.Tensor, out: torch.Tensor, s0: int,
                  cfg: ModelConfig, generator: torch.Generator,
                  sampling: Tuple[float, int, float],
                  graphed: Optional[bool] = None,
                  tp: Optional[Axis] = None) -> Program:
    """One sampled decode step as a :class:`Program`, :func:`_greedy_step`'s
    sibling: feed ``tok`` at row ``pos``, draw the next token with
    ``generator`` (:func:`sample_token`, ``sampling`` = temperature, top_k,
    top_p), write it into ``tok`` and column ``pos - s0 + 1`` of ``out``,
    advance ``pos``, all on the device. The generator is registered with
    the graph, so each replay draws the next numbers of its stream; the
    first call's warm-up is the first step (``advances``), so nothing
    rewinds. Under ``tp`` the token is tp rank 0's draw, broadcast inside
    the step (a break of its chain). Captured on the card unless
    ``graphed`` is False."""
    def body():
        logits, _ = decode_step(params, cache, tok, pos, cfg, tp)
        nxt = broadcast(sample_token(logits, generator, *sampling), tp)
        tok.copy_(nxt)
        out.index_copy_(1, (pos - (s0 - 1)).reshape(1), nxt[:, None])
        pos.add_(1)

    if graphed is None:
        graphed = tok.device.type == "cuda"
    return Program(body, {"tok": tok, "pos": pos}, graphed=graphed,
                   generators=(generator,) if graphed else (),
                   advances=True)


class Generation:
    """Greedy generation of ``steps`` steps for prompts of one shape
    (``batch``, ``s0``), its cache and its step program kept between calls:
    the step (:func:`_greedy_step`) is captured at the first call and
    replayed by every later one, as the reference's scanned loop stays
    compiled between calls. :func:`generate` builds one for a call. ``tp``
    as in :func:`sample`."""

    def __init__(self, params: Params, cfg: ModelConfig, batch: int,
                 s0: int, steps: int, device=None,
                 tp: Optional[Axis] = None):
        self.params = cast_params_for_compute(params, cfg)
        self.cfg, self.tp = cfg, tp
        self.shape, self.steps = (batch, s0), steps
        self.cache = init_kv_cache(cfg, batch, s0 + steps, device=device,
                                   tp=tp)
        device = self.cache[0]["k"].device
        self.out = torch.empty((batch, steps + 1), dtype=torch.long,
                               device=device)
        self.pos = torch.full((), s0, dtype=torch.long, device=device)
        self.step = _greedy_step(self.params, self.cache,
                                 torch.zeros(batch, dtype=torch.long,
                                             device=device),
                                 self.pos, self.out, s0, cfg, tp)

    @torch.no_grad()
    def __call__(self, prompt: torch.Tensor) -> torch.Tensor:
        """(batch, steps + 1) tokens for ``prompt`` (batch, s0), copied out
        of the buffer that the next call overwrites."""
        if tuple(prompt.shape) != self.shape:
            raise ValueError(f"a prompt of shape {tuple(prompt.shape)} for "
                             f"a generation of prompts {self.shape}")
        s0 = self.shape[1]
        logits, _ = prefill(self.params, self.cache, prompt, self.cfg,
                            self.tp)
        tok = torch.argmax(logits[:, s0 - 1], dim=-1)
        self.out[:, 0] = tok
        if self.steps:
            self.step.capture()
        for t in range(self.steps):
            # a capture's warm-up takes one step: the first call rewinds
            self.step(**({"tok": tok, "pos": s0} if t == 0 else {}))
        return self.out.clone()


@torch.no_grad()
def sample(params: Params, prompt: torch.Tensor, cfg: ModelConfig,
           steps: int, generator: Optional[torch.Generator] = None,
           temperature: float = 1.0, top_k: int = 0,
           top_p: float = 1.0, tp: Optional[Axis] = None) -> torch.Tensor:
    """Prefill the prompt (b, s0), then ``steps`` sampled decode steps.
    Returns (b, steps + 1) tokens; temperature 0 is greedy ``generate``.
    ``tp``: the tensor-parallel axis of sharded ``params`` (every rank of
    it calls together); a sampled token is tp rank 0's draw, broadcast, so
    the ranks feed the same token even where their generators would
    not draw alike.

    Greedy decoding is a :class:`Generation` built for the call: it
    replays one captured step (:func:`_greedy_step`) per token, with the
    token, the position and the output kept on the card;
    sampling (temperature > 0, a ``torch.Generator``) likewise replays
    :func:`_sampled_step`, the draw inside it. Under ``tp`` each step is a
    chain of graphs broken at its collectives, the draw's broadcast
    among them: the counterpart of the reference's scan over a mesh."""
    b, s0 = prompt.shape
    if temperature == 0.0:
        return Generation(params, cfg, b, s0, steps, prompt.device,
                          tp)(prompt)
    params = cast_params_for_compute(params, cfg)
    cache = init_kv_cache(cfg, b, s0 + steps, device=prompt.device, tp=tp)
    sampling = (temperature, top_k, top_p)
    logits, cache = prefill(params, cache, prompt, cfg, tp)
    tok = broadcast(sample_token(logits[:, s0 - 1], generator, *sampling),
                    tp)
    out = torch.empty((b, steps + 1), dtype=torch.long, device=prompt.device)
    out[:, 0] = tok
    pos = torch.full((), s0, dtype=torch.long, device=prompt.device)
    step = _sampled_step(params, cache, tok.clone(), pos, out, s0, cfg,
                         generator, sampling, tp=tp)
    for _ in range(steps):
        step()
    return out


def generate(params: Params, prompt: torch.Tensor, cfg: ModelConfig,
             steps: int, tp: Optional[Axis] = None) -> torch.Tensor:
    """Greedy generation: ``sample`` at temperature 0 (``tp`` as there)."""
    return sample(params, prompt, cfg, steps, temperature=0.0, tp=tp)


# -- keyed randomness: the speculative-sampling key convention -----------------

_MASK64 = (1 << 64) - 1

# a position's PROPOSAL draw uses (key, row); its acceptance uniform and its
# residual draw use the salted rows, so the three streams never share a
# counter (rows are < 2**29 in any real context). Shared by solo
# speculation (spec_decode) and the serving engine.
ACCEPT_SALT = 1 << 30
RESIDUAL_SALT = 3 << 29


def _mix64(x: int) -> int:
    """splitmix64's finaliser of ``x`` mod 2**64: a bijection on 64-bit
    ints whose outputs pass as independent for distinct inputs."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_in(key: int, data: int) -> int:
    """A new 64-bit key from ``key`` and the int ``data`` (negative data
    wraps mod 2**64): the counterpart of ``jax.random.fold_in``. Python
    ints, so bit-exact on every host."""
    return _mix64((key & _MASK64) ^ _mix64(data & _MASK64))


def keyed_uniform(key: int, row: int) -> float:
    """The uniform in [0, 1) of ``(key, row)``: the top 53 bits of
    ``fold_in(key, row)`` as a float64."""
    return (fold_in(key, row) >> 11) * 2.0 ** -53


def probs_from_adjusted(adj: np.ndarray) -> np.ndarray:
    """Adjusted logits (…, V) → float64 distributions, the EXACT host
    softmax both speculation paths divide in (a float32 device softmax
    would shift min(1, q/p) by ~1e-7 — enough to flip a token on an
    unlucky uniform and break engine-vs-solo parity)."""
    a = np.asarray(adj, np.float64)
    q = np.exp(a - a.max(axis=-1, keepdims=True))
    return q / q.sum(axis=-1, keepdims=True)


def keyed_categorical(adj: np.ndarray, key: int, row: int) -> int:
    """The token of ``(key, row)`` from one row of adjusted logits (V,): the
    inverse CDF of ``probs_from_adjusted(adj)`` at ``keyed_uniform(key,
    row)``, drawn as ``spec_decode.accept_span`` draws its residual."""
    return _keyed_draw(probs_from_adjusted(adj), key, row)


def _keyed_draw(probs: np.ndarray, key: int, row: int) -> int:
    return int(np.searchsorted(np.cumsum(probs), keyed_uniform(key, row),
                               side="right").clip(0, len(probs) - 1))


def host_adjusted_logits(logits: torch.Tensor, temperature: float,
                         top_k: int, top_p: float) -> np.ndarray:
    """``adjusted_logits`` of rows (…, V) on the device, copied to the host
    once."""
    shape = logits.shape
    adj = adjusted_logits(logits.reshape(-1, shape[-1]), temperature, top_k,
                          top_p)
    return adj.reshape(shape).cpu().numpy()


def keyed_sample(logits: torch.Tensor, keys: Sequence[int],
                 rows: Sequence[int], temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0) -> np.ndarray:
    """Request-keyed sampling: row i of ``logits`` (b, V) draws
    ``keyed_categorical`` with ``(keys[i], rows[i])`` over its adjusted
    distribution. A token's randomness depends only on its request's key
    and its absolute row, never on its neighbours in the batch. Returns
    (b,) int64 on the host."""
    adj = host_adjusted_logits(logits, temperature, top_k, top_p)
    return np.asarray([keyed_categorical(a, int(k), int(r))
                       for a, k, r in zip(adj, keys, rows)], dtype=np.int64)


# splitmix64's odd constants as the int64s of the same bits (two's
# complement): an int64 product wraps mod 2**64, so the device computes
# _mix64's bits exactly
_GOLDEN = 0x9E3779B97F4A7C15 - (1 << 64)
_MIX1 = 0xBF58476D1CE4E5B9 - (1 << 64)
_MIX2 = 0x94D049BB133111EB - (1 << 64)


def as_int64(key: int) -> int:
    """A 64-bit key (an int in [0, 2**64), or any int mod 2**64) as the
    int64 of the same bits, for a device buffer."""
    key &= _MASK64
    return key - (1 << 64) if key >> 63 else key


def _srl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int64 ``x`` by ``n``: ``>>`` is arithmetic,
    so the sign's copies are masked off."""
    return (x >> n) & ((1 << (64 - n)) - 1)


def _mix64_device(x: torch.Tensor) -> torch.Tensor:
    """:func:`_mix64` on int64 tensors, bit for bit."""
    x = x + _GOLDEN
    x = (x ^ _srl(x, 30)) * _MIX1
    x = (x ^ _srl(x, 27)) * _MIX2
    return x ^ _srl(x, 31)


def keyed_uniform_device(keys: torch.Tensor,
                         rows: torch.Tensor) -> torch.Tensor:
    """:func:`keyed_uniform` of int64 ``keys`` and ``rows`` (same shape,
    keys as :func:`as_int64` gives them) on their device: float64, the top
    53 bits of ``fold_in(key, row)`` times 2**-53."""
    return _srl(_mix64_device(keys ^ _mix64_device(rows)),
                11).double() * 2.0 ** -53


def keyed_draw(adj: torch.Tensor, keys: torch.Tensor,
               rows: torch.Tensor) -> torch.Tensor:
    """Request-keyed sampling on the device: row i of adjusted logits
    ``adj`` (b, V) draws with ``(keys[i], rows[i])`` (int64 (b,) each), the
    inverse CDF of its float64 softmax at :func:`keyed_uniform_device`.
    Returns (b,) int64 on the device; its law is :func:`keyed_categorical`,
    the host's draw, which it equals wherever the uniform does not lie
    within a float64 rounding of an edge of the CDF (the card's ``exp``
    and sums may differ from numpy's in the last place). Reads nothing
    back to the host, so a CUDA graph holds it."""
    a = adj.double()
    q = torch.exp(a - a.amax(dim=-1, keepdim=True))
    cdf = torch.cumsum(q / q.sum(dim=-1, keepdim=True), dim=-1)
    u = keyed_uniform_device(keys, rows)
    return (cdf <= u[:, None]).sum(dim=-1).clamp_(max=adj.shape[-1] - 1)


@torch.no_grad()
def sample_position_keyed(params: Params, prompt: torch.Tensor,
                          cfg: ModelConfig, steps: int, key: int,
                          temperature: float = 1.0, top_k: int = 0,
                          top_p: float = 1.0) -> torch.Tensor:
    """``sample`` with the speculative-sampling key convention: the token
    that will occupy absolute row ``p`` is drawn with ``(key, p)``, so a
    re-proposed row never spends a new key and a perfect draft reproduces
    this stream exactly. ``key`` is an int; every row of a batch draws with
    it. Returns (b, steps + 1) tokens on the prompt's device."""
    params = cast_params_for_compute(params, cfg)
    b, s0 = prompt.shape
    cache = init_kv_cache(cfg, b, s0 + steps, device=prompt.device)
    logits, cache = prefill(params, cache, prompt, cfg)

    def draw(row_logits, row):
        toks = keyed_sample(row_logits, [key] * b, [row] * b, temperature,
                            top_k, top_p)
        return torch.from_numpy(toks).to(prompt.device)

    tok = draw(logits[:, s0 - 1], s0)
    toks = [tok]
    for t in range(steps):
        logits, cache = decode_step(params, cache, tok, s0 + t, cfg)
        tok = draw(logits, s0 + t + 1)
        toks.append(tok)
    return torch.stack(toks, dim=1)


# -- the speculative draft phase ------------------------------------------------

Pos = Union[int, np.ndarray, torch.Tensor]


def upload_pos(pos: Pos, device) -> Union[int, torch.Tensor]:
    """A cursor for ``score_span``: an int stays one (whole-batch slicing); a
    (b,) host array is checked and copied to ``device`` once. A negative row
    would not fail: advanced indexing takes -1 as the arena's LAST row,
    where the reference's dynamic_update_slice clamps to 0. So it is
    refused here, on the host, before any upload or write."""
    if isinstance(pos, torch.Tensor):
        return pos
    a = np.asarray(pos)
    if a.ndim == 0:
        return int(a)
    if (a < 0).any():
        raise ValueError(f"negative cache position in {a.tolist()}: it would "
                         f"write the arena's last rows")
    return torch.from_numpy(a.astype(np.int64)).to(device)


def draft_rollout(params: Params, cache: KVCache, feed: torch.Tensor,
                  pos: Pos, cfg: ModelConfig, k: int,
                  tp: Optional[Axis] = None, ep: Optional[Axis] = None,
                  fsdp: Optional[Axis] = None
                  ) -> Tuple[torch.Tensor, KVCache]:
    """Greedy draft rollout: ingest ``feed`` (b, p) at rows pos..pos+p-1,
    take the argmax of its last row, then propose k - 1 more tokens one
    ``score_span`` step at a time. The token chain stays on the device (no
    host read per step). ``pos`` is an int or a (b,) vector (host or
    device). Returns (proposals (b, k) on the device, cache)."""
    pos = upload_pos(pos, feed.device)
    logits, cache = score_span(params, cache, feed, pos, cfg, tp, ep, fsdp)
    tok = torch.argmax(logits[:, -1], dim=-1)
    toks = [tok]
    p = pos + feed.shape[1]
    for _ in range(k - 1):
        logits, cache = score_span(params, cache, tok[:, None], p, cfg, tp,
                                   ep, fsdp)
        tok = torch.argmax(logits[:, 0], dim=-1)
        toks.append(tok)
        p = p + 1
    return torch.stack(toks, dim=1), cache


def _adjusted_span(params: Params, cache: KVCache, tokens: torch.Tensor,
                   pos, cfg: ModelConfig, sampling: Tuple[float, int, float],
                   axes: Tuple = (None, None, None),
                   last: bool = True) -> torch.Tensor:
    """``score_span`` of ``tokens`` (b, n) at ``pos``, then
    ``adjusted_logits`` (``sampling``: temperature, top_k, top_p) on the
    device: of the last row, (b, V) f32, with ``last`` (a sampled draft's
    ingest and one-token step), else of every row, (b, n, V) (the sampled
    verify span). ``axes``: (tp, ep, fsdp) as in :func:`prefill`."""
    logits, _ = score_span(params, cache, tokens, pos, cfg, *axes)
    if last:
        return adjusted_logits(logits[:, -1], *sampling)
    b, n, vocab = logits.shape
    return adjusted_logits(logits.reshape(b * n, vocab), *sampling).reshape(
        b, n, vocab)


def _adjusted_span_program(params: Params, cache: KVCache, cfg: ModelConfig,
                           shape: Tuple[int, int],
                           sampling: Tuple[float, int, float], program,
                           axes: Tuple = (None, None, None),
                           last: bool = True) -> Program:
    """:func:`_adjusted_span` as a program (``program``: ``Program`` with
    its ``graphed`` and ``pool`` bound): ``tokens`` of ``shape`` (b, n) and
    ``pos`` (b,), the row of the first token, in; the adjusted logits
    out. The sampled speculative round's three programs: the draft's
    ingest and one-token step, and the verify span (``last=False``)."""
    device = cache[0]["k"].device
    tokens = torch.zeros(shape, dtype=torch.long, device=device)
    pos = torch.zeros(shape[0], dtype=torch.long, device=device)

    def body():
        return _adjusted_span(params, cache, tokens, pos, cfg, sampling,
                              axes, last)

    return program(body, {"tokens": tokens, "pos": pos})


def _keyed_proposals(adj: torch.Tensor, step, keys: Sequence[int],
                     rows: np.ndarray, k: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """The sampled draft's host loop: ``adj`` (b, V), the adjusted logits
    of the row the first proposal takes (``rows``, one a batch row), is
    read back, its float64 distribution drawn with ``(keys[i], rows[i] +
    j)`` for proposal j, and ``step(tokens (b,) int64, j)`` returns the
    adjusted logits after feeding proposal j. Returns (proposals (b, k)
    int64, their distributions (b, k, V) float64): k reads to the host."""
    toks, probs = [], []
    for i in range(k):
        q = probs_from_adjusted(adj.cpu().numpy())
        tok = np.asarray([_keyed_draw(qq, kk, int(r) + i)
                          for qq, kk, r in zip(q, keys, rows)],
                         dtype=np.int64)
        toks.append(tok)
        probs.append(q)
        if i < k - 1:
            adj = step(tok, i)
    return np.stack(toks, axis=1), np.stack(probs, axis=1)


def sampling_draft_rollout(params: Params, cache: KVCache,
                           feed: torch.Tensor, pos: Union[int, np.ndarray],
                           cfg: ModelConfig, k: int,
                           key: Union[int, Sequence[int]],
                           temperature: float = 1.0, top_k: int = 0,
                           top_p: float = 1.0, tp: Optional[Axis] = None,
                           ep: Optional[Axis] = None,
                           fsdp: Optional[Axis] = None
                           ) -> Tuple[np.ndarray, np.ndarray, KVCache]:
    """``draft_rollout``'s sampling sibling: ingest ``feed`` (b, p) at rows
    pos..pos+p-1, then propose k tokens, the one occupying row ``q`` drawn
    with ``(key, q)`` (``key`` an int, or one per batch row; ``pos`` an int
    or a (b,) host array). Returns (proposals (b, k) int64, proposal_probs
    (b, k, V) float64 — the ``probs_from_adjusted`` of the very adjusted
    logits each draw used, which the acceptance ratio divides by — and the
    cache). Each draw is made on the host, so each step reads one (b, V)
    row of adjusted logits back (:func:`_keyed_proposals`)."""
    b, n = feed.shape
    keys = [key] * b if isinstance(key, int) else [int(x) for x in key]
    rows = np.broadcast_to(np.asarray(pos, dtype=np.int64), (b,)) + n
    p = upload_pos(pos, feed.device)
    sampling = (temperature, top_k, top_p)

    def step(tok, i):
        return _adjusted_span(params, cache,
                              torch.from_numpy(tok).to(feed.device)[:, None],
                              p + n + i, cfg, sampling, (tp, ep, fsdp))

    toks, probs = _keyed_proposals(
        _adjusted_span(params, cache, feed, p, cfg, sampling, (tp, ep, fsdp)),
        step, keys, rows, k)
    return toks, probs, cache
