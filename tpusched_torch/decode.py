"""KV-cache inference: prefill, single-token decode, sampling, generation.

Counterpart of ``tpusched/jaxbridge/decode.py``. One (b, max_seq, kv_heads,
head_dim) K and V per layer, exact or (``cfg.kv_cache_dtype="int8"``) int8
with one f32 scale per (row, KV head) in planes ``ks``/``vs``; queries
attend the cache through a position mask. Unlike the reference, whose
arrays are immutable, the cache is written IN PLACE: ``cache_update`` and
every function that takes a cache mutate it and return the same object.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from . import attention
from .workload import (ModelConfig, Params, _as_pos_vec, _finish_block,
                       _qkv, _resolve_attn_fn, _rmsnorm,
                       cast_params_for_compute, resolve_device)

KVCache = List[Dict[str, torch.Tensor]]


def init_kv_cache(cfg: ModelConfig, batch: int, max_seq: int,
                  device=None) -> KVCache:
    """Zeroed cache, one entry per layer: ``k``/``v`` (batch, max_seq,
    kv_heads, head_dim) in ``cfg.dtype``, or int8 with f32 scale planes
    ``ks``/``vs`` (batch, max_seq, kv_heads) when ``cfg.kv_cache_dtype`` is
    "int8" (half the bytes a decode step streams for the cache)."""
    device = resolve_device(device)
    shape = (batch, max_seq, cfg.kv_heads, cfg.head_dim)
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


def _cache_write(cache: torch.Tensor, new: torch.Tensor, pos) -> None:
    """Write ``new`` (b, n, ...) into ``cache`` IN PLACE at sequence offset
    ``pos``: a scalar (the whole batch aligned) or a (b,) vector (each row
    at its own offset). Any rank past (batch, seq), so the int8 scale
    planes (b, s, kv) take the path of the values. Rows must fit: unlike
    the reference's dynamic_update_slice, which clamps an out-of-range
    start, plain indexing raises; the serving engine's guards keep every
    write in range."""
    n = new.shape[1]
    off = torch.as_tensor(pos)
    if off.ndim == 0:
        p = int(off)
        cache[:, p:p + n] = new
        return
    off = off.to(cache.device)
    rows = off[:, None] + torch.arange(n, device=cache.device)[None, :]
    batch = torch.arange(cache.shape[0], device=cache.device)[:, None]
    cache[batch, rows] = new


def cache_update(c: Dict[str, torch.Tensor], k: torch.Tensor,
                 v: torch.Tensor, pos) -> Dict[str, torch.Tensor]:
    """Write fresh K/V rows into the cache entry at ``pos``, in place,
    quantized when the entry is int8; the one write path of decode, prefill
    and span scoring."""
    if "ks" in c:
        k, ks = _quantize_kv(k)
        v, vs = _quantize_kv(v)
        _cache_write(c["ks"], ks, pos)
        _cache_write(c["vs"], vs, pos)
    _cache_write(c["k"], k, pos)
    _cache_write(c["v"], v, pos)
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
    """q (b, s_q, h, hd) against the GQA cache up to ``pos + s_q - 1``; later
    rows are masked with the finite NEG_INF, so an idle slot decoding at a
    stale cursor stays finite. The group axis is folded, never expanded."""
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
                  cfg: ModelConfig) -> torch.Tensor:
    h = _rmsnorm(x, layer["ln_attn"])
    q, k, v = _qkv(h, layer, cfg, pos_offset=pos)
    cache_update(c, k, v, pos)
    ck, cv = cache_kv(c, q.dtype)
    o = _cached_attention(q, ck, cv, pos, cfg.n_heads // cfg.kv_heads)
    # dropless: a decoded token's MoE output depends on that token alone
    return _finish_block(x, layer, o, cfg, dropless=True)[0]


def _layer_prefill(x: torch.Tensor, layer: Dict[str, torch.Tensor], c,
                   cfg: ModelConfig, attn_fn) -> torch.Tensor:
    """Prefill layer: attention over the prompt through the configured
    implementation (the flash kernel when cfg.attn == 'flash'), K/V
    recorded into the cache from position 0. Attention takes the FRESH
    K/V, so an int8 cache's error enters only at later cached reads."""
    h = _rmsnorm(x, layer["ln_attn"])
    q, k, v = _qkv(h, layer, cfg)
    cache_update(c, k, v, 0)
    return _finish_block(x, layer, attn_fn(q, k, v), cfg, dropless=True)[0]


def prefill(params: Params, cache: KVCache, tokens: torch.Tensor,
            cfg: ModelConfig) -> Tuple[torch.Tensor, KVCache]:
    """Run the prompt (b, s), filling the cache from position 0. Returns
    (logits (b, s, vocab), cache)."""
    params = cast_params_for_compute(params, cfg)
    x = params["embed"][tokens]
    attn_fn = _resolve_attn_fn(cfg)
    for layer, c in zip(params["layers"], cache):
        x = _layer_prefill(x, layer, c, cfg, attn_fn)
    x = _rmsnorm(x, params["ln_f"])
    return x @ params["out"], cache


def score_span(params: Params, cache: KVCache, tokens: torch.Tensor, pos,
               cfg: ModelConfig) -> Tuple[torch.Tensor, KVCache]:
    """Teacher-force ``tokens`` (b, n) at positions pos..pos+n-1 (``pos``
    scalar or (b,)): returns (logits (b, n, vocab), cache)."""
    params = cast_params_for_compute(params, cfg)
    x = params["embed"][tokens]
    for layer, c in zip(params["layers"], cache):
        x = _layer_decode(x, layer, c, pos, cfg)
    x = _rmsnorm(x, params["ln_f"])
    return x @ params["out"], cache


def decode_step(params: Params, cache: KVCache, tokens_t: torch.Tensor, pos,
                cfg: ModelConfig) -> Tuple[torch.Tensor, KVCache]:
    """One token per sequence, tokens_t (b,), at ``pos`` (scalar or (b,)).
    Returns (logits (b, vocab), cache)."""
    logits, cache = score_span(params, cache, tokens_t[:, None], pos, cfg)
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
    distribution with the given generator; temperature 0 is argmax."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    if generator is None:
        raise ValueError("sampling at temperature > 0 needs a generator")
    probs = torch.softmax(adjusted_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def sample(params: Params, prompt: torch.Tensor, cfg: ModelConfig,
           steps: int, generator: Optional[torch.Generator] = None,
           temperature: float = 1.0, top_k: int = 0,
           top_p: float = 1.0) -> torch.Tensor:
    """Prefill the prompt (b, s0), then ``steps`` sampled decode steps.
    Returns (b, steps + 1) tokens; temperature 0 is greedy ``generate``."""
    params = cast_params_for_compute(params, cfg)
    b, s0 = prompt.shape
    cache = init_kv_cache(cfg, b, s0 + steps, device=prompt.device)
    logits, cache = prefill(params, cache, prompt, cfg)
    tok = sample_token(logits[:, s0 - 1], generator, temperature, top_k,
                       top_p)
    toks = [tok]
    for t in range(steps):
        logits, cache = decode_step(params, cache, tok, s0 + t, cfg)
        tok = sample_token(logits, generator, temperature, top_k, top_p)
        toks.append(tok)
    return torch.stack(toks, dim=1)


def generate(params: Params, prompt: torch.Tensor, cfg: ModelConfig,
             steps: int) -> torch.Tensor:
    """Greedy generation: ``sample`` at temperature 0."""
    return sample(params, prompt, cfg, steps, temperature=0.0)
