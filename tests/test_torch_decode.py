"""tpusched_torch.decode against tpusched.jaxbridge.decode on the CPU:
prefill, cached decode steps, greedy generation and the sampling filters,
with the JAX weights carried across through interop."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusched.jaxbridge import decode as jdec, workload as jwl
from tpusched_torch import decode, interop, workload as wl

torch.set_num_threads(1)


def _model(attn="naive", n_kv_heads=1, seed=0):
    jcfg = dataclasses.replace(jwl.ModelConfig.tiny(), attn=attn,
                               n_kv_heads=n_kv_heads)
    cfg = dataclasses.replace(wl.ModelConfig.tiny(), attn=attn,
                              n_kv_heads=n_kv_heads)
    jp = jwl.init_params(jax.random.PRNGKey(seed), jcfg)
    p = interop.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, jp, cfg, p


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _close(got, ref, rel=1e-4):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-6))


def _prefilled(jcfg, jp, cfg, p, prompt, max_seq):
    b = prompt.shape[0]
    jl, jc = jdec.prefill(jp, jdec.init_kv_cache(jcfg, b, max_seq),
                          jnp.asarray(prompt), jcfg)
    pl, pc = decode.prefill(p, decode.init_kv_cache(cfg, b, max_seq, "cpu"),
                            torch.from_numpy(prompt).long(), cfg)
    return jl, jc, pl, pc


@pytest.mark.parametrize("attn", ["naive", "flash"])
def test_prefill_matches_reference(attn):
    jcfg, jp, cfg, p = _model(attn)
    prompt = _tokens(1, (2, 12))
    jl, jc, pl, pc = _prefilled(jcfg, jp, cfg, p, prompt, 20)
    _close(pl.numpy(), jl)
    for jlayer, layer in zip(jc, pc):
        for name in ("k", "v"):
            _close(layer[name].numpy(), jlayer[name], rel=1e-5)


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per-row"])
def test_decode_step_matches_reference(per_row):
    """Two decode steps after a prefill, at one aligned position or at a
    (b,) vector of per-row positions (continuous batching)."""
    jcfg, jp, cfg, p = _model()
    prompt = _tokens(2, (3, 8))
    jl, jc, pl, pc = _prefilled(jcfg, jp, cfg, p, prompt, 16)
    tok = _tokens(3, (3,))
    pos = np.array([8, 5, 7], np.int32) if per_row else 8
    for _ in range(2):
        jlog, jc = jdec.decode_step(jp, jc, jnp.asarray(tok),
                                    jnp.asarray(pos), jcfg)
        plog, pc = decode.decode_step(p, pc, torch.from_numpy(tok).long(),
                                      torch.as_tensor(pos), cfg)
        _close(plog.numpy(), jlog)
        for jlayer, layer in zip(jc, pc):
            _close(layer["k"].numpy(), jlayer["k"], rel=1e-5)
        tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
        pos = pos + 1


def test_cache_write_is_in_place():
    cache = torch.zeros(2, 6, 1, 2)
    new = torch.ones(2, 2, 1, 2)
    decode._cache_write(cache, new, torch.tensor([0, 3]))
    assert cache[0, :2].eq(1).all() and cache[1, 3:5].eq(1).all()
    assert int(cache.sum()) == 8
    decode._cache_write(cache, 2 * new, 4)
    assert cache[:, 4:6].eq(2).all()
    entry = {"k": cache, "v": cache.clone()}
    assert decode.cache_update(entry, new, new, 0) is entry


@pytest.mark.parametrize("attn", ["naive", "flash"])
@pytest.mark.parametrize("n_kv_heads", [0, 1], ids=["mha", "gqa"])
def test_generate_greedy_tokens_equal_reference(attn, n_kv_heads):
    jcfg, jp, cfg, p = _model(attn, n_kv_heads)
    prompt = _tokens(4, (2, 9))
    ref = np.asarray(jdec.generate(jp, jnp.asarray(prompt), jcfg, steps=7))
    got = decode.generate(p, torch.from_numpy(prompt).long(), cfg, steps=7)
    assert got.shape == (2, 8)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 5, 1.0), (1.3, 0, 0.8), (0.9, 40, 0.5),
    (1.0, 0, 0.0), (1.0, 256, 0.999)])
def test_adjusted_logits_match_reference(temperature, top_k, top_p):
    logits = np.random.default_rng(5).standard_normal((3, 256)).astype(
        np.float32) * 3
    ref = np.asarray(jdec.adjusted_logits(jnp.asarray(logits), temperature,
                                          top_k, top_p))
    got = decode.adjusted_logits(torch.from_numpy(logits), temperature,
                                 top_k, top_p).numpy()
    np.testing.assert_array_equal(got <= -1e38, ref <= -1e38)
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_sampling_laws():
    logits = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (4, 256)).astype(np.float32))
    # temperature 0 is argmax, and needs no generator
    assert torch.equal(decode.sample_token(logits, None, 0.0),
                       logits.argmax(-1))

    def draws(seed, **kw):
        g = torch.Generator().manual_seed(seed)
        return torch.stack([decode.sample_token(logits, g, **kw)
                            for _ in range(64)])

    # a fixed generator is deterministic; another seed draws differently
    assert torch.equal(draws(1), draws(1))
    assert not torch.equal(draws(1), draws(2))
    # top-k: every draw lies in its row's k largest
    top = logits.topk(5, dim=-1).indices
    d = draws(3, top_k=5)
    assert all(bool(torch.isin(d[:, r], top[r]).all()) for r in range(4))
    # top_p == 0 keeps rank 0 alone: near-greedy, never mask-everything
    assert (draws(4, top_p=0.0) == logits.argmax(-1)).all()
    with pytest.raises(ValueError, match="generator"):
        decode.sample_token(logits, None, 1.0)


def test_sample_is_deterministic_per_generator():
    _, _, cfg, p = _model()
    prompt = torch.from_numpy(_tokens(7, (2, 5))).long()

    def run(seed):
        return decode.sample(p, prompt, cfg, 6,
                             torch.Generator().manual_seed(seed),
                             temperature=0.8, top_k=20)

    a = run(11)
    assert a.shape == (2, 7) and torch.equal(a, run(11))
    assert ((a >= 0) & (a < cfg.vocab)).all()
    greedy = decode.sample(p, prompt, cfg, 6, temperature=0.0)
    assert torch.equal(greedy, decode.generate(p, prompt, cfg, 6))


def test_int8_cache_is_not_ported_yet():
    cfg = dataclasses.replace(wl.ModelConfig.tiny(), kv_cache_dtype="int8")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        decode.init_kv_cache(cfg, 1, 8, "cpu")
