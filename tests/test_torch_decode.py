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


@pytest.mark.parametrize("attn", ["naive", "flash"])
def test_a_generation_keeps_its_step_across_calls(attn):
    """A ``Generation`` called on three prompts of its shape gives
    jaxbridge's greedy tokens each time from the one step program it
    built, and hands out copies that a later call leaves alone; a prompt
    of another shape is refused."""
    jcfg, jp, cfg, p = _model(attn, 2)
    gen = decode.Generation(p, cfg, 2, 9, 7, "cpu")
    step, got = gen.step, []
    for seed in (4, 5, 4):
        prompt = _tokens(seed, (2, 9))
        got.append(gen(torch.from_numpy(prompt).long()))
        ref = jdec.generate(jp, jnp.asarray(prompt), jcfg, steps=7)
        np.testing.assert_array_equal(got[-1].numpy(), np.asarray(ref))
        assert gen.step is step
    np.testing.assert_array_equal(got[0].numpy(), got[2].numpy())
    with pytest.raises(ValueError, match="shape"):
        gen(torch.from_numpy(_tokens(4, (2, 8))).long())


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


SAMPLINGS = [dict(temperature=1.0), dict(temperature=0.7, top_k=5),
             dict(temperature=1.3, top_p=0.8),
             dict(temperature=0.9, top_k=40, top_p=0.5)]


@pytest.mark.parametrize("kw", SAMPLINGS, ids=["plain", "top_k", "top_p",
                                               "both"])
def test_written_out_draw_equals_multinomial(kw):
    """``sample_token`` draws by the exponential race written out, which is
    how ``torch.multinomial(probs, 1)`` draws: 64 draws from one seeded
    generator equal multinomial's from another seeded alike, and both
    generators end in the same state."""
    logits = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (4, 256)).astype(np.float32) * 3)
    g1, g2 = (torch.Generator().manual_seed(21) for _ in range(2))
    probs = torch.softmax(decode.adjusted_logits(logits, **{
        "top_k": 0, "top_p": 1.0, **kw}), dim=-1)
    for _ in range(64):
        assert torch.equal(decode.sample_token(logits, g1, **kw),
                           torch.multinomial(probs, 1, generator=g2)[:, 0])
    assert torch.equal(g1.get_state(), g2.get_state())


@pytest.mark.parametrize("bad", [float("nan"), float("inf")])
def test_sample_token_refuses_logits_that_are_not_finite(bad):
    """``torch.multinomial`` refused a distribution with a NaN; the
    written-out draw keeps that refusal (an assert on the device, which
    raises on the CPU) instead of returning argmax's token."""
    logits = torch.zeros((2, 16))
    logits[1, 3] = bad
    with pytest.raises(RuntimeError, match="not finite"):
        decode.sample_token(logits, torch.Generator().manual_seed(0), 1.0)


@pytest.mark.parametrize("kw", SAMPLINGS[:2], ids=["plain", "top_k"])
def test_sampled_sample_program_equals_eager_steps(kw):
    """``sample`` at temperature > 0 replays one step program a token
    (its body here): the tokens of the eager loop it replaced (prefill,
    then ``decode_step`` at an int cursor and one ``torch.multinomial``
    draw a step) from the same seed, bit for bit."""
    _, _, cfg, p = _model(seed=2)
    prompt = torch.from_numpy(_tokens(8, (3, 6))).long()
    got = decode.sample(p, prompt, cfg, 9, torch.Generator().manual_seed(5),
                        **kw)
    gen = torch.Generator().manual_seed(5)
    sampling = {"top_k": 0, "top_p": 1.0, **kw}

    def draw(logits):
        probs = torch.softmax(decode.adjusted_logits(logits, **sampling), -1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]

    with torch.no_grad():
        cache = decode.init_kv_cache(cfg, 3, 15, "cpu")
        logits, cache = decode.prefill(p, cache, prompt, cfg)
        toks = [draw(logits[:, 5])]
        for t in range(9):
            logits, cache = decode.decode_step(p, cache, toks[-1], 6 + t,
                                               cfg)
            toks.append(draw(logits))
    assert torch.equal(got, torch.stack(toks, dim=1))


def _quant_inputs() -> np.ndarray:
    """Seeded (b, s, kv, hd) rows and the edge cases of the quantizer: an
    all-zero row (the 1e-8/127 scale floor), a row below the floor, and
    rows whose max|x| is 127 (scale exactly 1) with every other value on a
    .5 boundary, of both signs, where half-to-even rounding shows."""
    rng = np.random.default_rng(12)
    x = (rng.standard_normal((2, 6, 2, 32)) * 3).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 1, 1] = 1e-12 * rng.standard_normal(32)
    halves = np.arange(-15.5, 15.5, 1.0, dtype=np.float32)       # 31 values
    x[1, 0, 0] = np.concatenate([[127.0], halves])
    x[1, 0, 1] = np.concatenate([[-127.0], -halves])
    return x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_matches_reference(dtype):
    """int8 values equal the reference's, but for a value one level apart
    where x/scale sits within 1e-5 of a .5 boundary (none expected; at most
    0.1% allowed); scales within 1e-6 relative."""
    x = _quant_inputs()
    jq, js = jdec._quantize_kv(jnp.asarray(x, dtype=getattr(jnp, dtype)))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    q, s = decode._quantize_kv(xt)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == x.shape and s.shape == x.shape[:3]
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    diff = q.numpy().astype(np.int32) - np.asarray(jq).astype(np.int32)
    ratio = (xt.float() / s[..., None]).numpy()
    tie = np.abs(np.abs(ratio) % 1.0 - 0.5) < 1e-5
    assert np.abs(diff).max() <= 1 and not (diff != 0)[~tie].any()
    assert (diff != 0).mean() <= 1e-3
    # the floor is on max|x| before the division, not on the scale
    assert s[0, 0, 0].item() == np.float32(np.float32(1e-8) / np.float32(127))
    assert s[0, 1, 1].item() == s[0, 0, 0].item()
    assert not q[0, 0, 0].any() and not q[0, 1, 1].any()
    # half to even, clipped at ±127: the row max lands on the clip's edge
    np.testing.assert_array_equal(q[1, 0].numpy(), np.round(x[1, 0]))
    assert q[1, 0, 0, 0] == 127 and q[1, 0, 1, 0] == -127
    assert int(q.abs().max()) == 127


def test_int8_cache_layout_and_prefill():
    """int8 values plus f32 scale planes per (row, KV head), under 0.6 of
    the exact cache's bytes; prefill attends the fresh K/V, so its logits
    equal the exact cache's, and its quantized rows are the reference's
    (values one level apart on a near-tie at most, 0.5% allowed)."""
    jcfg, jp, cfg, p = _model(n_kv_heads=1)
    jcfg8 = dataclasses.replace(jcfg, kv_cache_dtype="int8")
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    c8 = decode.init_kv_cache(cfg8, 2, 20, "cpu")
    ce = decode.init_kv_cache(cfg, 2, 20, "cpu")
    assert set(c8[0]) == {"k", "v", "ks", "vs"} and len(c8) == cfg.n_layers
    assert c8[0]["k"].dtype == torch.int8
    assert c8[0]["ks"].dtype == torch.float32
    assert c8[0]["k"].shape == (2, 20, cfg.kv_heads, cfg.head_dim)
    assert c8[0]["ks"].shape == (2, 20, cfg.kv_heads)

    def nbytes(t):
        return t.numel() * t.element_size()
    assert nbytes(c8[0]["k"]) + nbytes(c8[0]["ks"]) < 0.6 * nbytes(ce[0]["k"])
    prompt = _tokens(1, (2, 12))
    l8, c8 = decode.prefill(p, c8, torch.from_numpy(prompt).long(), cfg8)
    le, _ = decode.prefill(p, ce, torch.from_numpy(prompt).long(), cfg)
    assert torch.equal(l8, le)
    jl8, jc8 = jdec.prefill(jp, jdec.init_kv_cache(jcfg8, 2, 20),
                            jnp.asarray(prompt), jcfg8)
    _close(l8.numpy(), jl8)
    for jlayer, layer in zip(jc8, c8):
        for name in ("ks", "vs"):
            np.testing.assert_allclose(layer[name].numpy(),
                                       np.asarray(jlayer[name]), rtol=1e-5)
        for name in ("k", "v"):
            diff = (layer[name].numpy().astype(np.int32)
                    - np.asarray(jlayer[name]).astype(np.int32))
            assert np.abs(diff).max() <= 1 and (diff != 0).mean() <= 5e-3


def test_cache_kv_bf16_dequant_matches_reference():
    """The scale is cast to bf16 before the multiply, as in the reference;
    the f32 product rounded once is another function on these inputs. An
    exact entry comes back as it is."""
    rng = np.random.default_rng(13)
    q = rng.integers(-127, 128, (2, 5, 2, 16)).astype(np.int8)
    s = (rng.random((2, 5, 2)) * 0.05 + 1e-3).astype(np.float32)
    jk, jv = jdec.cache_kv({"k": jnp.asarray(q), "v": jnp.asarray(-q),
                            "ks": jnp.asarray(s), "vs": jnp.asarray(2 * s)},
                           jnp.bfloat16)
    entry = {"k": torch.from_numpy(q), "v": torch.from_numpy(-q),
             "ks": torch.from_numpy(s), "vs": torch.from_numpy(2 * s)}
    k, v = decode.cache_kv(entry, torch.bfloat16)
    assert k.dtype == v.dtype == torch.bfloat16
    np.testing.assert_array_equal(k.float().numpy(),
                                  np.asarray(jk.astype(jnp.float32)))
    np.testing.assert_array_equal(v.float().numpy(),
                                  np.asarray(jv.astype(jnp.float32)))
    once = (entry["k"].float() * entry["ks"][..., None]).to(torch.bfloat16)
    assert not torch.equal(once, k)
    exact = {"k": k, "v": v}
    assert all(a is b for a, b in zip(decode.cache_kv(exact, torch.float32),
                                      (k, v)))


def test_int8_generate_matches_reference_and_tracks_exact():
    """Greedy generation over an int8 cache: token for token the
    reference's int8 generate, and at least 0.8 agreement with exact
    generate (the reference's own law)."""
    jcfg, jp, cfg, p = _model()
    jcfg8 = dataclasses.replace(jcfg, kv_cache_dtype="int8")
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    prompt = _tokens(1, (2, 12))
    got = decode.generate(p, torch.from_numpy(prompt).long(), cfg8, steps=24)
    ref = np.asarray(jdec.generate(jp, jnp.asarray(prompt), jcfg8, steps=24))
    np.testing.assert_array_equal(got.numpy(), ref)
    exact = decode.generate(p, torch.from_numpy(prompt).long(), cfg, steps=24)
    assert (got == exact).float().mean().item() >= 0.8


# -- generate over tensor-parallel shards -------------------------------------

TP_CASES = {  # name -> (config changes, prompts seed, steps, temperature)
    "exact": ({}, 21, 6, 0.0),
    "int8": (dict(kv_cache_dtype="int8"), 23, 6, 0.0),
    "sampled": ({}, 25, 6, 0.9),
}


def _tp_case(name):
    changes, seed, steps, temperature = TP_CASES[name]
    jcfg = dataclasses.replace(jwl.ModelConfig.tiny(), **changes)
    cfg = dataclasses.replace(wl.ModelConfig.tiny(), **changes)
    jp = jwl.init_params(jax.random.PRNGKey(seed), jcfg)
    return (jcfg, jp, cfg, jax.tree.map(np.asarray, jp),
            _tokens(seed, (2, 12)), steps, temperature)


@pytest.fixture(scope="module")
def tp_generated(tmp_path_factory):
    """Every case on two gloo ranks at tp = 2 (``torch_ranks.
    generate_rank``), both ranks' tokens."""
    import torch_ranks
    from tpusched_torch import mesh as tmesh
    cases = {}
    for name in TP_CASES:
        _, _, cfg, tree, prompt, steps, temperature = _tp_case(name)
        cases[name] = (cfg, tree, prompt, steps, temperature)
    return tmesh.launch(torch_ranks.generate_rank, {"tp": 2}, cases,
                        backend="gloo", device="cpu",
                        workdir=str(tmp_path_factory.mktemp("ranks")))


@pytest.mark.parametrize("name", ["exact", "int8"])
def test_tp_generate_matches_reference_jitted_tp_generate(tp_generated,
                                                          name):
    """``generate(tp=)`` over tp = 2 shards, exact and with an int8 cache,
    emits jaxbridge's tokens from ``jax.jit(generate)`` on tp-sharded
    params on a tp = 2 mesh of virtual CPU devices (the reference dryrun's
    tp-int8kv block), on both ranks."""
    import functools
    from jax.sharding import Mesh as JMesh, NamedSharding
    from jax.sharding import PartitionSpec as P
    jcfg, jp, _, _, prompt, steps, _ = _tp_case(name)
    mesh = JMesh(np.array(jax.devices()[:2]), ("tp",))
    shardings = jax.tree_util.tree_map(
        lambda spec: NamedSharding(mesh, spec), jwl.param_specs(jcfg, mesh),
        is_leaf=lambda x: isinstance(x, P))
    gen = jax.jit(functools.partial(jdec.generate, cfg=jcfg, steps=steps))
    with mesh:
        want = np.asarray(gen(jax.device_put(jp, shardings),
                              jnp.asarray(prompt))).tolist()
    for rank in tp_generated:
        assert rank[name] == want


def test_tp_sample_draws_rank_zero_token(tp_generated):
    """Sampling at tp = 2 with each rank's generator seeded differently:
    both ranks feed and return tp rank 0's draws (broadcast), which equal
    the unsharded sampler's with rank 0's seed."""
    _, _, cfg, tree, prompt, steps, temperature = _tp_case("sampled")
    a, b = tp_generated[0]["sampled"], tp_generated[1]["sampled"]
    assert a == b
    whole = decode.sample(interop.params_from_numpy(tree, cfg, "cpu"),
                          torch.from_numpy(prompt).long(), cfg, steps,
                          torch.Generator().manual_seed(100), temperature)
    assert a == whole.tolist()
