"""tpusched_torch.serve on the CPU. The load-bearing law, as for the
reference engine (tests/test_serve.py): continuous batching gives every
request exactly the tokens it gets alone — here held three ways, the port's
engine == the port's solo generate == the JAX reference's generate (or the
reference's engine, whose solo parity tests/test_serve.py pins), for
monolithic, chunked, prefix-cached and int8 admission alike."""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusched.jaxbridge import decode as jdec, serve as jserve
from tpusched.jaxbridge import workload as jwl
from tpusched_torch import decode, interop, serve, workload as wl
from tpusched_torch.program import Program
from tpusched_torch.serve import Request, ServeEngine, measure_serving

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model():
    cfg = wl.ModelConfig.tiny()
    return cfg, wl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _prompt(rng, lo, hi, vocab):
    return rng.integers(0, vocab, size=rng.integers(lo, hi), dtype=np.int32)


def _solo_full(params, cfg, prompt, n):
    return decode.generate(params, torch.from_numpy(prompt)[None].long(), cfg,
                           steps=n - 1)[0].numpy()


def _solo(params, cfg, req):
    return _solo_full(params, cfg, req.prompt, req.max_new_tokens)


@pytest.mark.parametrize("attn", ["naive", "flash"])
@pytest.mark.parametrize("seed", [5, 23, 404])
def test_engine_matches_solo_and_reference(seed, attn):
    """Mixed prompt and generation lengths through a 3-slot engine: every
    completion equals the port's generate alone and the reference's."""
    jcfg = dataclasses.replace(jwl.ModelConfig.tiny(), attn=attn)
    cfg = dataclasses.replace(wl.ModelConfig.tiny(), attn=attn)
    jp = jwl.init_params(jax.random.PRNGKey(seed), jcfg)
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                       "cpu")
    rng = np.random.default_rng(seed)
    reqs = [Request(rid=i, prompt=_prompt(rng, 3, 17, cfg.vocab),
                    max_new_tokens=int(rng.integers(2, 9)))
            for i in range(5)]
    eng = ServeEngine(params, cfg, slots=3, max_seq=64, prompt_bucket=24,
                      device="cpu")
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    assert sorted(c.rid for c in done) == list(range(5))
    for c in done:
        req = reqs[c.rid]
        ref = np.asarray(jdec.generate(jp, jnp.asarray(req.prompt)[None],
                                       jcfg, steps=req.max_new_tokens - 1))[0]
        np.testing.assert_array_equal(c.tokens, ref)
        np.testing.assert_array_equal(c.tokens, _solo(params, cfg, req))


def test_mid_flight_admission_fills_freed_slots(model):
    cfg, params = model
    rng = np.random.default_rng(7)
    reqs = [Request(rid=0, prompt=_prompt(rng, 4, 8, cfg.vocab),
                    max_new_tokens=24)]
    reqs += [Request(rid=i, prompt=_prompt(rng, 4, 8, cfg.vocab),
                     max_new_tokens=3) for i in range(1, 6)]
    eng = ServeEngine(params, cfg, slots=2, max_seq=64, prompt_bucket=16,
                      device="cpu")
    for r in reqs:
        eng.submit(r)
    by_rid = {c.rid: c for c in eng.run_until_drained()}
    hog_finish = by_rid[0].finished_tick
    for i in range(2, 6):
        assert by_rid[i].admitted_tick >= by_rid[i - 1].finished_tick
    assert by_rid[1].finished_tick < hog_finish
    assert by_rid[5].admitted_tick < hog_finish
    for r in reqs:
        np.testing.assert_array_equal(by_rid[r.rid].tokens,
                                      _solo(params, cfg, r))


def test_eos_ends_generation_early(model):
    cfg, params = model
    rng = np.random.default_rng(11)
    req = Request(rid=0, prompt=_prompt(rng, 5, 9, cfg.vocab),
                  max_new_tokens=20)
    solo = _solo(params, cfg, req)
    eos = int(solo[2])
    first = int(np.argmax(solo == eos))     # the first time greedy emits it
    eng = ServeEngine(params, cfg, slots=2, max_seq=64, prompt_bucket=16,
                      device="cpu")
    eng.submit(dataclasses.replace(req, eos_token=eos))
    [done] = eng.run_until_drained()
    np.testing.assert_array_equal(done.tokens, solo[:first + 1])


def test_submit_validates_bounds(model):
    cfg, params = model
    eng = ServeEngine(params, cfg, slots=1, max_seq=32, prompt_bucket=8,
                      device="cpu")
    with pytest.raises(ValueError, match="bucket"):
        eng.submit(Request(rid=0, prompt=np.zeros(9, np.int32),
                           max_new_tokens=1))
    with pytest.raises(ValueError, match="max_seq"):
        eng.submit(Request(rid=0, prompt=np.zeros(8, np.int32),
                           max_new_tokens=25))
    with pytest.raises(ValueError, match="max_new_tokens"):
        eng.submit(Request(rid=0, prompt=np.zeros(8, np.int32),
                           max_new_tokens=0))
    with pytest.raises(ValueError, match="at least one token"):
        eng.submit(Request(rid=0, prompt=np.zeros(0, np.int32),
                           max_new_tokens=1))
    with pytest.raises(ValueError, match="generation room"):
        ServeEngine(params, cfg, slots=1, max_seq=16, prompt_bucket=16,
                    device="cpu")


def test_prompt_goes_to_smallest_fitting_bucket(model, monkeypatch):
    cfg, params = model
    padded = []
    real = Program.__call__

    def spy(self, **values):
        if "true_len" in values:             # a slot prefill program
            padded.append((len(values["prompt"]), int(values["true_len"])))
        return real(self, **values)

    monkeypatch.setattr(Program, "__call__", spy)
    eng = ServeEngine(params, cfg, slots=2, max_seq=64,
                      prompt_bucket=(16, 8, 32), device="cpu")
    assert eng.prompt_buckets == (8, 16, 32)
    for n in (3, 8, 9, 20):
        eng.submit(Request(rid=n, prompt=np.ones(n, np.int32),
                           max_new_tokens=2))
    eng.run_until_drained()
    assert sorted(padded) == [(8, 3), (8, 8), (16, 9), (32, 20)]
    assert eng.prefills == 4


def test_warmup_runs_every_bucket_and_resets_metrics(model):
    cfg, params = model
    eng = ServeEngine(params, cfg, slots=2, max_seq=64,
                      prompt_bucket=(8, 16), device="cpu")
    eng.warmup()
    assert eng.prefills == 2
    assert (eng.completions, eng.tick_count, eng.decode_tokens) == ([], 0, 0)


def test_measure_serving_reports_occupancy(model):
    cfg, params = model
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=_prompt(rng, 3, 9, cfg.vocab),
                    max_new_tokens=int(rng.integers(2, 7)))
            for i in range(6)]
    out = measure_serving(cfg, params, reqs, slots=2, max_seq=48,
                          prompt_bucket=16, device="cpu")
    assert out["tokens"] == sum(r.max_new_tokens for r in reqs)
    assert 0 < out["occupancy"] <= 1.0
    assert out["tokens_per_s"] > 0 and out["max_tick_gap_s"] > 0
    assert out["prefills"] == len(reqs) + 1          # + warmup's one bucket


def test_sampled_engine_is_seeded(model):
    cfg, params = model
    rng = np.random.default_rng(8)
    reqs = [Request(rid=i, prompt=_prompt(rng, 3, 9, cfg.vocab),
                    max_new_tokens=5) for i in range(3)]

    def run(seed):
        eng = ServeEngine(params, cfg, slots=2, max_seq=32, prompt_bucket=8,
                          temperature=0.9, top_k=16, seed=seed, device="cpu")
        for r in reqs:
            eng.submit(r)
        return {c.rid: c.tokens.tolist() for c in eng.run_until_drained()}

    assert run(1) == run(1)
    assert run(1) != run(2)


@pytest.mark.parametrize("option,error,match", [
    (dict(draft_params=None, draft_cfg=wl.ModelConfig.tiny()), ValueError,
     "draft_cfg without draft_params"),
    (dict(draft_cfg=None), ValueError, "draft_params requires draft_cfg"),
    (dict(request_keyed=True, temperature=0.0), ValueError,
     "needs temperature > 0")], ids=["option1", "option2", "option3"])
def test_options_the_reference_refuses_raise(model, option, error, match):
    """Every option is ported: meshes over tp (tests/test_torch_tp_serve.py),
    ep (tests/test_torch_ep.py) and fsdp, sp and pp
    (tests/test_torch_serve_mesh.py), speculation and request-keyed
    sampling (tests/test_torch_serve_spec.py). What is refused is what the
    reference refuses: a draft config without its weights, weights without
    their config, keyed sampling at temperature 0."""
    cfg, params = model
    option = {"draft_params": params, **option}
    with pytest.raises(error, match=match):
        ServeEngine(params, cfg, slots=1, max_seq=32, prompt_bucket=8,
                    device="cpu", **option)


def test_engine_needs_a_device(model, monkeypatch):
    cfg, params = model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(params, cfg, slots=1, max_seq=32, prompt_bucket=8)
    meta = {**params, "embed": params["embed"].to("meta")}
    with pytest.raises(ValueError, match="params are on meta"):
        ServeEngine(meta, cfg, slots=1, max_seq=32, prompt_bucket=8,
                    device="cpu")


# -- chunked prefill, prefix caching and the int8 arena -----------------------


def _pair(seed=0, **changes):
    """The reference's tiny model and the port's, with the same weights."""
    jcfg = dataclasses.replace(jwl.ModelConfig.tiny(), **changes)
    cfg = dataclasses.replace(wl.ModelConfig.tiny(), **changes)
    jp = jwl.init_params(jax.random.PRNGKey(seed), jcfg)
    p = interop.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, jp, cfg, p


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _reference_engine(jcfg, jp, reqs, prefix=None, **geometry):
    """The reference engine's tokens by rid, and its ticks."""
    eng = jserve.ServeEngine(jp, jcfg, **geometry)
    if prefix is not None:
        eng.register_prefix("sys", prefix)
    for r in reqs:
        eng.submit(jserve.Request(rid=r.rid, prompt=r.prompt,
                                  max_new_tokens=r.max_new_tokens,
                                  eos_token=r.eos_token,
                                  prefix_id=r.prefix_id))
    return ({c.rid: c.tokens for c in eng.run_until_drained()},
            eng.tick_count)


def _serve_three_ways(pair, reqs, prefix=None, **geometry):
    """Serve ``reqs`` on the port's engine and the reference's with the
    same geometry: every completion equals the port's solo generate on its
    full prompt and the reference engine's tokens, in as many ticks.
    Returns the port's completions by rid."""
    jcfg, jp, cfg, p = pair
    eng = ServeEngine(p, cfg, device="cpu", **geometry)
    if prefix is not None:
        eng.register_prefix("sys", prefix)
    for r in reqs:
        eng.submit(r)
    done = {c.rid: c for c in eng.run_until_drained()}
    ref, ref_ticks = _reference_engine(jcfg, jp, reqs, prefix, **geometry)
    assert sorted(done) == sorted(r.rid for r in reqs)
    assert eng.tick_count == ref_ticks
    for r in reqs:
        full = (np.concatenate([prefix, r.prompt]) if r.prefix_id
                else r.prompt)
        c = done[r.rid]
        assert c.prompt_len == len(full)
        solo = _solo_full(p, cfg, full, r.max_new_tokens)
        if r.eos_token is not None and r.eos_token in solo.tolist():
            solo = solo[:solo.tolist().index(r.eos_token) + 1]
        np.testing.assert_array_equal(c.tokens, solo, err_msg=f"rid {r.rid}")
        np.testing.assert_array_equal(c.tokens, ref[r.rid])
    return done


@pytest.mark.parametrize("chunk", [4, 7, 16])
def test_chunked_prefill_matches_solo_and_reference(pair, chunk):
    """Chunk sizes straddle the prompt lengths: single-chunk,
    ragged-final-chunk and exact-multiple prompts all occur."""
    rng = np.random.default_rng(11)
    reqs = [Request(rid=i, prompt=_prompt(rng, 3, 17, 256),
                    max_new_tokens=int(rng.integers(2, 9)))
            for i in range(8)]
    _serve_three_ways(pair, reqs, slots=3, max_seq=64, prompt_bucket=24,
                      chunk_prefill=chunk)


def test_chunked_prefill_interleaves_with_resident_decode(pair):
    """A resident sequence decodes on every tick while a long prompt
    streams in, chunk by chunk, where a monolithic prefill would stall it;
    a prefilling slot is not active."""
    jcfg, jp, cfg, p = pair
    geometry = dict(slots=2, max_seq=64, prompt_bucket=32, chunk_prefill=4)
    eng = ServeEngine(p, cfg, device="cpu", **geometry)
    rng = np.random.default_rng(3)
    resident = Request(rid=0, prompt=rng.integers(0, 256, 4, dtype=np.int32),
                       max_new_tokens=40)
    eng.submit(resident)
    for _ in range(4):
        eng.tick()
    assert eng.req[0] is not None and eng.prefill_off[0] is None
    long_req = Request(rid=1, prompt=rng.integers(0, 256, 32, dtype=np.int32),
                       max_new_tokens=2)
    eng.submit(long_req)
    before = len(eng.generated[0])
    assert eng.tick() == 1                   # admits and streams chunk one
    prefill_ticks = 1
    while any(off is not None for off in eng.prefill_off):
        eng.tick()
        prefill_ticks += 1
    assert prefill_ticks == 32 // 4
    assert len(eng.generated[0]) - before >= prefill_ticks
    done = {c.rid: c.tokens for c in eng.run_until_drained()}
    ref, _ = _reference_engine(jcfg, jp, [resident, long_req], **geometry)
    for r in (resident, long_req):
        np.testing.assert_array_equal(
            done[r.rid], _solo_full(p, cfg, r.prompt, r.max_new_tokens))
        np.testing.assert_array_equal(done[r.rid], ref[r.rid])


def test_chunk_geometry_is_refused_before_any_write(model):
    """The reference's clamp guards, which keep every in-place write in
    range: a last chunk past max_seq at construction, chunk_prefill < 1,
    and a prefix + chunk-aligned suffix past max_seq at submit."""
    cfg, params = model
    with pytest.raises(ValueError, match="chunk-aligned"):
        ServeEngine(params, cfg, slots=2, max_seq=64, prompt_bucket=60,
                    chunk_prefill=48, device="cpu")   # ceil(60/48)*48 > 64
    ServeEngine(params, cfg, slots=2, max_seq=128, prompt_bucket=60,
                chunk_prefill=48, device="cpu")
    with pytest.raises(ValueError, match="chunk_prefill must be >= 1"):
        ServeEngine(params, cfg, slots=2, max_seq=64, prompt_bucket=16,
                    chunk_prefill=0, device="cpu")
    eng = ServeEngine(params, cfg, slots=1, max_seq=32, prompt_bucket=8,
                      chunk_prefill=6, device="cpu")
    eng.register_prefix("sys", np.zeros(22, np.int32))
    with pytest.raises(ValueError, match="chunk-aligned prompt span 34"):
        eng.submit(Request(rid=0, prompt=np.zeros(7, np.int32),
                           max_new_tokens=1, prefix_id="sys"))
    assert not eng.queue


def test_prefix_caching_matches_solo_on_full_prompt(pair):
    """Prefix tenants and plain tenants take turns in the same slots; a
    stale prefix length must never leak into a plain tenant."""
    rng = np.random.default_rng(21)
    prefix = rng.integers(0, 256, 12, dtype=np.int32)
    reqs = [Request(rid=i, prompt=_prompt(rng, 4, 10, 256),
                    max_new_tokens=int(rng.integers(2, 6)),
                    prefix_id="sys" if i % 2 == 0 else None)
            for i in range(6)]
    _serve_three_ways(pair, reqs, prefix, slots=2, max_seq=64,
                      prompt_bucket=16, chunk_prefill=5)


def test_prefix_caching_validation(model):
    cfg, params = model
    prefix = np.random.default_rng(23).integers(0, 256, 8, dtype=np.int32)
    mono = ServeEngine(params, cfg, slots=1, max_seq=64, prompt_bucket=16,
                       device="cpu")
    with pytest.raises(ValueError, match="chunk"):
        mono.register_prefix("sys", prefix)
    with pytest.raises(ValueError, match="chunked engine"):
        mono.submit(Request(rid=0, prompt=np.zeros(4, np.int32),
                            max_new_tokens=1, prefix_id="sys"))
    eng = ServeEngine(params, cfg, slots=1, max_seq=32, prompt_bucket=8,
                      chunk_prefill=4, device="cpu")
    eng.register_prefix("sys", prefix)
    with pytest.raises(ValueError, match="unknown prefix_id"):
        eng.submit(Request(rid=0, prompt=np.zeros(4, np.int32),
                           max_new_tokens=1, prefix_id="nope"))
    with pytest.raises(ValueError, match="non-empty suffix"):
        eng.submit(Request(rid=0, prompt=np.zeros(0, np.int32),
                           max_new_tokens=1, prefix_id="sys"))
    with pytest.raises(ValueError, match="max_seq"):
        # prefix 8 + suffix 8 + 17 generated > 32
        eng.submit(Request(rid=0, prompt=np.zeros(8, np.int32),
                           max_new_tokens=17, prefix_id="sys"))


def test_prefix_reregistration_does_not_affect_queued_requests(pair):
    """The resolved prefix is pinned at submit: registering the id again,
    longer, before admission leaves the queued request as it was."""
    jcfg, jp, cfg, p = pair
    rng = np.random.default_rng(31)
    old = rng.integers(0, 256, 8, dtype=np.int32)
    suffix = _prompt(rng, 4, 8, 256)
    new = rng.integers(0, 256, 20, dtype=np.int32)
    req = Request(rid=0, prompt=suffix, max_new_tokens=4, prefix_id="sys")
    geometry = dict(slots=1, max_seq=64, prompt_bucket=16, chunk_prefill=4)
    eng = ServeEngine(p, cfg, device="cpu", **geometry)
    jeng = jserve.ServeEngine(jp, jcfg, **geometry)
    for e, r in ((eng, req), (jeng, jserve.Request(
            rid=0, prompt=suffix, max_new_tokens=4, prefix_id="sys"))):
        e.register_prefix("sys", old)
        e.submit(r)
        e.register_prefix("sys", new)
    [done] = eng.run_until_drained()
    [ref] = jeng.run_until_drained()
    full = np.concatenate([old, suffix])
    assert done.prompt_len == ref.prompt_len == len(full)
    np.testing.assert_array_equal(done.tokens, _solo_full(p, cfg, full, 4))
    np.testing.assert_array_equal(done.tokens, ref.tokens)


def test_register_prefix_rejects_unusable_length(model):
    """A prefix that leaves no room for a chunk-aligned suffix and one
    generated token fails at registration, before any K/V is computed."""
    cfg, params = model
    eng = ServeEngine(params, cfg, slots=1, max_seq=32, prompt_bucket=8,
                      chunk_prefill=8, device="cpu")
    for bad in (26, 0):
        with pytest.raises(ValueError, match="room"):
            eng.register_prefix("big", np.zeros(bad, np.int32))
    eng.register_prefix("ok", np.zeros(24, np.int32))        # 24 + 8 == 32
    assert eng._prefixes["ok"]["len"] == 24
    assert eng._prefixes["ok"]["kv"][0]["k"].shape == (1, 24, cfg.kv_heads,
                                                       cfg.head_dim)


def test_reregistering_a_prefix_at_its_length_keeps_queued_inserts(pair):
    """The prefix K/V program is one a prefix length, so registering an id
    again at the same length replays it over its output: the entry a
    queued request holds keeps its own K/V and its own insert program, and
    a request submitted after the new registration gets the new prefix."""
    jcfg, jp, cfg, p = pair
    rng = np.random.default_rng(41)
    old, new = (rng.integers(0, 256, 8, dtype=np.int32) for _ in range(2))
    reqs = [Request(rid=i, prompt=_prompt(rng, 4, 8, 256), max_new_tokens=4,
                    prefix_id="sys") for i in range(2)]
    eng = ServeEngine(p, cfg, slots=1, max_seq=64, prompt_bucket=16,
                      chunk_prefill=4, device="cpu")
    eng.register_prefix("sys", old)
    eng.submit(reqs[0])
    held = eng.queue[0][1]
    eng.register_prefix("sys", new)
    eng.submit(reqs[1])
    assert eng._prefixes["sys"] is not held
    assert [k for k in eng._programs if k[0] == "prefix"] == [("prefix", 8)]
    done = {c.rid: c for c in eng.run_until_drained()}
    assert held["insert"] is not eng._prefixes["sys"]["insert"]
    for r, prefix in zip(reqs, (old, new)):
        full = np.concatenate([prefix, r.prompt])
        assert done[r.rid].prompt_len == len(full)
        np.testing.assert_array_equal(done[r.rid].tokens,
                                      _solo_full(p, cfg, full, 4))


def _random_arenas(jcfg, cfg, slots, max_seq, seed):
    """The same random arena contents for the reference and the port: rows
    that no write of the test touches must be masked or left alone."""
    rng = np.random.default_rng(seed)
    shape = (slots, max_seq, cfg.kv_heads, cfg.head_dim)
    arrays = [{n: rng.standard_normal(shape).astype(np.float32)
               for n in ("k", "v")} for _ in range(cfg.n_layers)]
    return ([{n: jnp.asarray(a) for n, a in c.items()} for c in arrays],
            [{n: torch.from_numpy(a.copy()) for n, a in c.items()}
             for c in arrays])


def _close(got, ref, rel=1e-5):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-6))


def _close_arenas(cache, ref_cache):
    for c, want in zip(cache, ref_cache):
        for name in want:
            _close(c[name].numpy(), want[name])


BODIES = functools.partial(Program, graphed=False)
AXES = (None, None, None)


@pytest.mark.parametrize("attn", ["naive", "flash"])
def test_prefix_programs_equal_reference_builders(attn):
    """The prefix's K/V program against jaxbridge's ``_build_prefix_kv``
    (the configured attention, flash through its plain version here and
    Pallas in interpret mode there), and the insert program into slot 1
    of a random arena against ``_build_prefix_insert``: within 1e-5."""
    jcfg, jp, cfg, p = _pair(seed=4, attn=attn)
    tokens = np.random.default_rng(8).integers(0, 256, 12, dtype=np.int32)
    ref_kv = jserve._build_prefix_kv(jcfg)(jp, jnp.asarray(tokens))
    kv = serve._build_prefix_kv(p, cfg, 12, "cpu", AXES, BODIES)(
        tokens=tokens)
    assert kv.shape == (cfg.n_layers, 2, 1, 12, cfg.kv_heads, cfg.head_dim)
    for layer, want in zip(kv, ref_kv):
        _close(layer[0].numpy(), want["k"])
        _close(layer[1].numpy(), want["v"])
    jarena, arena = _random_arenas(jcfg, cfg, 3, 24, seed=9)
    ref_arena = jserve._build_prefix_insert(jcfg)(jarena, ref_kv,
                                                  jnp.int32(1))
    insert = serve._build_prefix_insert(
        arena, [{"k": x[0], "v": x[1]} for x in kv], BODIES)
    assert insert(slot=1) is None
    _close_arenas(arena, ref_arena)


def test_chunk_program_equals_reference_builder(pair):
    """The chunk program against jaxbridge's ``_build_prefill_chunk`` on a
    random 3-slot arena, in slot 2 after a 5-row prefix inserted there:
    a first, a middle and a partial last chunk of a 10-token suffix (C =
    4, so the last chunk holds 2 real rows), each chunk's logits row and
    the whole arena within 1e-5 relative (f32)."""
    jcfg, jp, cfg, p = pair
    C, slot, plen = 4, 2, 5
    rng = np.random.default_rng(13)
    prefix = rng.integers(0, 256, plen, dtype=np.int32)
    suffix = rng.integers(0, 256, 10, dtype=np.int32)
    true_len = plen + len(suffix)
    jarena, arena = _random_arenas(jcfg, cfg, 3, 24, seed=10)
    ref_kv = jserve._build_prefix_kv(jcfg)(jp, jnp.asarray(prefix))
    jarena = jserve._build_prefix_insert(jcfg)(jarena, ref_kv,
                                               jnp.int32(slot))
    kv = serve._build_prefix_kv(p, cfg, plen, "cpu", AXES, BODIES)(
        tokens=prefix)
    serve._build_prefix_insert(arena, [{"k": x[0], "v": x[1]} for x in kv],
                               BODIES)(slot=slot)
    ref_chunk = jserve._build_prefill_chunk(jcfg, C)
    chunk = serve._build_prefill_chunk(p, arena, cfg, C, AXES, BODIES)
    for off in (plen, plen + C, plen + 2 * C):       # first, middle, last
        n = min(C, true_len - off)
        tokens = np.zeros(C, np.int32)
        tokens[:n] = suffix[off - plen:off - plen + n]
        jarena, ref_row = ref_chunk(jp, jarena, jnp.asarray(tokens),
                                    jnp.int32(slot), jnp.int32(off),
                                    jnp.int32(true_len - 1 - off))
        row = chunk(chunk=tokens, slot=slot, off=off,
                    last_row=true_len - 1 - off)
        assert row.shape == (cfg.vocab,)
        _close(row.numpy(), ref_row)
        _close_arenas(arena, jarena)
    assert n == 2


def test_f32_masters_are_cast_once_for_every_program():
    """With f32 master weights and bf16 compute, no program body casts a
    weight: the chunk, prefix and sampled-round programs take the engine's
    cast-once weights. The streams equal an engine given the cast weights
    with bf16 masters (chunked with a prefix, and sampled speculation)."""
    cfg = dataclasses.replace(wl.ModelConfig.tiny(), dtype=torch.bfloat16,
                              param_dtype=torch.float32)
    params = wl.init_params(cfg, torch.Generator().manual_seed(6), "cpu")
    assert params["layers"][0]["wq"].dtype == torch.float32
    cast = wl.cast_params_for_compute(params, cfg)
    bf16 = dataclasses.replace(cfg, param_dtype=None)
    rng = np.random.default_rng(17)
    prefix = rng.integers(0, 256, 7, dtype=np.int32)
    reqs = [Request(rid=i, prompt=_prompt(rng, 3, 12, 256),
                    max_new_tokens=int(rng.integers(2, 7)),
                    prefix_id="sys" if i % 2 else None) for i in range(5)]
    modes = {"chunked": dict(chunk_prefill=4),
             "sampled": dict(temperature=0.8, top_k=24, seed=3,
                             request_keyed=True, spec_k=3)}
    copies = []
    real = decode.cast_params_for_compute

    def spy(tree, c):
        out = real(tree, c)
        copies.append(sum(a is not b for a, b in zip(wl.tree_leaves(out),
                                                     wl.tree_leaves(tree))))
        return out

    for mode, kw in modes.items():
        streams = []
        for weights, c in ((params, cfg), (cast, bf16)):
            if mode == "sampled":
                kw = {**kw, "draft_params": weights, "draft_cfg": c}
            eng = ServeEngine(weights, c, slots=2, max_seq=48,
                              prompt_bucket=16, device="cpu", **kw)
            copies.clear()
            decode.cast_params_for_compute = spy
            try:
                if mode == "chunked":
                    eng.register_prefix("sys", prefix)
                for r in reqs:
                    eng.submit(r if mode == "chunked" else
                               dataclasses.replace(r, prefix_id=None))
                streams.append({x.rid: x.tokens.tolist()
                                for x in eng.run_until_drained()})
            finally:
                decode.cast_params_for_compute = real
            assert copies and not any(copies), f"{mode}: a body cast weights"
        assert streams[0] == streams[1], mode


@pytest.fixture(scope="module")
def moe_pair():
    return _pair(seed=3, n_experts=4, moe_top_k=2)


@pytest.mark.parametrize("chunk", [None, 5])
def test_moe_engine_matches_solo_and_reference(moe_pair, chunk):
    """Monolithic and chunked admission over the dropless MoE block."""
    rng = np.random.default_rng(37)
    reqs = [Request(rid=i, prompt=_prompt(rng, 3, 14, 256),
                    max_new_tokens=int(rng.integers(2, 7)))
            for i in range(6)]
    _serve_three_ways(moe_pair, reqs, slots=3, max_seq=64, prompt_bucket=16,
                      chunk_prefill=chunk)


@pytest.mark.parametrize("seed", [51, 77, 1234])
def test_serving_soak_composed_features(pair, seed):
    """Chunked prefill, prefix caching, EOS mid-generation, mixed lengths
    and slot churn in one engine run."""
    jcfg, jp, cfg, p = pair
    rng = np.random.default_rng(seed)
    chunk = int(rng.integers(3, 8))
    prefix = rng.integers(0, 256, int(rng.integers(6, 12)), dtype=np.int32)
    reqs = []
    for i in range(10):
        use_prefix = bool(rng.integers(0, 2))
        prompt = _prompt(rng, 3, 14, 256)
        gen = int(rng.integers(2, 9))
        full = np.concatenate([prefix, prompt]) if use_prefix else prompt
        eos = None
        if rng.integers(0, 3) == 0 and gen >= 3:
            eos = int(_solo_full(p, cfg, full, gen)[1])
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=gen,
                            eos_token=eos,
                            prefix_id="sys" if use_prefix else None))
    _serve_three_ways(pair, reqs, prefix, slots=3, max_seq=64,
                      prompt_bucket=20, chunk_prefill=chunk)


def test_int8_arena_matches_solo_int8():
    """Monolithic admission quantizes slot inserts as solo prefill does, so
    the int8 arena keeps engine == solo int8 generate == the reference."""
    rng = np.random.default_rng(29)
    reqs = [Request(rid=i, prompt=_prompt(rng, 3, 15, 256),
                    max_new_tokens=int(rng.integers(2, 9)))
            for i in range(8)]
    _serve_three_ways(_pair(kv_cache_dtype="int8"), reqs, slots=3,
                      max_seq=64, prompt_bucket=16)


def test_int8_arena_refuses_chunked_prefill(model):
    cfg, params = model
    cfg8 = dataclasses.replace(cfg, kv_cache_dtype="int8")
    eng = ServeEngine(params, cfg8, slots=2, max_seq=64, prompt_bucket=16,
                      device="cpu")
    assert eng.cache[0]["k"].dtype == torch.int8 and "ks" in eng.cache[0]
    with pytest.raises(ValueError, match="monolithic admission"):
        ServeEngine(params, cfg8, slots=2, max_seq=64, prompt_bucket=16,
                    chunk_prefill=4, device="cpu")


def test_measure_serving_chunked_counts_tokens(model):
    """Chunked measure_serving serves every token; its warmup and chunks
    run no monolithic prefill."""
    cfg, params = model
    rng = np.random.default_rng(3)
    reqs = [Request(rid=i, prompt=_prompt(rng, 3, 9, cfg.vocab),
                    max_new_tokens=int(rng.integers(2, 7)))
            for i in range(6)]
    out = measure_serving(cfg, params, reqs, slots=2, max_seq=48,
                          prompt_bucket=16, chunk_prefill=4, device="cpu")
    assert out["tokens"] == sum(r.max_new_tokens for r in reqs)
    assert 0 < out["occupancy"] <= 1.0 and out["prefills"] == 0
    assert out["tokens_per_s"] > 0 and out["max_tick_gap_s"] > 0
