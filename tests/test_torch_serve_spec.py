"""The speculative and request-keyed paths of tpusched_torch.serve on the
CPU.

Greedy speculative serving is deterministic: every completion AND the
engine's ``spec_stats`` must equal jaxbridge's speculative engine on the
same f32 weights (dense, MoE, int8 target arena; random, truncated and
self drafts), and the plain engine's tokens. Request-keyed and sampled
speculative serving draw from the port's own keys, so they are held to the
reference's laws: batching invariance, and equality with the solo keyed
samplers run with ``fold_in(seed, rid)``."""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from tpusched.jaxbridge import decode as jdec, serve as jserve
from tpusched.jaxbridge import workload as jwl
from tpusched_torch import decode, interop, serve, spec_decode as sd
from tpusched_torch import mesh as tmesh, workload as wl
from tpusched_torch.program import Program
from tpusched_torch.serve import Request, ServeEngine

torch.set_num_threads(1)

DRAFT = dict(n_layers=1, d_model=32, n_heads=2, d_ff=64)
GEOMETRY = dict(slots=3, max_seq=64, prompt_bucket=16)


def _pair(jcfg, seed):
    cfg = wl.ModelConfig(**{f.name: getattr(jcfg, f.name)
                            for f in dataclasses.fields(wl.ModelConfig)
                            if f.name not in ("dtype", "param_dtype")})
    jp = jwl.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, cfg, interop.params_from_numpy(
        jax.tree.map(np.asarray, jp), cfg, "cpu")


def _draft(kind, target, seed):
    jcfg, jp, cfg, p = target
    if kind == "self":
        return target
    if kind == "truncated":       # the target's first layer: partial accepts
        return (dataclasses.replace(jcfg, n_layers=1),
                {**jp, "layers": jp["layers"][:1]},
                dataclasses.replace(cfg, n_layers=1),
                {**p, "layers": p["layers"][:1]})
    return _pair(dataclasses.replace(jwl.ModelConfig.tiny(), **DRAFT), seed)


@pytest.fixture(scope="module")
def tiny():
    return _pair(jwl.ModelConfig.tiny(), 0)


def _requests(seed, n, vocab=256, gen=(2, 10)):
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        prompt = rng.integers(0, vocab, size=int(rng.integers(3, 15)),
                              dtype=np.int32)
        reqs.append(Request(rid=i, prompt=prompt,
                            max_new_tokens=int(rng.integers(*gen))))
    return reqs


def _drain(eng, reqs, order=None):
    for i in (order if order is not None else range(len(reqs))):
        eng.submit(reqs[i])
    return {c.rid: (c.tokens.tolist(), c.admitted_tick, c.finished_tick)
            for c in eng.run_until_drained()}


def _reference(target, draft, reqs, spec_k, **kw):
    jcfg, jp = target[:2]
    eng = jserve.ServeEngine(jp, jcfg, draft_params=draft[1],
                             draft_cfg=draft[0], spec_k=spec_k,
                             **{**GEOMETRY, **kw})
    return _drain(eng, reqs), eng.spec_stats, eng.tick_count


def _port(target, draft, reqs, spec_k, **kw):
    eng = ServeEngine(target[3], target[2], draft_params=draft[3],
                      draft_cfg=draft[2], spec_k=spec_k, device="cpu",
                      **{**GEOMETRY, **kw})
    return _drain(eng, reqs), eng.spec_stats, eng.tick_count, eng


# -- greedy speculative serving: completions and stats equal jaxbridge's ------

@pytest.mark.parametrize("seed,draft,spec_k", [
    (61, "random", 3), (88, "random", 3), (5, "truncated", 3),
    (23, "truncated", 4), (404, "self", 3), (7, "random", 1)])
def test_speculative_engine_matches_reference(tiny, seed, draft, spec_k):
    """Mixed prompt and generation lengths, EOS early stops and slot churn
    through 3 slots: tokens, admission and finish ticks, spec_stats and the
    tick count equal jaxbridge's speculative engine; tokens equal the plain
    engine's."""
    d = _draft(draft, tiny, 500 + seed)
    reqs = _requests(seed, 8)
    plain = _drain(ServeEngine(tiny[3], tiny[2], device="cpu", **GEOMETRY),
                   reqs)
    # an EOS from each third request's plain stream ends it early
    reqs = [dataclasses.replace(r, eos_token=plain[r.rid][0][1])
            if r.rid % 3 == 0 and r.max_new_tokens >= 4 else r for r in reqs]
    plain = _drain(ServeEngine(tiny[3], tiny[2], device="cpu", **GEOMETRY),
                   reqs)
    ref, ref_stats, ref_ticks = _reference(tiny, d, reqs, spec_k)
    got, stats, ticks, eng = _port(tiny, d, reqs, spec_k)
    assert got == ref
    assert stats == ref_stats and ticks == ref_ticks
    assert {r: v[0] for r, v in got.items()} == {
        r: v[0] for r, v in plain.items()}
    assert stats["rounds"] == ticks > 0
    assert stats["drafted"] >= stats["accepted"]
    if draft == "truncated":
        assert 0 < stats["accepted"] < stats["drafted"]


def test_moe_speculative_engine_matches_reference(tiny):
    target = _pair(dataclasses.replace(jwl.ModelConfig.tiny(), n_experts=4,
                                       moe_top_k=2), 5)
    reqs = _requests(13, 6)
    for kind in ("random", "self"):
        d = _draft(kind, target, 6)
        ref, ref_stats, ref_ticks = _reference(target, d, reqs, 3)
        got, stats, ticks, _ = _port(target, d, reqs, 3)
        assert got == ref and stats == ref_stats and ticks == ref_ticks


def test_int8_target_speculative_engine_matches_reference(tiny):
    """An int8 target arena under an exact draft: the verify span writes and
    reads the rows sequential decode would, so tokens equal the plain int8
    engine's and the reference's."""
    i8 = tuple(dataclasses.replace(c, kv_cache_dtype="int8")
               if i in (0, 2) else c for i, c in enumerate(tiny))
    reqs = _requests(31, 5, gen=(3, 8))
    for kind in ("self", "truncated"):
        d = _draft(kind, tiny, 0)
        ref, ref_stats, ref_ticks = _reference(i8, d, reqs, 3)
        got, stats, ticks, _ = _port(i8, d, reqs, 3)
        assert got == ref and stats == ref_stats and ticks == ref_ticks
    plain = _drain(ServeEngine(i8[3], i8[2], device="cpu", **GEOMETRY), reqs)
    assert {r: v[0] for r, v in got.items()} == {
        r: v[0] for r, v in plain.items()}


def test_perfect_draft_compresses_rounds(tiny):
    """Self-draft: every proposal accepted, spec_k + 1 tokens a round, so
    rounds collapse well below the plain engine's ticks."""
    reqs = [dataclasses.replace(r, max_new_tokens=12)
            for r in _requests(3, 4)]
    got, stats, ticks, _ = _port(tiny, tiny, reqs, 3, slots=4)
    ref, ref_stats, ref_ticks = _reference(tiny, tiny, reqs, 3, slots=4)
    assert got == ref and stats == ref_stats
    assert stats["accepted"] == stats["drafted"]
    assert stats["rounds"] <= 4
    plain = ServeEngine(tiny[3], tiny[2], device="cpu",
                        **{**GEOMETRY, "slots": 4})
    _drain(plain, reqs)
    assert plain.tick_count > ticks


def test_measure_serving_spec_outputs_match_reference(tiny):
    reqs = _requests(17, 6)
    d = _draft("truncated", tiny, 0)
    ref = jserve.measure_serving(tiny[0], tiny[1], reqs, draft_params=d[1],
                                 draft_cfg=d[0], spec_k=3, **GEOMETRY)
    got = serve.measure_serving(tiny[2], tiny[3], reqs, draft_params=d[3],
                                draft_cfg=d[2], spec_k=3, device="cpu",
                                **GEOMETRY)
    for key in ("spec_rounds", "spec_drafted", "spec_accepted", "ticks",
                "tokens", "occupancy"):
        assert got[key] == ref[key], key
    # warmup's one bucket (a 2-token request, so it reaches a round and the
    # draft arena mirrors it), then every request
    assert got["prefills"] == got["draft_prefills"] == len(reqs) + 1
    plain = serve.measure_serving(tiny[2], tiny[3], reqs, device="cpu",
                                  **GEOMETRY)
    assert "spec_rounds" not in plain and "draft_prefills" not in plain


def test_draft_arena_skips_requests_done_at_admission(tiny):
    """A request that finishes at admission (one new token) never reaches a
    round, so the draft arena does not prefill it."""
    reqs = [dataclasses.replace(r, max_new_tokens=1 if r.rid % 2 else 5)
            for r in _requests(19, 6)]
    eng = ServeEngine(tiny[3], tiny[2], draft_params=tiny[3],
                      draft_cfg=tiny[2], spec_k=3, device="cpu", **GEOMETRY)
    eng.warmup()
    assert eng.spec_stats == {"rounds": 0, "drafted": 0, "accepted": 0}
    prefills, draft_prefills = eng.prefills, eng.draft_prefills
    assert (prefills, draft_prefills) == (1, 1)
    done = _drain(eng, reqs)
    assert len(done) == 6
    assert eng.prefills - prefills == 6
    assert eng.draft_prefills - draft_prefills == 3


# -- guards: the reference's messages -----------------------------------------

def _construct_error(target, **kw):
    with pytest.raises(ValueError) as want:
        jserve.ServeEngine(target[1], target[0], **{
            k: (v[0] if isinstance(v, tuple) else v) for k, v in kw.items()})
    with pytest.raises(ValueError) as got:
        ServeEngine(target[3], target[2], device="cpu", **{
            k: (v[1] if isinstance(v, tuple) else v) for k, v in kw.items()})
    return str(got.value), str(want.value)


def test_constructor_guards_match_reference(tiny):
    d = _draft("random", tiny, 1)
    bad_vocab = _pair(dataclasses.replace(jwl.ModelConfig.tiny(), **DRAFT,
                                          vocab=512), 2)
    i8_draft = (dataclasses.replace(d[0], kv_cache_dtype="int8"),
                dataclasses.replace(d[2], kv_cache_dtype="int8"))
    cases = {
        "draft_cfg without": dict(draft_cfg=(d[0], d[2])),
        "requires draft_cfg": dict(draft_params=(d[1], d[3])),
        "vocabulary": dict(draft_params=(bad_vocab[1], bad_vocab[3]),
                           draft_cfg=(bad_vocab[0], bad_vocab[2])),
        "request_keyed=True": dict(draft_params=(d[1], d[3]),
                                   draft_cfg=(d[0], d[2]), temperature=0.5),
        "needs temperature": dict(request_keyed=True),
        "spec_k must": dict(draft_params=(d[1], d[3]),
                            draft_cfg=(d[0], d[2]), spec_k=0),
        "speculative geometry": dict(draft_params=(d[1], d[3]),
                                     draft_cfg=(d[0], d[2]), spec_k=6,
                                     max_seq=24, prompt_bucket=16),
        "draft cache must be exact": dict(draft_params=(d[1], d[3]),
                                          draft_cfg=i8_draft),
    }
    for match, kw in cases.items():
        got, want = _construct_error(tiny, **kw)
        assert got == want and match in got, (match, got, want)
    # speculation refuses chunked admission, as the reference does, with
    # its message, mesh clause included
    got, want = _construct_error(tiny, draft_params=(d[1], d[3]),
                                 draft_cfg=(d[0], d[2]), chunk_prefill=4,
                                 max_seq=64, prompt_bucket=16)
    assert "monolithic admission only" in got and got == want
    # on a tp mesh the draft's kv_heads must split over tp, as the target's
    k1 = _pair(dataclasses.replace(jwl.ModelConfig.tiny(), n_heads=4,
                                   n_kv_heads=1), 3)
    got, want = _construct_error(
        tiny, draft_params=(k1[1], k1[3]), draft_cfg=(k1[0], k1[2]),
        mesh=(JMesh(np.array(jax.devices()[:2]), ("tp",)),
              tmesh.Mesh({"tp": 2}, device="cpu")))
    assert got == want == "draft kv_heads 1 not divisible by tp 2"
    # sampled speculation composes with request-keyed sampling
    ServeEngine(tiny[3], tiny[2], draft_params=d[3], draft_cfg=d[2],
                temperature=0.5, request_keyed=True, max_seq=64,
                prompt_bucket=16, device="cpu")


def test_geometry_boundaries_warm_up(tiny):
    """The geometry the guard admits is one warmup can use: one bucket at
    16 + 6 + 3 == 25, and (8, 16) at 24, where only the smallest bucket
    warms with 2 new tokens."""
    d = _draft("truncated", tiny, 0)
    for max_seq, bucket in ((25, 16), (24, (8, 16))):
        eng = ServeEngine(tiny[3], tiny[2], slots=1, max_seq=max_seq,
                          prompt_bucket=bucket, draft_params=d[3],
                          draft_cfg=d[2], spec_k=6, device="cpu")
        eng.warmup()


def test_submit_guards_match_reference(tiny):
    d = _draft("truncated", tiny, 0)
    kw = dict(slots=1, max_seq=64, prompt_bucket=16, spec_k=4)
    ref = jserve.ServeEngine(tiny[1], tiny[0], draft_params=d[1],
                             draft_cfg=d[0], **kw)
    eng = ServeEngine(tiny[3], tiny[2], draft_params=d[3], draft_cfg=d[2],
                      device="cpu", **kw)
    for req in (Request(rid=0, prompt=np.zeros(16, np.int32),
                        max_new_tokens=44),          # 16 + 44 + 5 > 64
                Request(rid=0, prompt=np.zeros(0, np.int32),
                        max_new_tokens=2)):
        with pytest.raises(ValueError) as want:
            ref.submit(req)
        with pytest.raises(ValueError) as got:
            eng.submit(req)
        assert str(got.value) == str(want.value)
    eng.submit(Request(rid=0, prompt=np.zeros(16, np.int32),
                       max_new_tokens=43))           # 16 + 43 + 5 == 64
    assert len(eng.run_until_drained()) == 1

    keyed = ServeEngine(tiny[3], tiny[2], temperature=0.8, seed=1,
                        request_keyed=True, device="cpu", **GEOMETRY)
    ref = jserve.ServeEngine(tiny[1], tiny[0], temperature=0.8, seed=1,
                             request_keyed=True, **GEOMETRY)
    for e in (keyed, ref):
        e.submit(Request(rid=3, prompt=np.ones(4, np.int32),
                         max_new_tokens=2))
    with pytest.raises(ValueError) as want:
        ref.submit(Request(rid=3, prompt=np.ones(5, np.int32),
                           max_new_tokens=2))
    with pytest.raises(ValueError) as got:
        keyed.submit(Request(rid=3, prompt=np.ones(5, np.int32),
                             max_new_tokens=2))
    assert str(got.value) == str(want.value)


# -- edges ----------------------------------------------------------------------

def test_idle_slots_stay_finite_and_never_wrap(tiny, monkeypatch):
    """One request in three slots: the never-used slots sit at pos 0. Their
    device cursors are clamped to 1, so no draft feed lands on row -1,
    which advanced indexing would take as the arena's last row: that row
    stays zero in both arenas, and every logit of every round is finite."""
    d = _draft("random", tiny, 4)
    spans = []
    real = serve.score_span

    def spy(params, cache, tokens, pos, cfg, *axes):
        logits, cache = real(params, cache, tokens, pos, cfg, *axes)
        spans.append(bool(torch.isfinite(logits).all()))
        return logits, cache

    monkeypatch.setattr(serve, "score_span", spy)
    monkeypatch.setattr(decode, "score_span", spy)     # the draft rollout's
    eng = ServeEngine(tiny[3], tiny[2], draft_params=d[3], draft_cfg=d[2],
                      spec_k=3, device="cpu", **GEOMETRY)
    eng.submit(_requests(5, 1)[0])
    [done] = eng.run_until_drained()
    assert spans and all(spans)
    assert len(done.tokens) == _requests(5, 1)[0].max_new_tokens
    for arena in (eng.cache, eng.draft_cache):
        for layer in arena:
            assert not layer["k"][:, -1].any() and not layer["v"][:, -1].any()
            # the idle slots' writes stay in their first rows
            assert not layer["k"][1:, 5:].any()
    with pytest.raises(ValueError, match="negative cache position"):
        decode.upload_pos(np.asarray([3, -1]), "cpu")


def test_a_round_past_the_arena_is_refused_on_the_host(tiny):
    d = _draft("random", tiny, 4)
    eng = ServeEngine(tiny[3], tiny[2], draft_params=d[3], draft_cfg=d[2],
                      spec_k=3, device="cpu", **GEOMETRY)
    eng.submit(Request(rid=0, prompt=np.ones(4, np.int32), max_new_tokens=5))
    eng.tick()
    eng.pos[0] = 61                       # 61 + 3 + 1 > 64
    with pytest.raises(RuntimeError, match="past the arena"):
        eng.tick()


# -- request-keyed sampling: its laws --------------------------------------------

SAMPLING = dict(temperature=0.8, top_k=24, seed=5, request_keyed=True)


def _solo_keyed(tiny, req, cfg=None):
    cfg = cfg or tiny[2]
    return decode.sample_position_keyed(
        tiny[3], torch.from_numpy(req.prompt)[None].long(), cfg,
        req.max_new_tokens - 1, decode.fold_in(5, req.rid), temperature=0.8,
        top_k=24)[0].tolist()


def test_request_keyed_is_batching_invariant_and_solo_exact(tiny):
    reqs = _requests(43, 6, gen=(3, 9))

    def run(order, **kw):
        eng = ServeEngine(tiny[3], tiny[2], device="cpu",
                          **{**GEOMETRY, **SAMPLING, **kw})
        return {r: v[0] for r, v in _drain(eng, reqs, order).items()}

    a = run(range(6), slots=1)
    assert a == run(list(reversed(range(6))), slots=3)
    assert a == run([3, 0, 5, 1, 4, 2], slots=4)
    assert a == run(range(6), chunk_prefill=5)     # keyed first chunk token
    for r in reqs:
        assert a[r.rid] == _solo_keyed(tiny, r), f"request {r.rid}"
    assert a != run(range(6), seed=6)


def _host_keyed_draw(adj, keys, rows):
    """The draw the engine made on the host before its tick drew on the
    device: the adjusted rows copied over, ``keyed_categorical`` each."""
    host = adj.cpu().numpy()
    return torch.tensor([decode.keyed_categorical(a, k & (2**64 - 1), r)
                         for a, k, r in zip(host, keys.tolist(),
                                            rows.tolist())])


@pytest.mark.parametrize("chunk", [None, 5], ids=["monolithic", "chunked"])
def test_request_keyed_tick_draws_as_the_host_did(tiny, monkeypatch, chunk):
    """The decode tick draws each slot's token on the device (the keyed
    tick program) and the first token is drawn on the device too: the
    streams equal an engine whose draws go through the host's
    ``keyed_categorical``, and ``sample_position_keyed`` alone."""
    reqs = _requests(61, 5, gen=(4, 9))

    def run():
        eng = ServeEngine(tiny[3], tiny[2], device="cpu",
                          chunk_prefill=chunk, **{**GEOMETRY, **SAMPLING})
        return {r: v[0] for r, v in _drain(eng, reqs).items()}

    device = run()
    with monkeypatch.context() as m:
        m.setattr(serve, "keyed_draw", _host_keyed_draw)
        host = run()
    assert device == host
    for r in reqs:
        assert device[r.rid] == _solo_keyed(tiny, r), f"request {r.rid}"


def test_request_keyed_composes_with_int8_arena(tiny):
    i8 = dataclasses.replace(tiny[2], kv_cache_dtype="int8")
    reqs = _requests(59, 4, gen=(5, 6))
    eng = ServeEngine(tiny[3], i8, device="cpu", **{**GEOMETRY, **SAMPLING})
    got = _drain(eng, reqs)
    for r in reqs:
        assert got[r.rid][0] == _solo_keyed(tiny, r, i8), f"request {r.rid}"


@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
def test_sampled_speculative_engine_matches_solo(tiny, kv_cache_dtype):
    """Per request, sampled speculative serving equals solo
    speculative_sample with fold_in(seed, rid): the same proposals,
    acceptance, residual and bonus draws at the same rows, with a draft
    that is rejected often enough for the residual path to run."""
    cfg = dataclasses.replace(tiny[2], kv_cache_dtype=kv_cache_dtype)
    d = _draft("truncated", tiny, 0)
    reqs = _requests(47, 4, gen=(3, 8))
    eng = ServeEngine(tiny[3], cfg, draft_params=d[3], draft_cfg=d[2],
                      spec_k=3, device="cpu", **{**GEOMETRY, **SAMPLING})
    got = _drain(eng, [dataclasses.replace(r) for r in reqs])
    assert eng.spec_stats["accepted"] < eng.spec_stats["drafted"]
    for r in reqs:
        solo, _ = sd.speculative_sample(
            tiny[3], cfg, d[3], d[2], torch.from_numpy(r.prompt)[None].long(),
            r.max_new_tokens - 1, decode.fold_in(5, r.rid), k=3,
            temperature=0.8, top_k=24)
        assert got[r.rid][0] == solo[0].tolist(), f"request {r.rid}"


def test_sampled_speculative_self_draft_is_position_keyed(tiny):
    """The whole chain: the sampled speculative engine with a self-draft ==
    solo sample_position_keyed, every proposal accepted."""
    reqs = _requests(53, 3, gen=(6, 7))
    eng = ServeEngine(tiny[3], tiny[2], draft_params=tiny[3],
                      draft_cfg=tiny[2], spec_k=3, device="cpu",
                      **{**GEOMETRY, **SAMPLING})
    got = _drain(eng, reqs)
    assert eng.spec_stats["accepted"] == eng.spec_stats["drafted"] > 0
    for r in reqs:
        assert got[r.rid][0] == _solo_keyed(tiny, r), f"request {r.rid}"


def test_keyed_warmup_and_repeat(tiny):
    """warmup runs keyed engines too (rid -1 is a key like any other) and
    resets spec_stats; two engines with one seed serve identical tokens."""
    d = _draft("truncated", tiny, 0)
    reqs = _requests(71, 4)

    def run():
        eng = ServeEngine(tiny[3], tiny[2], draft_params=d[3],
                          draft_cfg=d[2], spec_k=3, device="cpu",
                          **{**GEOMETRY, **SAMPLING})
        eng.warmup()
        assert eng.spec_stats == {"rounds": 0, "drafted": 0, "accepted": 0}
        return _drain(eng, reqs)
    assert run() == run()


def _close_adjusted(got, ref, rel=1e-5):
    """Adjusted logits: the same entries masked (NEG_INF), the rest within
    ``rel`` of the largest kept magnitude."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    kept = ref > -1e30
    np.testing.assert_array_equal(got > -1e30, kept)
    np.testing.assert_allclose(got[kept], ref[kept], rtol=0,
                               atol=rel * np.abs(ref[kept]).max())


@pytest.mark.parametrize("draft", ["self", "truncated"])
def test_sampled_round_programs_equal_reference_builders(tiny, draft):
    """The sampled round's programs against jaxbridge's builders on arenas
    prefilled alike, slots at cursors (9, 6, 8): the draft ingest's and
    each one-token step's distributions equal ``_build_sampling_draft_tick``'s
    proposal probabilities within 1e-5 (each step fed the reference's own
    draws, which the port's keys would not reproduce), the draft arena
    after the round too; the verify span's adjusted logits equal
    ``_build_verify_sampled``'s ``adj`` within 1e-5 (its device-drawn
    bonus is not compared: the keys differ by convention), the target
    arena too."""
    k, slots, max_seq = 3, 3, 24
    sampling = (0.8, 24, 0.9)
    d = _draft(draft, tiny, 0)
    rng = np.random.default_rng(19)
    prompts = rng.integers(0, 256, (slots, 10), dtype=np.int32)
    pos = np.asarray([9, 6, 8])
    feed2 = rng.integers(0, 256, (slots, 2), dtype=np.int32)
    keys = jnp.stack([jax.random.PRNGKey(i) for i in range(slots)])
    program = functools.partial(Program, graphed=False)
    arenas = {}
    for name, (jcfg, jp, cfg, p) in (("target", tiny), ("draft", (d[0], d[1],
                                                                d[2], d[3]))):
        _, jc = jdec.prefill(jp, jdec.init_kv_cache(jcfg, slots, max_seq),
                             jnp.asarray(prompts), jcfg)
        cache = decode.init_kv_cache(cfg, slots, max_seq, "cpu")
        decode.prefill(p, cache, torch.from_numpy(prompts).long(), cfg)
        arenas[name] = (jc, cache)
    ref_toks, ref_probs, ref_dcache = jserve._build_sampling_draft_tick(
        d[0], k, *sampling)(d[1], arenas["draft"][0], jnp.asarray(feed2),
                            jnp.asarray(pos), keys)
    ref_toks, ref_probs = np.array(ref_toks), np.asarray(ref_probs)
    dcache = arenas["draft"][1]
    adj = decode._adjusted_span_program(d[3], dcache, d[2], (slots, 2),
                                        sampling, program)(
        tokens=feed2, pos=pos - 1)
    step = decode._adjusted_span_program(d[3], dcache, d[2], (slots, 1),
                                         sampling, program)
    for i in range(k):
        np.testing.assert_allclose(decode.probs_from_adjusted(adj.numpy()),
                                   ref_probs[:, i], atol=1e-5)
        if i < k - 1:
            adj = step(tokens=ref_toks[:, i:i + 1], pos=pos + 1 + i)
    for c, want in zip(dcache, ref_dcache):
        for n in want:
            _close_adjusted(c[n].numpy(), want[n])
    scored = np.concatenate([feed2[:, 1:], ref_toks], axis=1)
    ref_adj, _, ref_tcache = jserve._build_verify_sampled(
        tiny[0], *sampling)(tiny[1], arenas["target"][0],
                            jnp.asarray(scored), jnp.asarray(pos), keys)
    tcache = arenas["target"][1]
    got = decode._adjusted_span_program(tiny[3], tcache, tiny[2],
                                        (slots, k + 1), sampling, program,
                                        last=False)(tokens=scored, pos=pos)
    assert got.shape == (slots, k + 1, tiny[2].vocab)
    _close_adjusted(got.numpy(), ref_adj)
    for c, want in zip(tcache, ref_tcache):
        for n in want:
            _close_adjusted(c[n].numpy(), want[n])
