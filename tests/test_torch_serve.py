"""tpusched_torch.serve on the CPU. The load-bearing law, as for the
reference engine (tests/test_serve.py): continuous batching gives every
request exactly the tokens it gets alone — here held three ways, the port's
engine == the port's solo generate == the JAX reference's generate."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusched.jaxbridge import decode as jdec, workload as jwl
from tpusched_torch import decode, interop, serve, workload as wl
from tpusched_torch.serve import Request, ServeEngine, measure_serving

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def model():
    cfg = wl.ModelConfig.tiny()
    return cfg, wl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _prompt(rng, lo, hi, vocab):
    return rng.integers(0, vocab, size=rng.integers(lo, hi), dtype=np.int32)


def _solo(params, cfg, req):
    return decode.generate(params, torch.from_numpy(req.prompt)[None].long(),
                           cfg, steps=req.max_new_tokens - 1)[0].numpy()


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
    real = serve._prefill_slot

    def spy(params_, cache, prompt, slot, true_len, cfg_):
        padded.append((len(prompt), true_len))
        return real(params_, cache, prompt, slot, true_len, cfg_)

    monkeypatch.setattr(serve, "_prefill_slot", spy)
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


@pytest.mark.parametrize("option", [
    dict(mesh=object()), dict(chunk_prefill=4),
    dict(draft_params={}), dict(draft_cfg=wl.ModelConfig.tiny()),
    dict(request_keyed=True, temperature=1.0)])
def test_options_not_ported_yet_raise(model, option):
    cfg, params = model
    with pytest.raises(NotImplementedError, match="ROADMAP"):
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
