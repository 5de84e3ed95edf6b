"""tpusched_torch.serve.measure_serving_slo on the CPU: the reference's four
laws of the harness (tests/test_serving_slo.py), and one of the port's own,
that its tick metrics equal the reference harness's exactly on the same
requests and arrivals, monolithic, chunked and prefix-cached."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from tpusched.jaxbridge import serve as jserve, workload as jwl
from tpusched_torch import interop, workload as wl
from tpusched_torch.serve import Request, measure_serving, measure_serving_slo

torch.set_num_threads(1)

TICK_KEYS = ("ttft_ticks_p50", "ttft_ticks_p99", "tokens", "ticks",
             "tokens_per_tick", "slo_attainment",
             "goodput_tokens_per_tick")


@pytest.fixture(scope="module")
def model():
    cfg = wl.ModelConfig.tiny()
    return cfg, wl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _workload(cfg, seed=9, n=12):
    rng = np.random.default_rng(seed)
    suffixes = [rng.integers(0, cfg.vocab, int(rng.integers(6, 40)),
                             dtype=np.int32) for _ in range(n)]
    gens = [int(rng.integers(4, 24)) for _ in range(n)]
    arrivals = np.cumsum(rng.poisson(2.0, size=n)).tolist()
    return suffixes, gens, arrivals


def _mk(prompts, gens, request=Request):
    return [request(rid=i, prompt=p, max_new_tokens=gens[i])
            for i, p in enumerate(prompts)]


def test_tick_metrics_are_deterministic(model):
    """Tick metrics depend on the geometry alone (no EOS, no clock): two
    runs give the same."""
    cfg, params = model
    sfx, gens, arr = _workload(cfg)
    runs = [measure_serving_slo(cfg, params, _mk(sfx, gens), arr, slots=4,
                                max_seq=128, prompt_bucket=64,
                                ttft_slo_ticks=16, device="cpu")
            for _ in range(2)]
    a, b = ({k: r[k] for k in TICK_KEYS} for r in runs)
    assert a == b
    assert a["tokens"] == float(sum(gens))
    assert a["ttft_ticks_p50"] <= a["ttft_ticks_p99"]
    assert runs[0]["ttft_s_p50"] <= runs[0]["ttft_s_p99"]


def test_arrivals_are_honored(model):
    """A request arriving at tick 20 into an idle engine is not admitted
    before it, and its TTFT counts from its arrival."""
    cfg, params = model
    req = [Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                   max_new_tokens=6)]
    m = measure_serving_slo(cfg, params, req, [20], slots=2, max_seq=64,
                            prompt_bucket=16, device="cpu")
    assert m["ticks"] >= 20 + 5
    assert m["ttft_ticks_p99"] <= 2


def test_goodput_counts_only_slo_meeting_requests(model):
    cfg, params = model
    sfx, gens, arr = _workload(cfg)
    tight, loose = (measure_serving_slo(
        cfg, params, _mk(sfx, gens), arr, slots=2, max_seq=128,
        prompt_bucket=64, ttft_slo_ticks=slo, device="cpu")
        for slo in (0, 10_000))
    assert loose["slo_attainment"] == 1.0
    assert loose["goodput_tokens_per_tick"] == loose["tokens_per_tick"]
    assert tight["slo_attainment"] < 1.0
    assert tight["goodput_tokens_per_tick"] < tight["tokens_per_tick"]


def test_prefix_cache_beats_full_prefill(model):
    """The same context with its shared head registered once: TTFT p50 and
    the ticks to drain both fall against chunk-prefilling full prompts."""
    cfg, params = model
    sfx, gens, arr = _workload(cfg, seed=3)
    shared = (np.arange(48, dtype=np.int32) * 5) % cfg.vocab
    full = [np.concatenate([shared, s]) for s in sfx]
    geometry = dict(slots=4, max_seq=192, prompt_bucket=96, chunk_prefill=16,
                    ttft_slo_ticks=32, device="cpu")
    base = measure_serving_slo(cfg, params, _mk(full, gens), arr, **geometry)
    pfx = measure_serving_slo(cfg, params, _mk(sfx, gens), arr,
                              prefix_tokens=shared, **geometry)
    assert pfx["ttft_ticks_p50"] < base["ttft_ticks_p50"]
    assert pfx["ticks"] < base["ticks"]
    assert pfx["tokens"] == base["tokens"]


@pytest.mark.parametrize("mode", ["monolithic", "chunked", "prefix"])
def test_tick_metrics_equal_reference(mode):
    """The port's admit -> advance chunks -> decode order, its active set
    (prefilling slots excluded) and its first-token stamps give the
    reference harness's tick metrics exactly."""
    jcfg, cfg = jwl.ModelConfig.tiny(), wl.ModelConfig.tiny()
    jp = jwl.init_params(jax.random.PRNGKey(0), jcfg)
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                       "cpu")
    sfx, gens, arr = _workload(cfg, seed=5)
    shared = np.random.default_rng(6).integers(0, cfg.vocab, 30,
                                               dtype=np.int32)
    prompts = sfx if mode == "prefix" else [np.concatenate([shared, s])
                                            for s in sfx]
    kw = dict(slots=4, max_seq=192, prompt_bucket=(32, 96),
              ttft_slo_ticks=12,
              chunk_prefill=None if mode == "monolithic" else 16,
              prefix_tokens=shared if mode == "prefix" else None)
    ref = jserve.measure_serving_slo(jcfg, jp, _mk(prompts, gens,
                                                   jserve.Request), arr, **kw)
    got = measure_serving_slo(cfg, params, _mk(prompts, gens), arr,
                              device="cpu", **kw)
    assert {k: got[k] for k in TICK_KEYS} == {k: ref[k] for k in TICK_KEYS}
    assert set(got) == set(ref)


@pytest.mark.parametrize("fn", [measure_serving, measure_serving_slo])
def test_reporter_gets_one_report_a_window(model, fn):
    """The reporter is ported: each harness sends it one report, an empty
    window's included (the harness still times its one warm tick)."""
    cfg, params = model
    args = ([], []) if fn is measure_serving_slo else ([],)
    sent = []

    class Client:
        def report_status(self, reports):
            sent.extend(reports)

    from tpusched_torch.measure import GoodputReporter
    rep = GoodputReporter(Client(), "default/serve-0")
    fn(cfg, params, *args, reporter=rep, device="cpu")
    assert rep.sent == 1 and len(sent) == 1 and sent[0].throughput == 0.0
