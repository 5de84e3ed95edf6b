"""tpusched_torch.measure against tpusched.jaxbridge.measure on the CPU: the
FLOP count (MoE terms included), the decode byte count and the slope timing
are the reference's; the train-step and decode measurements run end to end
at tiny size and make no rate claim off the card."""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusched.jaxbridge import measure as jmeasure
from tpusched.jaxbridge import workload as jwl
from tpusched_torch import measure, workload as wl

torch.set_num_threads(1)


@pytest.mark.parametrize("preset", ["tiny", "llama_like", "llama_like_big"])
@pytest.mark.parametrize("batch", [1, 4])
def test_train_step_flops_match_reference(preset, batch):
    assert measure.train_step_flops(getattr(wl.ModelConfig, preset)(),
                                    batch) == \
        jmeasure.train_step_flops(getattr(jwl.ModelConfig, preset)(), batch)


@pytest.mark.parametrize("seq", [512, 1024, 2048])
def test_moe_train_step_flops_match_reference(seq):
    assert measure.train_step_flops(wl.ModelConfig.mixtral_like(seq=seq),
                                    1) == \
        jmeasure.train_step_flops(jwl.ModelConfig.mixtral_like(seq=seq), 1)


def test_moe_flops_note_matches_reference():
    for seq, batch in ((1024, 1), (512, 4)):
        assert measure.moe_flops_note(wl.ModelConfig.mixtral_like(seq=seq),
                                      batch) == \
            jmeasure.moe_flops_note(jwl.ModelConfig.mixtral_like(seq=seq),
                                    batch)


@pytest.mark.parametrize("preset,changes", [
    ("llama_like", {}), ("mixtral_like", {}),
    ("mixtral_like", {"kv_cache_dtype": "int8"}),
    ("llama_like_big", {"kv_cache_dtype": "int8"})],
    ids=["llama_like", "mixtral_like", "mixtral_like-int8",
         "llama_like_big-int8"])
def test_decode_bytes_per_token_match_reference(preset, changes):
    cfg = dataclasses.replace(getattr(wl.ModelConfig, preset)(seq=512),
                              **changes)
    jcfg = dataclasses.replace(getattr(jwl.ModelConfig, preset)(seq=512),
                               **changes)
    for batch, ctx in ((1, 128), (8, 288), (8, 512)):
        assert measure.decode_bytes_per_token(cfg, batch, ctx) == \
            jmeasure.decode_bytes_per_token(jcfg, batch, ctx)
    f32 = dataclasses.replace(cfg, dtype=torch.float32)
    jf32 = dataclasses.replace(jcfg, dtype=jnp.float32)
    assert measure.decode_bytes_per_token(f32, 8, 288) == \
        jmeasure.decode_bytes_per_token(jf32, 8, 288)


def test_measure_decode_on_the_cpu():
    """A positive rate and the reference's mean context; no bandwidth
    utilization without a card."""
    cfg = dataclasses.replace(wl.ModelConfig.tiny(), n_experts=4)
    # a slope over 16 steps, the median of three: a loaded CPU cannot
    # turn it negative as it could one over 4 steps
    tps, ctx = measure.measure_decode(cfg, 2, prompt_len=8, k1=2, k2=18,
                                      repeats=3, device="cpu")
    assert tps > 0 and ctx == 8 + (2 + 18) // 2
    assert measure.decode_bandwidth_utilization(cfg, 2, ctx, tps) is None


def test_measure_decode_int8_cache_on_the_cpu():
    """measure_decode builds its cache from cfg, so an int8 cache needs no
    argument of its own."""
    cfg = dataclasses.replace(wl.ModelConfig.tiny(), kv_cache_dtype="int8")
    tps, ctx = measure.measure_decode(cfg, 2, prompt_len=8, k1=2, k2=18,
                                      repeats=3, device="cpu")
    assert tps > 0 and ctx == 18


def test_time_chained_is_the_reference_slope():
    times = {1: [1.0, 1.5, 1.2], 4: [2.5, 2.6, 3.9]}

    def fake(series):
        it = {k: iter(v) for k, v in series.items()}
        return lambda k: next(it[k])
    assert measure.time_chained(fake(times), 1, 4) == \
        jmeasure.time_chained(fake(times), 1, 4)


def test_measure_adamw_train_step_on_the_cpu():
    """Four fields as the reference returns them; no MFU without a card."""
    per_step, tflops, mfu, note = measure.measure_adamw_train_step(
        wl.ModelConfig.tiny(), 2, k1=1, k2=4, repeats=3, device="cpu")
    assert per_step > 0 and tflops > 0 and mfu is None
    assert "params+AdamW state" in note and "remat=False" in note


def test_measure_train_step_on_the_cpu():
    per_step, tflops, mfu = measure.measure_train_step(
        wl.ModelConfig.tiny(), 2, k1=1, k2=4, repeats=3, device="cpu")
    assert per_step > 0 and np.isfinite(tflops) and mfu is None


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 989.0), ("NVIDIA H100 PCIe", 756.0),
    ("NVIDIA A100-SXM4-80GB", None)])
def test_device_peak_tflops_by_name(monkeypatch, name, peak):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device: name)
    assert measure.device_peak_tflops("cuda:0") == peak


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 3350.0), ("NVIDIA H100 PCIe", 2000.0),
    ("NVIDIA A100-SXM4-80GB", None)])
def test_device_peak_hbm_gbps_by_name(monkeypatch, name, peak):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device: name)
    assert measure.device_peak_hbm_gbps("cuda:0") == peak


def test_no_peak_on_the_cpu():
    assert measure.device_peak_tflops("cpu") is None
    assert measure.device_peak_hbm_gbps("cpu") is None


def test_measurement_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure.measure_adamw_train_step(wl.ModelConfig.tiny(), 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure.measure_decode(wl.ModelConfig.mixtral_like(), 1)
    assert measure.device_peak_tflops() is None
    assert measure.device_peak_hbm_gbps() is None


# -- goodput reporting and calibrate --------------------------------------------


class _Recorder:
    def __init__(self):
        self.batches = []

    def report_status(self, reports):
        self.batches.append(list(reports))


def test_goodput_reporter_contract():
    """tests/test_goodput.py's emitter contract, step by step."""
    clock = {"now": 100.0}
    client = _Recorder()
    rep = measure.GoodputReporter(client, "default/train-0",
                                  gang="default/train", unit="tokens",
                                  min_interval_s=5.0,
                                  clock=lambda: clock["now"])
    assert rep.flush() is False               # an empty window says nothing
    rep.observe_step(10, 0.5, items=1000)
    rep.observe_step(11, 0.5, items=1000)
    rep.observe_stall(2.0)
    assert rep.maybe_flush() is True          # the first flush is at once
    [r] = client.batches[0]
    assert isinstance(r, measure.GangMemberStatus)
    assert r.pod_key == "default/train-0" and r.gang == "default/train"
    assert r.step == 11
    assert r.step_time_s == pytest.approx(0.5)
    assert r.throughput == pytest.approx(2000.0)
    assert r.stall_s == pytest.approx(2.0)
    assert r.timestamp == 0.0
    rep.observe_step(12, 0.4, items=800)
    assert rep.maybe_flush() is False         # within the interval
    clock["now"] += 6.0
    rep.observe_ttft(0.25)
    assert rep.maybe_flush() is True
    [r2] = client.batches[1]
    assert r2.step == 12
    assert r2.ttft_s == pytest.approx(0.25)
    assert r2.stall_s == 0.0                  # windows do not snowball
    assert rep.sent == 2


def test_gang_member_status_is_the_schedulers():
    import dataclasses as dc
    from tpusched.api.core import GangMemberStatus
    fields = [(f.name, f.default) for f in dc.fields(measure.GangMemberStatus)]
    assert fields == [(f.name, f.default) for f in dc.fields(GangMemberStatus)]


def test_goodput_reporter_feeds_the_aggregator():
    """The port's reporter → a real APIServer → GoodputAggregator: the
    duck-typed record is ingested (a dropped one would leave no goodput)."""
    from tpusched.apiserver import APIServer, Clientset
    from tpusched.obs.goodput import GoodputAggregator
    api = APIServer()
    agg = GoodputAggregator(publish=False)
    agg.attach(api)
    try:
        rep = measure.GoodputReporter(Clientset(api), "default/e2e-0",
                                      gang="default/e2e")
        rep.observe_step(1, 0.1, items=100)
        assert rep.flush() is True
        health = agg.gang_health("default/e2e")
        assert health["members_reporting"] == 1
        assert health["goodput"]["tokens"] == pytest.approx(1000.0)
        assert health["last_report_wall"] > 0
    finally:
        agg.detach()


def _serving_case():
    import jax
    from tpusched.jaxbridge import serve as jserve
    from tpusched_torch import interop, serve
    jcfg, cfg = jwl.ModelConfig.tiny(), wl.ModelConfig.tiny()
    jp = jwl.init_params(jax.random.PRNGKey(0), jcfg)
    params = interop.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                       "cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, int(rng.integers(4, 20)),
                            dtype=np.int32) for _ in range(6)]
    gens = [int(rng.integers(3, 10)) for _ in range(6)]
    arrivals = [0, 0, 1, 3, 4, 8]

    def reqs(request):
        return [request(rid=i, prompt=p, max_new_tokens=gens[i])
                for i, p in enumerate(prompts)]
    return (jserve, serve, jcfg, cfg, jp, params, reqs, arrivals,
            dict(slots=2, max_seq=64, prompt_bucket=32))


@pytest.mark.parametrize("harness", ["measure_serving", "measure_serving_slo"])
def test_serving_reporter_matches_reference(harness):
    """One report a harness: step = the engine's ticks, as jaxbridge's
    harness reports on the same requests; throughput the harness's
    tokens/s; the SLO harness's TTFT its ttft_s_p50."""
    jserve, serve, jcfg, cfg, jp, params, reqs, arrivals, geo = \
        _serving_case()
    args = (arrivals,) if harness == "measure_serving_slo" else ()
    got_client, ref_client = _Recorder(), _Recorder()
    out = getattr(serve, harness)(
        cfg, params, reqs(serve.Request), *args, device="cpu",
        reporter=measure.GoodputReporter(got_client, "default/s-0"), **geo)
    from tpusched.jaxbridge.measure import GoodputReporter
    ref_out = getattr(jserve, harness)(
        jcfg, jp, reqs(jserve.Request), *args,
        reporter=GoodputReporter(ref_client, "default/s-0"), **geo)
    [[got]], [[ref]] = got_client.batches, ref_client.batches
    assert got.step == ref.step == int(out["ticks"]) == int(ref_out["ticks"])
    assert got.throughput == pytest.approx(out["tokens_per_s"], rel=1e-6)
    assert got.ttft_s == (out["ttft_s_p50"] if args else 0.0)
    assert got.step_time_s == pytest.approx(out["elapsed_s"] / out["ticks"],
                                            rel=1e-9)


def test_measure_train_step_reports():
    client = _Recorder()
    rep = measure.GoodputReporter(client, "default/t-0")
    per_step, _, _ = measure.measure_train_step(
        wl.ModelConfig.tiny(), 2, k1=1, k2=3, repeats=1, reporter=rep,
        device="cpu")
    [[r]] = client.batches
    assert r.step == 3 and r.step_time_s == per_step
    assert r.throughput == pytest.approx(2 * wl.ModelConfig.tiny().seq
                                         / per_step)


def test_calibrate_on_the_cpu():
    """A finite positive rate from the slope of a bf16 64×64 chain (k2 long
    enough that a loaded CPU's noise cannot turn the slope negative)."""
    tflops = measure.calibrate(n=64, k1=16, k2=1024, device="cpu")
    assert np.isfinite(tflops) and tflops > 0


def test_calibrate_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure.calibrate()
