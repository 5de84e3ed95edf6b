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
    ("mixtral_like", {"kv_cache_dtype": "int8"})],
    ids=["llama_like", "mixtral_like", "mixtral_like-int8"])
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
    tps, ctx = measure.measure_decode(cfg, 2, prompt_len=8, k1=2, k2=6,
                                      repeats=1, device="cpu")
    assert tps > 0 and ctx == 8 + (2 + 6) // 2
    assert measure.decode_bandwidth_utilization(cfg, 2, ctx, tps) is None


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
        wl.ModelConfig.tiny(), 2, k1=1, k2=2, repeats=1, device="cpu")
    assert per_step > 0 and tflops > 0 and mfu is None
    assert "params+AdamW state" in note and "remat=False" in note


def test_measure_train_step_on_the_cpu():
    per_step, tflops, mfu = measure.measure_train_step(
        wl.ModelConfig.tiny(), 2, k1=1, k2=2, repeats=1, device="cpu")
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
