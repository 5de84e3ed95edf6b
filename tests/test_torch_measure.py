"""tpusched_torch.measure against tpusched.jaxbridge.measure on the CPU: the
FLOP count and the slope timing are the reference's; the train-step
measurements run end to end at tiny size and make no rate claim off the
card."""
from __future__ import annotations

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


def test_no_peak_on_the_cpu():
    assert measure.device_peak_tflops("cpu") is None


def test_measurement_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        measure.measure_adamw_train_step(wl.ModelConfig.tiny(), 1)
    assert measure.device_peak_tflops() is None
