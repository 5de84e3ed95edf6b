"""tpusched_torch.budget against tpusched.jaxbridge.budget on the CPU: the
analytic parameter count equals the port's real init, and every field of
``train_hbm_breakdown``, ``serve_hbm_breakdown`` and ``validate_plan``
equals the reference's over dtypes, remat, attention, MoE, int8 KV and the
mesh factors, the Llama-3-8B plan on a v5p-256 included; the port's
accelerator table holds the reference's memory sizes and the H100."""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from tpusched.api.topology import ACCELERATORS as JACCELERATORS
from tpusched.jaxbridge import budget as jbudget
from tpusched.jaxbridge import workload as jwl
from tpusched_torch import budget, workload as wl

torch.set_num_threads(1)

LLAMA3_8B = {"vocab": 128256, "d_model": 4096, "n_layers": 32,
             "n_heads": 32, "n_kv_heads": 8, "d_ff": 14336, "seq": 8192,
             "dtype": "bf16", "param_dtype": "f32", "attn": "flash",
             "remat": True, "vocab_parallel_loss": True}

JDT = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


def _pair(preset, **changes):
    """The port's and the reference's config of ``preset`` with
    ``changes`` (torch dtypes mapped to JAX's)."""
    if isinstance(preset, dict):
        return (wl.ModelConfig(**preset, **changes),
                jwl.ModelConfig(**preset, **{k: JDT.get(v, v) for k, v in
                                             changes.items()}))
    args = {"seq": 256} if preset != "tiny" else {}
    return (dataclasses.replace(getattr(wl.ModelConfig, preset)(**args),
                                **changes),
            dataclasses.replace(getattr(jwl.ModelConfig, preset)(**args),
                                **{k: JDT.get(v, v) for k, v in
                                   changes.items()}))


# tests/test_budget.py's four configurations
COUNT_CFGS = {
    "tiny": ("tiny", {}),
    "llama_like": ("llama_like", {}),
    "gqa": (dict(vocab=512, d_model=128, n_layers=3, n_heads=4,
                 n_kv_heads=2, d_ff=256, seq=64), {}),
    "moe": (dict(vocab=512, d_model=128, n_layers=2, n_heads=4, d_ff=256,
                 seq=64, n_experts=4, moe_top_k=2), {}),
}


@pytest.mark.parametrize("name", list(COUNT_CFGS))
def test_count_params_matches_real_init(name):
    preset, changes = COUNT_CFGS[name]
    cfg, jcfg = _pair(preset, **changes)
    real = sum(t.numel() for t in wl.tree_leaves(
        wl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")))
    assert budget.count_params(cfg) == real == jbudget.count_params(jcfg)


TRAIN_CASES = {  # name -> (preset, config changes, breakdown keywords)
    "llama_like_big": ("llama_like_big", {}, dict(accelerator="h100-80gb")),
    "big_tp2": ("llama_like_big", {}, dict(tp=2)),
    "naive_no_remat": ("llama_like", dict(attn="naive"), {}),
    "flash_no_remat": ("llama_like", dict(attn="flash"), dict(dp=2)),
    "flash_remat": ("llama_like", dict(attn="flash", remat=True),
                    dict(sp=2, accelerator="tpu-v5e")),
    "f32_master": ("llama_like_xl", dict(param_dtype=torch.float32),
                   dict(mu_dtype="f32", accelerator="tpu-v5e")),
    "bf16_state": ("llama_like_xl", {}, dict(mu_dtype="bf16",
                                             accelerator="tpu-v5e")),
    "torch_mu": ("llama_like", {}, dict(mu_dtype=torch.bfloat16,
                                        nu_dtype=torch.float32)),
    "f32_compute": ("tiny", dict(dtype=torch.float32), dict(safety=1.0)),
    "moe": ("mixtral_like", {}, dict(fsdp=2, tp=2, accelerator="tpu-v5p")),
    "vocab_parallel": ("llama_like_big", dict(vocab_parallel_loss=True),
                       dict(fsdp=4, tp=4, sp=2, dp=2,
                            accelerator="tpu-v4")),
}


def _ref_kwargs(kw):
    """The reference's keywords: its catalog has no H100, so an H100 case
    asks it for no verdict (:func:`_assert_same` adds the H100's)."""
    return {k: JDT.get(v, v) for k, v in kw.items()
            if (k, v) != ("accelerator", "h100-80gb")}


def _assert_same(got: dict, want: dict, kw) -> None:
    """Every field equal; on the H100 the verdict is the port's own table's,
    80 GiB."""
    if kw.get("accelerator") == "h100-80gb":
        want = dict(want, hbm_gib=80.0, fits=want["total_gib"] <= 80.0,
                    utilization=want["total_gib"] / 80.0)
    assert got == want


@pytest.mark.parametrize("name", list(TRAIN_CASES))
def test_train_breakdown_matches_reference(name):
    preset, changes, kw = TRAIN_CASES[name]
    cfg, jcfg = _pair(preset, **changes)
    _assert_same(budget.train_hbm_breakdown(cfg, 2, **kw).to_dict(),
                 jbudget.train_hbm_breakdown(jcfg, 2,
                                             **_ref_kwargs(kw)).to_dict(), kw)


SERVE_CASES = {  # name -> (preset, config changes, slots, max_seq, keywords)
    "big": ("llama_like_big", {}, 8, 2048, dict(accelerator="h100-80gb")),
    "big_tp2": ("llama_like_big", {}, 8, 2048, dict(tp=2)),
    "big_int8": ("llama_like_big", dict(kv_cache_dtype="int8"), 8, 2048,
                 dict(accelerator="h100-80gb")),
    "llama_v5e": ("llama_like", {}, 8, 2048, dict(accelerator="tpu-v5e")),
    "moe_int8_tp4": ("mixtral_like", dict(kv_cache_dtype="int8"), 16, 1024,
                     dict(tp=4, safety=1.25)),
    "f32": ("tiny", {}, 2, 64, {}),
}


@pytest.mark.parametrize("name", list(SERVE_CASES))
def test_serve_breakdown_matches_reference(name):
    preset, changes, slots, max_seq, kw = SERVE_CASES[name]
    cfg, jcfg = _pair(preset, **changes)
    got = budget.serve_hbm_breakdown(cfg, slots, max_seq, **kw)
    want = jbudget.serve_hbm_breakdown(jcfg, slots, max_seq,
                                       **_ref_kwargs(kw))
    _assert_same(got.to_dict(), want.to_dict(), kw)
    assert budget.tpu_memory_request_mb(got) == \
        jbudget.tpu_memory_request_mb(want)


PLANS = {
    "8b_v5p_256": {"model": LLAMA3_8B, "batch_per_replica": 1,
                   "mesh": {"dp": 8, "fsdp": 8, "tp": 4},
                   "accelerator": "tpu-v5p"},
    "8b_solo": {"model": LLAMA3_8B, "batch_per_replica": 1,
                "accelerator": "tpu-v5p"},
    "bf16_mu_sp": {"model": dict(LLAMA3_8B, param_dtype=None),
                   "batch_per_replica": 2, "mesh": {"fsdp": 16, "sp": 4},
                   "accelerator": "h100-80gb", "mu_dtype": "bf16",
                   "safety": 1.2},
    "nu_dtype": {"model": {"vocab": 512, "d_model": 128, "n_layers": 2,
                           "n_heads": 4, "d_ff": 256, "seq": 64,
                           "dtype": "f32", "n_experts": 4},
                 "mesh": {"tp": 2}, "nu_dtype": "bf16"},
}


@pytest.mark.parametrize("name", list(PLANS))
def test_validate_plan_matches_reference(name):
    plan = PLANS[name]
    got = budget.validate_plan(plan)
    want = jbudget.validate_plan(
        {k: v for k, v in plan.items()
         if (k, v) != ("accelerator", "h100-80gb")})
    _assert_same(got["breakdown"], want["breakdown"], plan)
    assert got["fits"] == got["breakdown"]["fits"]
    assert {k: v for k, v in got.items() if k not in ("breakdown", "fits")} \
        == {k: v for k, v in want.items() if k not in ("breakdown", "fits")}


def test_llama3_8b_plan_fits_v5p_256_but_not_one_chip():
    out = budget.validate_plan(PLANS["8b_v5p_256"])
    assert out["chips"] == 256 and out["fits"] is True
    assert out["breakdown"]["total_gib"] < 16
    solo = budget.validate_plan(PLANS["8b_solo"])
    assert solo["fits"] is False and solo["breakdown"]["total_gib"] > 95


def test_accelerator_table():
    for name, acc in JACCELERATORS.items():
        assert budget.ACCELERATORS[name].hbm_mb_per_chip == \
            acc.hbm_mb_per_chip
    assert budget.ACCELERATORS["h100-80gb"].hbm_mb_per_chip == 80 * 1024


@pytest.mark.parametrize("dt,width", [
    (torch.bfloat16, 2), (torch.float32, 4), (torch.int8, 1), ("bf16", 2),
    ("f32", 4), ("int8", 1), (None, 4), (jnp.bfloat16, 2)])
def test_dtype_bytes(dt, width):
    assert budget.dtype_bytes(dt) == width
