"""tpusched_torch.bench, the port's runner of the reference's on-chip
workload lines (``bench.py``'s ``bench_tpu_workload``), on the CPU.

Every line group runs at tiny sizes and prints lines with the reference's
``emit`` keys; the request sets at the reference's sizes are the arrays
the reference's own recipe draws; the fields that do not depend on time
(occupancy, speculative rounds and acceptance, target and plain streams,
FLOPs, the MoE note, the HBM budget's GiB) equal jaxbridge's functions on
the same weights and requests; a failing line stops the run with a
non-zero exit; and without a card the runner runs only when told
``--device cpu``."""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusched.jaxbridge import budget as jbudget
from tpusched.jaxbridge import measure as jmeasure
from tpusched.jaxbridge import serve as jserve
from tpusched.jaxbridge import spec_decode as jsd
from tpusched.jaxbridge import workload as jwl
from tpusched_torch import bench
from tpusched_torch import workload as wl

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
EMIT_KEYS = ["metric", "value", "unit", "vs_baseline"]
LINE_COUNTS = {name: 1 for name in bench.LINES} | {"train_155m": 2,
                                                   "slo": 2}
JDT = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}


@pytest.fixture(scope="module")
def ctx():
    return bench.context("cpu", tiny=True)


@pytest.fixture(scope="module")
def lines(ctx):
    """Every line group run once on the tiny context: name -> parsed
    lines."""
    out = {}
    for name, fn in bench.LINES.items():
        buf = io.StringIO()
        ctx.start(name)
        with contextlib.redirect_stdout(buf):
            fn(ctx)
        out[name] = [json.loads(t) for t in buf.getvalue().splitlines()]
    return out


def _jcfg(cfg: wl.ModelConfig) -> jwl.ModelConfig:
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(wl.ModelConfig)}
    fields["dtype"] = JDT[cfg.dtype]
    return jwl.ModelConfig(**fields)


def _jparams(params):
    """The port's weights as the reference's tree (the same structure)."""
    return jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
        JDT[t.dtype]), params)


def _jreqs(reqs):
    return [jserve.Request(rid=r.rid, prompt=r.prompt,
                           max_new_tokens=r.max_new_tokens) for r in reqs]


@pytest.mark.parametrize("name", list(bench.LINES))
def test_every_line_prints_the_references_emit_keys(lines, name):
    got = lines[name]
    assert len(got) == LINE_COUNTS[name]
    for rec in got:
        assert list(rec)[:4] == EMIT_KEYS
        assert isinstance(rec["metric"], str) and rec["metric"]
        assert isinstance(rec["value"], float) and np.isfinite(rec["value"])
        assert isinstance(rec["unit"], str) and rec["unit"]
        assert rec["vs_baseline"] is None or isinstance(
            rec["vs_baseline"], float)
        assert rec["line"] == name and rec["card"] == "cpu"
        assert rec["peaks_gib"] and all(
            p is None for p in rec["peaks_gib"].values())
        assert "v5e" not in rec["metric"]


def test_lines_run_in_the_references_order():
    assert list(bench.LINES) == [
        "calibrate", "train_155m", "long_context", "adamw_0_67b",
        "adamw_xl", "moe_train", "decode", "serving", "chunked",
        "spec_solo", "spec_serving", "int8_serving", "slo"]


# -- the request sets: the reference's recipe as written in bench.py --------

def _ref_serving(vocab):                                 # bench.py:2318-2324
    rng = np.random.default_rng(0)
    return [jserve.Request(rid=i,
                           prompt=rng.integers(0, vocab,
                                               size=int(rng.integers(32,
                                                                     128)),
                                               dtype=np.int32),
                           max_new_tokens=int(rng.integers(16, 128)))
            for i in range(32)]


def _ref_long(vocab):                                    # bench.py:2342-2348
    rng = np.random.default_rng(1)
    return [jserve.Request(rid=i,
                           prompt=rng.integers(
                               0, vocab,
                               size=int(rng.integers(256, 448)),
                               dtype=np.int32),
                           max_new_tokens=int(rng.integers(16, 64)))
            for i in range(16)]


def _ref_spec_serving(vocab):                            # bench.py:2422-2427
    rng = np.random.default_rng(3)
    return [jserve.Request(rid=i,
                           prompt=rng.integers(0, vocab,
                                               size=int(rng.integers(32, 96)),
                                               dtype=np.int32),
                           max_new_tokens=int(rng.integers(32, 96)))
            for i in range(16)]


def _ref_int8(vocab):                                    # bench.py:2453-2459
    rng = np.random.default_rng(5)
    return [jserve.Request(rid=i,
                           prompt=rng.integers(0, vocab,
                                               size=int(rng.integers(
                                                   512, 1024)),
                                               dtype=np.int32),
                           max_new_tokens=int(rng.integers(32, 96)))
            for i in range(12)]


def _ref_slo(vocab):                                     # bench.py:2486-2493
    rng = np.random.default_rng(42)
    n = 24
    prompts = [rng.integers(0, vocab,
                            int(rng.integers(48, 192)),
                            dtype=np.int32) for _ in range(n)]
    slo_reqs = [jserve.Request(rid=i, prompt=p,
                               max_new_tokens=int(rng.integers(16, 96)))
                for i, p in enumerate(prompts)]
    arrivals = np.cumsum(rng.poisson(4.0, size=n)).tolist()
    return slo_reqs, arrivals


def _same_requests(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.rid == w.rid and g.max_new_tokens == w.max_new_tokens
        assert g.prompt.dtype == w.prompt.dtype == np.int32
        np.testing.assert_array_equal(g.prompt, w.prompt)


@pytest.mark.parametrize("vocab", [32000, 256])
@pytest.mark.parametrize("name,ref", [
    ("serving", _ref_serving), ("long_prompts", _ref_long),
    ("spec_serving", _ref_spec_serving), ("int8", _ref_int8)])
def test_request_sets_are_the_references(name, ref, vocab):
    _same_requests(getattr(bench.Sizes(), name).draw(vocab), ref(vocab))


@pytest.mark.parametrize("vocab", [32000, 256])
def test_slo_requests_and_arrivals_are_the_references(vocab):
    reqs, arrivals = bench.slo_requests(vocab, bench.Sizes().slo)
    want, want_arrivals = _ref_slo(vocab)
    _same_requests(reqs, want)
    assert arrivals == want_arrivals


def test_sizes_are_the_references():
    """The numbers ``bench_tpu_workload`` passes, as the runner's
    defaults."""
    s = bench.Sizes()
    assert (s.calibrate_n, s.train, s.long, s.ratio, s.big_seq,
            s.moe_seq) == (4096, (2048, 8), (8192, 2), (4096, 4), 4096, 1024)
    assert (s.serve_seq, s.decode_batch, s.slots, s.serve_bucket,
            s.long_bucket, s.chunk) == (512, 8, 8, 128, 448, 64)
    assert (s.spec_prompt, s.spec_steps, s.spec_k) == (64, 127, 4)
    assert (s.int8_seq, s.int8_bucket, s.slo_bucket,
            s.slo_ttft_ticks) == (2048, 1024, 192, 32)
    assert s.decode_steps == (128, 64, 256)   # measure_decode's defaults
    models = bench.full_models()
    for name in models:
        assert models[name](777) == getattr(wl.ModelConfig, name)(seq=777)


# -- the deterministic fields against jaxbridge ----------------------------

def _train_cfgs(ctx):
    """Each train line's configurations and batches, as the line builds
    them."""
    s = ctx.sizes
    llama = ctx.model("llama_like", s.train[0])
    return {
        "train_155m": [(dataclasses.replace(llama, attn="flash"),
                        s.train[1]), (llama, s.train[1])],
        "long_context": [(dataclasses.replace(
            ctx.model("llama_like", s.long[0]), attn="flash"), s.long[1])],
        "adamw_0_67b": [(ctx.model("llama_like_big", s.big_seq), 1)],
        "adamw_xl": [(ctx.model("llama_like_xl", s.big_seq), 1)],
        "moe_train": [(ctx.model("mixtral_like", s.moe_seq), 1)],
    }


@pytest.mark.parametrize("name", ["train_155m", "long_context",
                                  "adamw_0_67b", "adamw_xl", "moe_train"])
def test_train_step_flops_match_reference(ctx, lines, name):
    for rec, (cfg, batch) in zip(lines[name], _train_cfgs(ctx)[name]):
        assert rec["batch"] == batch
        assert rec["model"]["params"] == jbudget.count_params(_jcfg(cfg))
        assert rec["train_step_flops"] == jmeasure.train_step_flops(
            _jcfg(cfg), batch)


def test_moe_flops_note_matches_reference(ctx, lines):
    [rec] = lines["moe_train"]
    [(cfg, batch)] = _train_cfgs(ctx)["moe_train"]
    want = jmeasure.moe_flops_note(_jcfg(cfg), batch)
    assert rec["moe_flops_note"] == want and want in rec["metric"]


def test_xl_budget_and_gate(ctx, lines):
    """The budget's GiB equal jaxbridge's (whose catalog has no H100: the
    verdict is the port's, 80 GiB); the gate trained pure-bf16 with a
    falling loss."""
    [rec] = lines["adamw_xl"]
    [(cfg, _)] = _train_cfgs(ctx)["adamw_xl"]
    want = jbudget.train_hbm_breakdown(_jcfg(cfg), 1,
                                       mu_dtype="bf16").to_dict()
    assert rec["budget"].keys() == want.keys()
    for key in ("params_gib", "optimizer_gib", "grads_gib",
                "activations_gib", "logits_gib", "total_gib", "n_params",
                "note"):
        assert rec["budget"][key] == want[key], key
    assert rec["budget"]["hbm_gib"] == 80.0
    assert rec["budget"]["fits"] is True
    gate = rec["gate"]
    assert gate["mu_dtype"] == gate["nu_dtype"] == "bfloat16"
    assert len(gate["losses"]) == bench.XL_GATE_STEPS
    assert gate["losses"][-1] < gate["losses"][0] and gate["moments_finite"]


def test_int8_arena_gib_matches_reference(ctx, lines):
    [rec] = lines["int8_serving"]
    cfg = _jcfg(ctx.model("llama_like", ctx.sizes.int8_seq))
    slots, seq = ctx.sizes.slots, ctx.sizes.int8_seq
    assert rec["arena_gib"] == {
        "exact": jbudget.serve_hbm_breakdown(cfg, slots, seq).kv_arena_gib,
        "int8": jbudget.serve_hbm_breakdown(
            dataclasses.replace(cfg, kv_cache_dtype="int8"), slots,
            seq).kv_arena_gib}


@pytest.fixture(scope="module")
def reference(ctx):
    """jaxbridge's serving model on the port's serving weights, and its
    harness's geometry."""
    cfg, params = bench._serving_model(ctx)
    geo = dict(slots=ctx.sizes.slots, max_seq=ctx.sizes.serve_seq)
    return _jcfg(cfg), _jparams(params), geo


def test_serving_occupancy_matches_reference(ctx, lines, reference):
    jcfg, jp, geo = reference
    [rec] = lines["serving"]
    want = jserve.measure_serving(
        jcfg, jp, _jreqs(ctx.sizes.serving.draw(jcfg.vocab)),
        prompt_bucket=ctx.sizes.serve_bucket, **geo)
    for key in ("occupancy", "ticks", "tokens"):
        assert rec[key] == want[key], key


def test_chunked_occupancy_matches_reference(ctx, lines, reference):
    jcfg, jp, geo = reference
    [rec] = lines["chunked"]
    reqs = _jreqs(ctx.sizes.long_prompts.draw(jcfg.vocab))
    for mode, kw in (("monolithic", {}),
                     ("chunked", {"chunk_prefill": ctx.sizes.chunk})):
        want = jserve.measure_serving(jcfg, jp, reqs,
                                      prompt_bucket=ctx.sizes.long_bucket,
                                      **geo, **kw)
        for key in ("occupancy", "ticks", "tokens"):
            assert rec[mode][key] == want[key], (mode, key)


def test_speculative_serving_stats_match_reference(ctx, lines, reference):
    jcfg, jp, geo = reference
    [rec] = lines["spec_serving"]
    want = jserve.measure_serving(
        jcfg, jp, _jreqs(ctx.sizes.spec_serving.draw(jcfg.vocab)),
        prompt_bucket=ctx.sizes.serve_bucket, draft_params=jp,
        draft_cfg=jcfg, spec_k=ctx.sizes.spec_k, **geo)
    for key in ("spec_rounds", "spec_accepted", "spec_drafted",
                "occupancy", "tokens"):
        assert rec[key] == want[key], key
    assert rec["spec_accepted"] <= rec["spec_drafted"]


def test_solo_speculation_calls_match_reference(ctx, lines):
    [rec] = lines["spec_solo"]
    cfg = ctx.model("llama_like", ctx.sizes.serve_seq)
    jp = _jparams(bench.seeded_params(ctx, cfg, 1))
    prompt = torch.randint(0, cfg.vocab, (1, ctx.sizes.spec_prompt),
                           generator=torch.Generator().manual_seed(2))
    _, want = jsd.speculative_generate(
        jp, _jcfg(cfg), jp, _jcfg(cfg), jnp.asarray(prompt.numpy()),
        ctx.sizes.spec_steps, k=ctx.sizes.spec_k)
    for key in ("target_calls", "plain_calls", "drafted", "accepted"):
        assert rec[key] == want[key], key
    assert rec["plain_calls"] == ctx.sizes.spec_steps + 1


def test_slo_tick_metrics_match_reference(ctx, lines, reference):
    jcfg, jp, geo = reference
    reqs, arrivals = bench.slo_requests(jcfg.vocab, ctx.sizes.slo)
    for rec, kw in zip(lines["slo"],
                       ({}, {"chunk_prefill": ctx.sizes.chunk})):
        want = jserve.measure_serving_slo(
            jcfg, jp, _jreqs(reqs), arrivals,
            prompt_bucket=ctx.sizes.slo_bucket,
            ttft_slo_ticks=ctx.sizes.slo_ttft_ticks, **geo, **kw)
        for key in ("ttft_ticks_p50", "ttft_ticks_p99", "ticks", "tokens",
                    "slo_attainment", "goodput_tokens_per_tick"):
            assert rec[key] == want[key], key
        assert rec["vs_baseline"] == round(want["slo_attainment"], 3)


def test_naive_score_bytes_are_what_autograd_keeps():
    """The score tensors a naive train step saves for its backward: the
    b·h·s² tensors among autograd's saved tensors, counted once a
    storage."""
    # seq 48: no other saved tensor has the scores' element count
    cfg = dataclasses.replace(wl.ModelConfig.tiny(), n_heads=4,
                              n_kv_heads=2, seq=48, dtype=torch.bfloat16)
    batch = 2
    params = wl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for p in wl.tree_leaves(params):
        p.requires_grad_(True)
    tokens = torch.randint(0, cfg.vocab, (batch, cfg.seq),
                           generator=torch.Generator().manual_seed(1))
    saved = {}

    def pack(t):
        # the product with V may save the probabilities reshaped
        if t.shape[-1] == cfg.seq and \
                t.numel() == batch * cfg.n_heads * cfg.seq ** 2:
            saved[t.untyped_storage().data_ptr()] = t.numel() * \
                t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        wl.loss_fn(params, tokens, cfg)
    assert sum(saved.values()) == bench.naive_score_bytes(cfg, batch)


# -- the command line ------------------------------------------------------

def _run(*args, code: str):
    return subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_a_failing_line_stops_the_run_with_a_non_zero_exit():
    r = _run("--device", "cpu", "--lines", "serving,calibrate,decode",
             code=("import functools, sys\n"
                   "from tpusched_torch import bench\n"
                   "bench.context = functools.partial(bench.context, "
                   "tiny=True)\n"
                   "def fail(ctx):\n"
                   "    raise RuntimeError('the decode line failed')\n"
                   "bench.LINES['decode'] = fail\n"
                   "sys.exit(bench.main(sys.argv[1:]))\n"))
    assert r.returncode != 0
    assert "the decode line failed" in r.stderr
    got = [json.loads(t)["line"] for t in r.stdout.splitlines()]
    assert got == ["calibrate"]          # serving, after decode, never ran


def test_main_stops_at_the_failing_line(monkeypatch, capsys):
    def fail(ctx):
        raise RuntimeError("the calibrate line failed")
    monkeypatch.setitem(bench.LINES, "calibrate", fail)
    monkeypatch.setattr(bench, "context",
                        functools.partial(bench.context, tiny=True))
    with pytest.raises(RuntimeError, match="calibrate line failed"):
        bench.main(["--device", "cpu", "--lines", "calibrate,decode"])
    assert capsys.readouterr().out == ""


def test_timing_above_the_peak_is_refused(monkeypatch, capsys, ctx):
    monkeypatch.setattr(bench.measure, "device_peak_tflops", lambda d: 1.0)
    monkeypatch.setattr(bench.measure, "calibrate", lambda **kw: 2.0)
    ctx.start("calibrate")
    with pytest.raises(RuntimeError, match="timing invalid"):
        bench.line_calibrate(ctx)
    [rec] = [json.loads(t) for t in capsys.readouterr().out.splitlines()]
    assert rec["metric"].startswith("TIMING INVALID") and rec["value"] == 2.0


def test_a_divergence_beyond_a_near_tie_fails(monkeypatch, ctx, capsys):
    """spec_solo: a stream that leaves plain decoding with a margin above
    1/32 fails the run; within it, the reference's divergence line."""
    for margin, fails in ((0.5, True), (0.01, False)):
        monkeypatch.setattr(bench, "first_difference",
                            lambda *a, m=margin: {"index": 3, "margin": m})
        ctx.start("spec_solo")
        if fails:
            with pytest.raises(RuntimeError, match="without a near tie"):
                bench.line_spec_solo(ctx)
            assert capsys.readouterr().out == ""
        else:
            bench.line_spec_solo(ctx)
            [rec] = [json.loads(t)
                     for t in capsys.readouterr().out.splitlines()]
            assert rec["metric"].startswith(
                "speculative decode DIVERGED from plain greedy at token 3")
            assert rec["value"] is None
            assert rec["near_tie"]["margin"] == margin


def test_no_card_and_no_cpu_flag_is_refused(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--lines", "decode"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.context()


def test_the_command_line_refuses_without_a_card():
    r = subprocess.run([sys.executable, "-m", "tpusched_torch.bench",
                        "--lines", "decode"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert r.returncode == 1 and r.stdout == ""
    assert "no CUDA device" in r.stderr


def test_unknown_lines_are_refused(capsys):
    with pytest.raises(SystemExit) as e:
        bench.main(["--device", "cpu", "--lines", "decode,nope"])
    assert e.value.code == 2 and "nope" in capsys.readouterr().err
