#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port, ``tpusched_torch``.

Run from the repository root on a machine with one CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the time to build the kernels from ``tpusched_torch/csrc``;
2. every kernel against its plain PyTorch version on the card;
3. the main path: ``llama_like_big`` at full width and depth (random bf16
   weights from a seeded generator) served by ``ServeEngine`` and by
   ``measure_serving`` over 16 seeded requests, with the flash kernel's
   launch count held to 12 per slot prefill;
4. engine == solo greedy generation, token for token, on ``tiny`` f32 with
   flash attention (TF32 off), with the kernel's launches counted for the
   engine and for each solo run;
5. kernel timing at the main path's shape with CUDA events, beside the
   plain version, one PyTorch library call and the card's bound.

The second-to-last line is the ``kernels`` JSON object, the last line the
``ok`` JSON object. Imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # H100 SXM, dense
PEAK_BYTES_PER_S = 3.35e12
SERVE_BUCKETS = (256, 1024)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def rand_qkv(gen, b, s, h, kv, d, dtype, pad=0):
    """Random q, k, v; with ``pad`` each is a view that skips ``pad``
    elements after every head row, so its strides are not the contiguous
    ones."""
    def r(heads):
        x = torch.randn((b, s, heads, d + pad), generator=gen,
                        device="cuda").to(dtype)
        return x[..., :d]
    return r(h), r(kv), r(kv)


def cuda_ms(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_environment(build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    t0 = time.perf_counter()
    build.build_all()
    build_s = time.perf_counter() - t0
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0),
                      "kernel_build_s": build_s}))


def tile_rel_l2(out, ref, tile: int = 64) -> float:
    """Worst relative L2 error over tiles of ``tile`` query rows: each tile
    of O is held to its own norm, so late causal rows, whose values are
    small, are held to their scale and not to that of the first rows."""
    b, s = ref.shape[:2]
    n = -(-s // tile)

    def per_tile(x):
        rows = x.float().pow(2).reshape(b, s, -1).sum(dim=(0, 2))
        return torch.nn.functional.pad(rows, (0, n * tile - s)).reshape(
            n, tile).sum(dim=1)
    return (per_tile(out.float() - ref.float()) / per_tile(ref)).sqrt() \
        .max().item()


def phase_kernel_vs_plain(attention):
    """Flash kernel vs its plain version. O: the worst 64-row tile's
    relative L2 error within 1e-2 in bf16 and 1e-4 in f32, and the max
    error within 2e-2 (bf16) or 1e-4 (f32) of max|plain|; lse within 1e-3
    absolute. Returns the main-path (s=1024) case's max abs error of O."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (b, s, h, kv, d, dtype, causal, pad)
        (1, 256, 16, 4, 128, bf16, True, 0),     # main path, small bucket
        (1, 1024, 16, 4, 128, bf16, True, 0),    # main path, large bucket
        (2, 1024, 8, 8, 128, bf16, True, 0),     # MHA
        (2, 2048, 8, 2, 128, bf16, True, 0),     # GQA 4:1
        (2, 1024, 8, 2, 128, bf16, True, 0),     # GQA
        (2, 512, 4, 1, 128, bf16, True, 0),      # MQA
        (2, 4096, 4, 4, 128, bf16, True, 0),     # long MHA
        (1, 1000, 16, 4, 128, bf16, True, 0),    # ragged last tile
        (1, 1024, 16, 4, 128, bf16, False, 0),   # non-causal
        (2, 200, 4, 2, 64, bf16, True, 0),       # head_dim 64, ragged
        (1, 96, 2, 2, 32, bf16, False, 0),       # tiny's head_dim
        (2, 300, 4, 2, 64, f32, True, 0),        # f32, ragged
        (1, 64, 2, 2, 32, f32, False, 3),        # f32, strided
        (1, 16, 2, 2, 32, f32, True, 0),         # phase 4's engine prefill
        (1, 13, 2, 2, 32, f32, True, 0),         # phase 4's solo prefill
    ]
    main_err = None
    for b, s, h, kv, d, dtype, causal, pad in cases:
        q, k, v = rand_qkv(gen, b, s, h, kv, d, dtype, pad)
        out, lse = attention.flash_forward(q, k, v, causal)
        torch.cuda.synchronize()
        ref, ref_lse = attention.flash_attention_plain(q, k, v, causal)
        err = (out.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        l2 = tile_rel_l2(out, ref)
        rms = ref.float().pow(2).mean().sqrt().item()
        lse_err = (lse - ref_lse).abs().max().item()
        tol_l2, tol = (1e-2, 2e-2) if dtype == bf16 else (1e-4, 1e-4)
        print(f"kernel vs plain b={b} s={s} h={h} kv={kv} d={d} "
              f"{str(dtype)[6:]} causal={causal} pad={pad}: worst-tile "
              f"rel L2 {l2:.3e} (tol {tol_l2}), max|err| {err:.3e} = "
              f"{rel:.3e} of max|plain| (tol {tol}), rms(plain) {rms:.3e}, "
              f"lse {lse_err:.3e} (tol 1e-3)")
        check(out.shape == q.shape and lse.shape == (b * h, s, 1),
              "flash output shapes")
        check(l2 < tol_l2 and rel < tol and lse_err < 1e-3,
              f"flash kernel disagrees with its plain version at "
              f"{(b, s, h, kv, d, dtype, causal, pad)}")
        if (b, s, h, kv, d, dtype, causal, pad) == (1, 1024, 16, 4, 128,
                                                    bf16, True, 0):
            main_err = err
    # the bf16 kernel's 16-byte loads: an unaligned view is refused
    q, k, v = rand_qkv(gen, 1, 64, 2, 2, 64, bf16, pad=2)
    try:
        attention.flash_forward(q, k, v, True)
    except ValueError:
        pass
    else:
        raise RuntimeError("flash kernel took unaligned bf16 rows")
    return main_err


def make_requests(cfg, serve):
    rng = np.random.default_rng(0)
    return [serve.Request(
        rid=i,
        prompt=rng.integers(0, cfg.vocab, size=int(rng.integers(64, 1025)),
                            dtype=np.int32),
        max_new_tokens=int(rng.integers(16, 129)))
        for i in range(16)]


def phase_serving(attention, serve, workload):
    """Full-width llama_like_big serving. Returns the flash launches of the
    main path run."""
    cfg = workload.ModelConfig.llama_like_big()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = workload.init_params(cfg, gen, "cuda")
    reqs = make_requests(cfg, serve)
    want_tokens = sum(r.max_new_tokens for r in reqs)
    geometry = dict(slots=8, max_seq=2048, prompt_bucket=SERVE_BUCKETS)

    # the main path as a user drives it: engine, warmup, submit, drain
    attention.FLASH_FWD_LAUNCHES = 0
    eng = serve.ServeEngine(params, cfg, device="cuda", **geometry)
    eng.warmup()
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    launches = attention.FLASH_FWD_LAUNCHES
    check(launches > 0, "the serving path launched no flash kernel")
    check(launches == cfg.n_layers * eng.prefills,
          f"{launches} flash launches for {eng.prefills} prefills of "
          f"{cfg.n_layers} layers")
    check(sorted(c.rid for c in done) == list(range(len(reqs))),
          "not every request completed")
    for c in done:
        want = reqs[c.rid].max_new_tokens
        check(len(c.tokens) == want, f"request {c.rid}: {len(c.tokens)} "
              f"tokens, wanted {want}")
        check(bool(((c.tokens >= 0) & (c.tokens < cfg.vocab)).all()),
              f"request {c.rid}: token outside the vocabulary")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    prefills = eng.prefills
    del eng

    # the same traffic through measure_serving, the throughput entry point
    attention.FLASH_FWD_LAUNCHES = 0
    stats = serve.measure_serving(cfg, params, reqs, device="cuda",
                                  **geometry)
    measured_launches = attention.FLASH_FWD_LAUNCHES
    check(measured_launches == cfg.n_layers * stats["prefills"],
          f"measure_serving: {measured_launches} flash launches for "
          f"{stats['prefills']} prefills")
    check(stats["tokens"] == want_tokens, "measure_serving lost tokens")
    print(json.dumps({
        "serving": "llama_like_big", "requests": len(reqs),
        "slots": geometry["slots"], "max_seq": geometry["max_seq"],
        "buckets": list(SERVE_BUCKETS), "prefills": prefills,
        "flash_launches": launches, "tokens": stats["tokens"],
        "tokens_per_s": stats["tokens_per_s"],
        "occupancy": stats["occupancy"], "ticks": stats["ticks"],
        "max_tick_gap_s": stats["max_tick_gap_s"],
        "elapsed_s": stats["elapsed_s"], "peak_mem_gib": peak_gib}))
    return launches


def phase_parity(attention, decode, serve, workload):
    """Engine == solo greedy generation on tiny f32 with flash attention,
    both through the kernel (launches counted for each). TF32 is off so
    float32 products are full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(workload.ModelConfig.tiny(), attn="flash")
    params = workload.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    rng = np.random.default_rng(2)
    reqs = [serve.Request(
        rid=i, prompt=rng.integers(0, cfg.vocab,
                                   size=int(rng.integers(4, 14)),
                                   dtype=np.int32),
        max_new_tokens=int(rng.integers(3, 8))) for i in range(5)]
    eng = serve.ServeEngine(params, cfg, slots=2, max_seq=64,
                            prompt_bucket=16, device="cuda")
    attention.FLASH_FWD_LAUNCHES = 0
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    check(attention.FLASH_FWD_LAUNCHES == cfg.n_layers * eng.prefills,
          f"tiny engine: {attention.FLASH_FWD_LAUNCHES} flash launches for "
          f"{eng.prefills} prefills of {cfg.n_layers} layers")
    check(sorted(c.rid for c in done) == list(range(5)),
          "tiny engine lost a request")
    for c in done:
        req = reqs[c.rid]
        attention.FLASH_FWD_LAUNCHES = 0
        solo = decode.generate(
            params, torch.as_tensor(req.prompt, device="cuda")[None].long(),
            cfg, steps=req.max_new_tokens - 1)[0].cpu().numpy()
        check(attention.FLASH_FWD_LAUNCHES == cfg.n_layers,
              f"solo generate: {attention.FLASH_FWD_LAUNCHES} flash "
              f"launches for one prefill of {cfg.n_layers} layers")
        check(np.array_equal(c.tokens, solo),
              f"request {c.rid}: engine {c.tokens} != solo {solo}")
    print(f"engine == solo on tiny f32 flash: {len(done)} requests, "
          f"{eng.prefills} engine prefills")


def phase_timing(attention):
    """Times at the main path's large-bucket shape. The inputs (10.6 MB)
    stay in the 50 MB L2 across launches, as a prefill's freshly computed
    q/k/v would be."""
    b, s, h, kv, d, dtype = 1, 1024, 16, 4, 128, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = rand_qkv(gen, b, s, h, kv, d, dtype)
    counted = attention.FLASH_FWD_LAUNCHES
    ms = cuda_ms(lambda: attention.flash_forward(q, k, v, True))
    attention.FLASH_FWD_LAUNCHES = counted   # timing launches are not counted
    plain_ms = cuda_ms(lambda: attention.flash_attention_plain(q, k, v, True))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    flops = 4 * b * h * d * s * (s + 1) / 2     # causal: k <= q pairs only
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
        + b * h * s * 4                         # q, k, v, O, lse
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    print(json.dumps({"timing": "flash_fwd", "shape": [b, s, h, kv, d],
                      "flops": flops, "bytes": nbytes, "ms": ms,
                      "plain_ms": plain_ms, "library_ms": library_ms}))
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from tpusched_torch import _build, attention, decode, serve, workload

    phase_environment(_build)
    max_abs_err = phase_kernel_vs_plain(attention)
    launches = phase_serving(attention, serve, workload)
    phase_parity(attention, decode, serve, workload)
    timing = phase_timing(attention)
    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "tpusched_torch/csrc/flash_fwd.cu",
        "replaces": "tpusched/jaxbridge/attention.py:91",
        "launches": launches, "max_abs_err": max_abs_err, **timing}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
