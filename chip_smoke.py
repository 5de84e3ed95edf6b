#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port, ``tpusched_torch``.

Run from the repository root on a machine with one CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   the time to build the kernels from ``tpusched_torch/csrc`` and each
   kernel's registers and spills as ``ptxas`` reports them; it fails if a
   Hopper kernel (wgmma, TMA) spills, ``ptxas`` ignored ``setmaxnreg`` or
   serialized a kernel's ``wgmma``, or a kernel's ``setmaxnreg`` split asks
   for more registers than its launch holds;
2. every kernel against its plain PyTorch version on the card: the flash
   forward (K1), then the backward's dK/dV (K2) and dQ (K3) kernels, whose
   gradients must also come out bitwise equal when run twice;
3. the serving path: ``llama_like_big`` at full width and depth (random
   bf16 weights from a seeded generator) served by ``ServeEngine`` and by
   ``measure_serving`` over 16 seeded requests, with the flash kernel's
   launch count held to 12 per slot prefill;
4. engine == solo greedy generation, token for token, on ``tiny`` f32 with
   flash attention (TF32 off), with the kernel's launches counted for the
   engine and for each solo run;
5. gradients on ``tiny`` f32 (flash, remat) through the kernels against
   the same run through naive attention, launches counted;
6. the training path: ``llama_like_big(seq=4096)``, batch 1, five AdamW
   steps with launches counted per step and a falling loss, then
   ``measure.measure_adamw_train_step`` (step time, tokens/s, MFU);
7. kernel timing with CUDA events, K1 at the serving shape (also inside a
   CUDA graph, which leaves out the host's enqueue time) and K1, K2, K3 at
   the training shape, beside the plain versions, one PyTorch library call
   and the card's bound, and K2 then K3 together beside the library's whole
   backward; K2's schedule balance at the training shape;
8. the MoE serving path: ``mixtral_like`` at full width and depth served as
   in phase 3; its attention is naive, so the flash kernel must not launch;
9. engine == solo as in phase 4 on ``tiny`` f32 with 4 experts, naive and
   flash (launches counted);
10. the MoE training path: ``mixtral_like(seq=1024)``, batch 1, five SGD
    steps with a falling loss and a positive aux loss, then
    ``measure.measure_train_step``; tiny f32 MoE gradients on the card
    against the CPU's;
11. MoE decode: ``measure.measure_decode`` on ``mixtral_like(seq=512)`` at
    batch 8, with its HBM bandwidth utilization.

The second-to-last line is the ``kernels`` JSON object, the last line the
``ok`` JSON object. Imports neither JAX nor the JAX package.

    python3 chip_smoke.py --ab DIR

instead times the flash kernels of another tree's ``tpusched_torch`` (under
DIR) and of this one in turns on the card (:func:`ab`) and runs no phase.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # H100 SXM, dense
PEAK_BYTES_PER_S = 3.35e12
SERVE_BUCKETS = (256, 1024)
# the kernels redesigned for Hopper (wgmma, TMA, setmaxnreg), bf16 d=128,
# each with its setmaxnreg split: (consumer, producer) registers a thread,
# two consumer warpgroups and one producer warpgroup of 128 threads
HOPPER_KERNELS = {"flash_fwd_sm90": (240, 24), "flash_bwd_dkdv_sm90": (232, 40),
                  "flash_bwd_dq_sm90": (240, 24)}


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


def graph_launch_ms(fn, launches: int = 20, replays: int = 10) -> float:
    """Device time per call of ``fn``: ``launches`` calls captured in one
    CUDA graph, replayed, timed with CUDA events; unlike :func:`cuda_ms`
    it leaves out the host's time to enqueue each call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                # warm outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


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
    built = build.build_all()
    build_s = time.perf_counter() - t0
    logs = build.build_logs()
    usage = ptxas_usage(logs)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0),
                      "kernel_build_s": build_s, "built": sorted(built),
                      "registers_spill_stores": usage}))
    for name, (consumer, producer) in HOPPER_KERNELS.items():
        check(name in usage, f"ptxas reported nothing for {name}")
        check(usage[name][1] == 0, f"{name} spills: {usage[name]}")
        # setmaxnreg moves only the registers the block got at launch; a
        # split over them leaves setmaxnreg.inc waiting forever
        check((2 * consumer + producer) * 128 <= 3 * 128 * usage[name][0],
              f"{name}: setmaxnreg split {consumer}/{producer} exceeds the "
              f"384 x {usage[name][0]} registers of its launch")
    text = "\n".join(logs.values())
    check("C7508" not in text and "setmaxnreg ignored" not in text,
          "ptxas ignored setmaxnreg")
    serialized = [line for line in text.splitlines()
                  if "wgmma.mma_async instructions are serialized" in line]
    check(not serialized, f"ptxas serialized wgmma: {serialized}")


def ptxas_usage(logs) -> dict:
    """{"kernel<head_dim>" or "kernel": [registers, spill store bytes]} from
    the ``-Xptxas -v`` lines of the build logs. Registers are those the
    kernel starts with; a Hopper kernel's consumer warpgroups then take more
    through setmaxnreg (:data:`HOPPER_KERNELS`)."""
    usage, name = {}, None
    for line in "\n".join(logs.values()).splitlines():
        m = re.search(r"\d(flash_\w+?)(?:ILi(\d+)E|E)", line)
        if "Compiling entry function" in line and m:
            name = m[1] + (f"<{m[2]}>" if m[2] else "")
            usage[name] = [None, None]
        elif name and (m := re.search(r"(\d+) bytes spill stores", line)):
            usage[name][1] = int(m[1])
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            usage[name][0] = int(m[1])
    return usage


def tile_rel_l2(out, ref, tile: int = 64, floor: float = 0.0) -> float:
    """Worst relative L2 error over tiles of ``tile`` query rows: each tile
    of O is held to its own norm, so late causal rows, whose values are
    small, are held to their scale and not to that of the first rows. A
    tile whose norm per element is below ``floor`` is held to the floor (a
    gradient that is zero in exact arithmetic, as dq and dk at s = 1)."""
    b, s = ref.shape[:2]
    n = -(-s // tile)

    def per_tile(x):
        rows = x.float().pow(2).reshape(b, s, -1).sum(dim=(0, 2))
        return torch.nn.functional.pad(rows, (0, n * tile - s)).reshape(
            n, tile).sum(dim=1)
    size = per_tile(torch.ones_like(ref, dtype=torch.float32))
    den = torch.maximum(per_tile(ref), floor ** 2 * size)
    return (per_tile(out.float() - ref.float()) / den).sqrt().max().item()


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
        (1, 129, 16, 4, 128, bf16, True, 0),     # ragged at a 128-row tile
        (1, 1, 16, 4, 128, bf16, True, 0),       # s below one tile
        (1, 17, 16, 4, 128, bf16, True, 0),
        (1, 1024, 8, 1, 128, bf16, True, 0),     # MQA 8:1
        (2, 512, 8, 2, 128, bf16, True, 8),      # strided, 16-byte aligned
        (1, 4096, 16, 4, 128, bf16, False, 0),   # non-causal, training shape
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


def phase_backward_vs_plain(attention):
    """K2 (dk, dv) and K3 (dq) vs their plain version: for each gradient
    the worst 64-row tile's relative L2 error within 2e-2 in bf16 and 1e-4
    in f32 (a tile below 1e-3 per element held to that floor). Run twice on
    the same inputs, both kernels give bitwise equal dq, dk and dv. The
    last case hands in a D that is not Σ dO∘O: both versions must use it.
    Returns the training shape's max abs errors (dq, max of dk and dv)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (b, s, h, kv, d, dtype, causal, pad, given dd)
        (1, 4096, 16, 4, 128, bf16, True, 0, False),   # the training shape
        (1, 1024, 16, 4, 128, bf16, True, 0, False),
        (2, 1024, 8, 8, 128, bf16, True, 0, False),    # MHA
        (2, 512, 4, 1, 128, bf16, True, 0, False),     # MQA
        (1, 1000, 16, 4, 128, bf16, True, 0, False),   # ragged last tile
        (1, 1024, 16, 4, 128, bf16, False, 0, False),  # ring-flash pairs
        (1, 129, 16, 4, 128, bf16, True, 0, False),    # ragged past 128 rows
        (1, 1, 16, 4, 128, bf16, True, 0, False),      # s below one tile
        (1, 17, 16, 4, 128, bf16, True, 0, False),
        (1, 1024, 8, 1, 128, bf16, True, 0, False),    # MQA 8:1
        (2, 512, 8, 2, 128, bf16, True, 8, False),     # strided, 16-byte aligned
        (1, 4096, 16, 4, 128, bf16, False, 0, False),  # non-causal, training shape
        (1, 192, 16, 4, 128, bf16, True, 0, False),    # 64-row tiles, not 128
        (2, 320, 8, 2, 128, bf16, False, 0, False),    # the same, non-causal
        (2, 200, 4, 2, 64, bf16, True, 0, False),      # head_dim 64, ragged
        (1, 32, 2, 2, 32, f32, True, 0, False),        # tiny's shape
        (2, 300, 4, 2, 64, f32, True, 0, False),       # f32, ragged
        (1, 64, 2, 2, 32, f32, False, 3, False),       # f32, strided
        (1, 512, 8, 2, 128, bf16, True, 0, True),      # caller's D
    ]
    main_err = None
    for b, s, h, kv, d, dtype, causal, pad, given_dd in cases:
        q, k, v = rand_qkv(gen, b, s, h, kv, d, dtype, pad)
        do = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
        out, lse = attention.flash_forward(q, k, v, causal)
        dd = None
        if given_dd:
            dd = attention._to_bh((do.float() * out.float()).sum(
                dim=-1, keepdim=True)) + torch.randn(
                    (b * h, s, 1), generator=gen, device="cuda")
        got = attention._flash_backward(q, k, v, out, lse, do, causal, dd)
        again = attention._flash_backward(q, k, v, out, lse, do, causal, dd)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"flash backward is not bitwise repeatable at "
              f"{(b, s, h, kv, d, dtype, causal, pad)}")
        del again
        ref = attention.flash_backward_plain(q, k, v, out, lse, do, causal,
                                             dd)
        tol = 2e-2 if dtype == bf16 else 1e-4
        errs = []
        for name, x, y in zip(("dq", "dk", "dv"), got, ref):
            check(x.shape == y.shape and x.dtype == y.dtype,
                  f"{name} shape/dtype")
            l2 = tile_rel_l2(x, y, floor=1e-3)
            err = (x.float() - y.float()).abs().max().item()
            rms = y.float().pow(2).mean().sqrt().item()
            errs.append(err)
            print(f"backward vs plain b={b} s={s} h={h} kv={kv} d={d} "
                  f"{str(dtype)[6:]} causal={causal} pad={pad} "
                  f"dd={'given' if given_dd else 'derived'} {name}: "
                  f"worst-tile rel L2 {l2:.3e} (tol {tol}), max|err| "
                  f"{err:.3e}, rms(plain) {rms:.3e}, bitwise repeatable")
            check(l2 < tol, f"flash backward {name} disagrees with its "
                  f"plain version at {(b, s, h, kv, d, dtype, causal)}")
        if main_err is None:
            main_err = (errs[0], max(errs[1:]))
    # a dO the kernels cannot take is refused, not run
    q, k, v = rand_qkv(gen, 1, 64, 2, 2, 64, bf16)
    out, lse = attention.flash_forward(q, k, v, True)
    try:
        attention._flash_backward(q, k, v, out, lse, out.float(), True)
    except ValueError:
        pass
    else:
        raise RuntimeError("flash backward took a dO of another dtype")
    return main_err


def grad_rel_err(got, ref) -> float:
    """Worst relative L2 error over the leaves of two gradient trees."""
    return max(((a.float() - b.float()).norm() / b.float().norm()).item()
               for a, b in zip(got, ref))


def bwd_counts(attention):
    return (attention.FLASH_FWD_LAUNCHES, attention.FLASH_BWD_DKDV_LAUNCHES,
            attention.FLASH_BWD_DQ_LAUNCHES)


def zero_counts(attention):
    attention.FLASH_FWD_LAUNCHES = 0
    attention.FLASH_BWD_DKDV_LAUNCHES = 0
    attention.FLASH_BWD_DQ_LAUNCHES = 0


def phase_grad_parity(attention, workload):
    """loss_fn and its gradients on tiny f32 (flash, remat, TF32 off)
    through the kernels against the same run through naive attention,
    within 1e-4 relative; one step launches K1 twice per layer (the remat
    recompute) and K2 and K3 once each."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(workload.ModelConfig.tiny(), attn="flash",
                              remat=True)
    params = workload.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, cfg.seq)), device="cuda")
    zero_counts(attention)
    loss, grads = workload.value_and_grad(params, tokens, cfg)
    torch.cuda.synchronize()
    counts = bwd_counts(attention)
    want = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    check(counts == want, f"tiny train step launched (K1, K2, K3) = "
          f"{counts}, wanted {want}")
    ref_loss, ref_grads = workload.value_and_grad(
        params, tokens, cfg, attn_fn=attention.naive_attention)
    loss_err = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    g_err = grad_rel_err(workload.tree_leaves(grads),
                         workload.tree_leaves(ref_grads))
    print(f"tiny f32 flash+remat vs naive: loss {loss.item():.6f} rel err "
          f"{loss_err:.3e}, worst grad rel L2 {g_err:.3e} (tol 1e-4), "
          f"launches (K1, K2, K3) {counts}")
    check(loss_err < 1e-4 and g_err < 1e-4,
          "flash gradients disagree with naive attention's")


def make_requests(cfg, serve):
    rng = np.random.default_rng(0)
    return [serve.Request(
        rid=i,
        prompt=rng.integers(0, cfg.vocab, size=int(rng.integers(64, 1025)),
                            dtype=np.int32),
        max_new_tokens=int(rng.integers(16, 129)))
        for i in range(16)]


def phase_serving(attention, serve, workload, name="llama_like_big"):
    """Full-width serving of the preset ``name``: the flash kernel launches
    once per layer and slot prefill where the preset's attention is flash
    (llama_like_big), never where it is naive (mixtral_like). Returns the
    flash launches of the main path run."""
    cfg = getattr(workload.ModelConfig, name)()
    per_prefill = cfg.n_layers if cfg.attn == "flash" else 0
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = workload.init_params(cfg, gen, "cuda")
    reqs = make_requests(cfg, serve)
    want_tokens = sum(r.max_new_tokens for r in reqs)
    geometry = dict(slots=8, max_seq=2048, prompt_bucket=SERVE_BUCKETS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path as a user drives it: engine, warmup, submit, drain
    attention.FLASH_FWD_LAUNCHES = 0
    eng = serve.ServeEngine(params, cfg, device="cuda", **geometry)
    eng.warmup()
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    launches = attention.FLASH_FWD_LAUNCHES
    if per_prefill:
        check(launches > 0, "the serving path launched no flash kernel")
    check(launches == per_prefill * eng.prefills,
          f"{name}: {launches} flash launches for {eng.prefills} prefills "
          f"of {cfg.n_layers} layers with attn={cfg.attn}")
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
    check(measured_launches == per_prefill * stats["prefills"],
          f"measure_serving: {measured_launches} flash launches for "
          f"{stats['prefills']} prefills")
    check(stats["tokens"] == want_tokens, "measure_serving lost tokens")
    moe = ({"n_experts": cfg.n_experts, "top_k": cfg.moe_top_k}
           if cfg.n_experts else {})
    print(json.dumps({
        "serving": name, **moe, "requests": len(reqs),
        "slots": geometry["slots"], "max_seq": geometry["max_seq"],
        "buckets": list(SERVE_BUCKETS), "prefills": prefills,
        "flash_launches": launches, "tokens": stats["tokens"],
        "tokens_per_s": stats["tokens_per_s"],
        "occupancy": stats["occupancy"], "ticks": stats["ticks"],
        "max_tick_gap_s": stats["max_tick_gap_s"],
        "elapsed_s": stats["elapsed_s"], "peak_mem_gib": peak_gib}))
    return launches


def phase_parity(attention, decode, serve, workload, attn="flash",
                 n_experts=0):
    """Engine == solo greedy generation on tiny f32 (with ``n_experts``
    experts), with flash attention through the kernel (launches counted for
    the engine and each solo run) or naive (no launch). TF32 is off so
    float32 products are full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(workload.ModelConfig.tiny(), attn=attn,
                              n_experts=n_experts)
    per_prefill = cfg.n_layers if attn == "flash" else 0
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
    check(attention.FLASH_FWD_LAUNCHES == per_prefill * eng.prefills,
          f"tiny engine: {attention.FLASH_FWD_LAUNCHES} flash launches for "
          f"{eng.prefills} prefills of {cfg.n_layers} layers, attn={attn}")
    check(sorted(c.rid for c in done) == list(range(5)),
          "tiny engine lost a request")
    for c in done:
        req = reqs[c.rid]
        attention.FLASH_FWD_LAUNCHES = 0
        solo = decode.generate(
            params, torch.as_tensor(req.prompt, device="cuda")[None].long(),
            cfg, steps=req.max_new_tokens - 1)[0].cpu().numpy()
        check(attention.FLASH_FWD_LAUNCHES == per_prefill,
              f"solo generate: {attention.FLASH_FWD_LAUNCHES} flash "
              f"launches for one prefill of {cfg.n_layers} layers, "
              f"attn={attn}")
        check(np.array_equal(c.tokens, solo),
              f"request {c.rid}: engine {c.tokens} != solo {solo}")
    moe = f" with {n_experts} experts" if n_experts else ""
    print(f"engine == solo on tiny f32{moe} {attn}: {len(done)} requests, "
          f"{eng.prefills} engine prefills, flash launches "
          f"{per_prefill} per prefill")


def phase_timing(attention):
    """Times at the main path's large-bucket shape. The inputs (10.6 MB)
    stay in the 50 MB L2 across launches, as a prefill's freshly computed
    q/k/v would be."""
    b, s, h, kv, d, dtype = 1, 1024, 16, 4, 128, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = rand_qkv(gen, b, s, h, kv, d, dtype)
    counted = attention.FLASH_FWD_LAUNCHES
    ms = cuda_ms(lambda: attention.flash_forward(q, k, v, True))
    graph_ms = graph_launch_ms(lambda: attention.flash_forward(q, k, v, True))
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
                      "graph_ms": graph_ms, "plain_ms": plain_ms,
                      "library_ms": library_ms}))
    return dict(ms=ms, graph_ms=graph_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def phase_training(attention, measure, optim, workload):
    """The training path: full-width llama_like_big(seq=4096), batch 1,
    random bf16 weights, five AdamW steps (lr 1e-4, mu f32) on one repeated
    batch through make_optax_train_step, each step's kernel launches counted
    (K1 2·n_layers with remat, K2 and K3 n_layers); then
    measure_adamw_train_step on the same configuration. Returns the
    launches of the five steps."""
    cfg = workload.ModelConfig.llama_like_big(seq=4096)
    batch = 1
    params = workload.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (batch, cfg.seq)), device="cuda")
    tx = optim.adamw(1e-4, mu_dtype=torch.float32)
    step, init_opt, _, _ = workload.make_optax_train_step(None, cfg, tx)
    state = init_opt(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    losses, step_s, total = [], [], [0, 0, 0]
    for _ in range(5):
        zero_counts(attention)
        t0 = time.perf_counter()
        params, state, loss = step(params, state, tokens)
        losses.append(loss.item())             # the fence
        step_s.append(time.perf_counter() - t0)
        counts = bwd_counts(attention)
        check(counts == want, f"train step launched (K1, K2, K3) = "
              f"{counts}, wanted {want}")
        total = [t + c for t, c in zip(total, counts)]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    del params, state, step
    per_step, tflops, mfu, note = measure.measure_adamw_train_step(cfg, batch)
    print(json.dumps({
        "training": "llama_like_big", "seq": cfg.seq, "batch": batch,
        "optimizer": "adamw lr 1e-4 mu f32", "losses": losses,
        "step_s": step_s, "launches_per_step": dict(zip(
            ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"), want)),
        "peak_mem_gib": peak_gib, "per_step_s": per_step,
        "tokens_per_s": batch * cfg.seq / per_step, "tflops": tflops,
        "mfu": mfu, "peak_tflops": measure.device_peak_tflops(),
        "step_flops": measure.train_step_flops(cfg, batch), "note": note}))
    return total


def phase_training_timing(attention):
    """K1, K2 and K3 at the training shape with CUDA events, beside the
    plain versions and one library call (scaled_dot_product_attention: its
    forward for K1, its backward, which forms dq, dk and dv together, for
    K2 and K3). Bounds: 2, 4 and 3 causal-halved (s, s, d) products. Since
    no library call forms dq alone, K2 then K3, as the backward launches
    them, is also timed as one and printed beside the library's backward.
    K1's output at this shape is held against its plain version as in
    phase 2, and its max abs error is returned with its times."""
    b, s, h, kv, d, dtype = 1, 4096, 16, 4, 128, torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = rand_qkv(gen, b, s, h, kv, d, dtype)
    do = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
    out, lse = attention.flash_forward(q, k, v, True)
    ref, _ = attention.flash_attention_plain(q, k, v, True)
    fwd_err = (out.float() - ref.float()).abs().max().item()
    check(tile_rel_l2(out, ref) < 1e-2,
          "flash kernel disagrees with its plain version at the training shape")
    del ref
    dd = attention._to_bh((do.float() * out.float()).sum(
        dim=-1, keepdim=True)).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    def k2():
        attention._launch_bwd("dkdv", q, k, v, do, lse, dd, (dk, dv), True)

    def k3():
        attention._launch_bwd("dq", q, k, v, do, lse, dd, (dq,), True)

    def k2_k3():
        k2()
        k3()
    ms = {
        "flash_fwd": cuda_ms(lambda: attention.flash_forward(q, k, v, True)),
        "flash_bwd_dkdv": cuda_ms(k2),
        "flash_bwd_dq": cuda_ms(k3),
    }
    pair_ms = cuda_ms(k2_k3)
    fwd_plain = cuda_ms(lambda: attention.flash_attention_plain(q, k, v, True),
                        iters=10)
    bwd_plain = cuda_ms(lambda: attention.flash_backward_plain(
        q, k, v, out, lse, do, True), iters=10)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)
    with torch.no_grad():
        fwd_lib = cuda_ms(sdpa)
    ot, dot = sdpa(), do.transpose(1, 2).contiguous()
    bwd_lib = cuda_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                                  retain_graph=True))
    pair = 2 * b * h * d * s * (s + 1) / 2       # one causal (s, s, d) product
    el = q.element_size()
    rows = b * h * s * 4                         # one f32 value per query row
    work = {  # (products, bytes: each input read once, each output written)
        "flash_fwd": (2, (2 * q.numel() + 2 * k.numel()) * el + rows),
        "flash_bwd_dkdv": (4, (2 * q.numel() + 4 * k.numel()) * el + 2 * rows),
        "flash_bwd_dq": (3, (3 * q.numel() + 2 * k.numel()) * el + 2 * rows),
    }
    timing = {}
    for name, (products, nbytes) in work.items():
        t_ops = products * pair / PEAK_FLOPS[dtype] * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        fwd = name == "flash_fwd"
        timing[name] = dict(
            ms=ms[name], plain_ms=fwd_plain if fwd else bwd_plain,
            library_ms=fwd_lib if fwd else bwd_lib,
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes")
    timing["flash_fwd"]["max_abs_err"] = fwd_err
    walks = attention._dkdv_schedule(b, s, kv, True)
    work = (walks[:, :, 3] - walks[:, :, 2]).clip(min=0).sum(axis=1)
    ratio = float(work.max() / work.mean())
    print(f"K2 schedule at {(b, s, h, kv, d)} causal: {len(work)} blocks, "
          f"longest / mean walk {ratio:.4f} (the reference's key tiles: "
          f"1.97)")
    check(ratio <= 1.3, "K2's schedule is out of balance")
    print(json.dumps({"timing": "training shape", "shape": [b, s, h, kv, d],
                      **timing}))
    print(json.dumps({"timing": "backward at the training shape",
                      "flash_bwd_dkdv_then_dq_ms": pair_ms,
                      "sdpa_backward_ms": bwd_lib,
                      "bound_ms": (timing["flash_bwd_dkdv"]["bound_ms"]
                                   + timing["flash_bwd_dq"]["bound_ms"])}))
    return timing


def phase_moe_training(measure, workload):
    """The MoE training path: full-width mixtral_like(seq=1024), batch 1
    (the capacity path, C = 320), five SGD steps (lr 0.1) on one repeated
    batch with a finite, falling loss and a finite, positive aux loss after
    them; then measure.measure_train_step. Last, the card against the CPU:
    loss and every gradient (the router's included) of tiny f32 with 4
    experts, TF32 off, within 1e-4 relative (L2, per leaf)."""
    cfg = workload.ModelConfig.mixtral_like(seq=1024)
    batch = 1
    params = workload.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (batch, cfg.seq)), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        params, loss = workload.sgd_train_step(params, tokens, cfg, lr=0.1)
        losses.append(loss.item())             # the fence
        step_s.append(time.perf_counter() - t0)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    with torch.no_grad():
        logits, aux = workload.forward(params, tokens, cfg, with_aux=True)
    check(logits.shape == (batch, cfg.seq, cfg.vocab)
          and bool(torch.isfinite(logits).all()), "MoE logits not finite")
    check(all(np.isfinite(losses)), f"non-finite MoE loss: {losses}")
    check(losses[-1] < losses[0], f"MoE loss did not fall: {losses}")
    check(np.isfinite(aux.item()) and aux.item() > 0,
          f"MoE aux loss {aux.item()}")
    del params, logits
    per_step, tflops, mfu = measure.measure_train_step(cfg, batch)
    print(json.dumps({
        "training": "mixtral_like", "seq": cfg.seq, "batch": batch,
        "n_experts": cfg.n_experts, "top_k": cfg.moe_top_k,
        "capacity": workload.moe_capacity(cfg, batch * cfg.seq),
        "optimizer": "sgd lr 0.1", "losses": losses, "step_s": step_s,
        "aux": aux.item(), "peak_mem_gib": peak_gib,
        "per_step_s": per_step,
        "tokens_per_s": batch * cfg.seq / per_step, "tflops": tflops,
        "mfu": mfu, "peak_tflops": measure.device_peak_tflops(),
        "step_flops": measure.train_step_flops(cfg, batch),
        "note": measure.moe_flops_note(cfg, batch)}))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tiny = dataclasses.replace(workload.ModelConfig.tiny(), n_experts=4)
    params = workload.init_params(
        tiny, torch.Generator(device="cuda").manual_seed(0), "cuda")
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        0, tiny.vocab, (2, tiny.seq)))
    loss, grads = workload.value_and_grad(params, tokens.cuda(), tiny)
    cpu_params = workload.tree_map(lambda t: t.cpu(), params)
    ref_loss, ref_grads = workload.value_and_grad(cpu_params, tokens, tiny)
    loss_err = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    leaves = [g.cpu() for g in workload.tree_leaves(grads)]
    g_err = grad_rel_err(leaves, workload.tree_leaves(ref_grads))
    r_err = grad_rel_err([grads["layers"][i]["router"].cpu()
                          for i in range(tiny.n_layers)],
                         [ref_grads["layers"][i]["router"]
                          for i in range(tiny.n_layers)])
    print(f"tiny f32 MoE gradients, card vs CPU: loss rel err "
          f"{loss_err:.3e}, worst grad rel L2 {g_err:.3e}, router "
          f"{r_err:.3e} (tol 1e-4)")
    check(loss_err < 1e-4 and g_err < 1e-4,
          "MoE gradients on the card disagree with the CPU's")


def phase_moe_decode(measure, workload):
    """Decode throughput of full-width mixtral_like(seq=512), batch 8, 128-
    token prompts (measure.measure_decode's slope between 64 and 256 greedy
    steps), with its HBM bandwidth utilization and the bound that the bytes
    of one step imply at 3.35 TB/s."""
    cfg = workload.ModelConfig.mixtral_like(seq=512)
    batch, prompt_len = 8, 128
    tps, ctx = measure.measure_decode(cfg, batch, prompt_len=prompt_len)
    util = measure.decode_bandwidth_utilization(cfg, batch, ctx, tps)
    nbytes = measure.decode_bytes_per_token(cfg, batch, ctx)
    check(np.isfinite(tps) and tps > 0, f"decode rate {tps}")
    check(util is not None and 0 < util < 1,
          f"decode bandwidth utilization {util}")
    print(json.dumps({
        "decode": "mixtral_like", "seq": cfg.seq, "batch": batch,
        "prompt_len": prompt_len, "tokens_per_s": tps, "mean_ctx": ctx,
        "step_s": batch / tps, "bytes_per_step": nbytes,
        "bound_step_s": nbytes / PEAK_BYTES_PER_S,
        "bandwidth_utilization": util,
        "peak_hbm_gbps": measure.device_peak_hbm_gbps()}))


def ab_turn(tree: str, other_root: str) -> None:
    """One turn of ``--ab``, in a process of its own: builds the kernels of
    the ``tpusched_torch`` on PYTHONPATH, then prints one JSON line of
    their times (ms per launch, :func:`cuda_ms`) at bf16, causal, in this
    order: K1 at the serving shape (1, 1024, 16, 4, 128), K3 at the
    training shape (1, 4096, 16, 4, 128) before K2 was ever launched, K2,
    K3 again, K1 at the training shape, K1 at the serving shape again; K1
    at the serving shape inside a CUDA graph (:func:`graph_launch_ms`, the
    device's time without the host's enqueue) first and last. Last, K3
    four times more on the same tensors, through this tree's library and
    then the library of the tree under ``other_root`` (built there if
    missing), in turns: both trees' K3 share one C signature, so this holds
    everything but the library the same."""
    import importlib.util
    import pathlib

    from tpusched_torch import _build, attention
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(3)
    qs, ks, vs = rand_qkv(gen, 1, 1024, 16, 4, 128, torch.bfloat16)
    q, k, v = rand_qkv(gen, 1, 4096, 16, 4, 128, torch.bfloat16)
    out, lse = attention.flash_forward(q, k, v, True)
    do = torch.randn_like(q)
    dd = attention._to_bh((do.float() * out.float()).sum(
        dim=-1, keepdim=True)).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    runs = {
        "k1_serving": lambda: attention.flash_forward(qs, ks, vs, True),
        "k1_training": lambda: attention.flash_forward(q, k, v, True),
        "k2": lambda: attention._launch_bwd("dkdv", q, k, v, do, lse, dd,
                                            (dk, dv), True),
        "k3": lambda: attention._launch_bwd("dq", q, k, v, do, lse, dd,
                                            (dq,), True),
    }
    readings = [["k1_serving_graph", graph_launch_ms(runs["k1_serving"])]]
    for name in ("k1_serving", "k3", "k2", "k3", "k1_training", "k1_serving"):
        readings.append([name, cuda_ms(runs[name])])
    readings.append(["k1_serving_graph", graph_launch_ms(runs["k1_serving"])])
    spec = importlib.util.spec_from_file_location(
        "_ab_other_build", pathlib.Path(other_root, "tpusched_torch", "_build.py"))
    other_build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other_build)
    for which, build in (("own", _build), ("other", other_build)) * 2:
        attention._build = build          # what _launch_bwd loads K3 from
        readings.append([f"k3_{which}_library", cuda_ms(runs["k3"])])
    attention._build = _build
    print(json.dumps({"tree": tree, "package": attention.__file__,
                      "build_s": build_s, "readings": readings}))


def ab(other: str) -> None:
    """``--ab DIR``: the flash kernels of the ``tpusched_torch`` under DIR
    (for example ``git archive <commit> tpusched_torch`` unpacked there)
    and of this checkout, timed in turns on one card: DIR, this, this, DIR,
    each turn an :func:`ab_turn` in a fresh process that builds its tree's
    kernels under that tree's ``build/``. Two versions are compared only
    inside one such call."""
    import os
    import pathlib
    roots = {"other": pathlib.Path(other).resolve(),
             "this": pathlib.Path(__file__).resolve().parent}
    check((roots["other"] / "tpusched_torch").is_dir(),
          f"no tpusched_torch under {other}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0])
    for tree, across in (("other", "this"), ("this", "other"),
                         ("this", "other"), ("other", "this")):
        env = {**os.environ, "PYTHONPATH": str(roots[tree])}
        # this file by path, with -P: only PYTHONPATH names the package
        subprocess.run([sys.executable, "-P", __file__, "--ab-turn", tree,
                        str(roots[across])], env=env, check=True, timeout=600)


def main(argv) -> int:
    sys.stdout.reconfigure(line_buffering=True)   # a cut run keeps its lines
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    if len(argv) == 2 and argv[0] == "--ab":
        ab(argv[1])
        return 0
    if len(argv) == 3 and argv[0] == "--ab-turn":
        ab_turn(argv[1], argv[2])
        return 0
    if argv:
        print(__doc__, file=sys.stderr)
        return 2
    from tpusched_torch import (_build, attention, decode, measure, optim,
                                serve, workload)

    phase_environment(_build)
    max_abs_err = phase_kernel_vs_plain(attention)
    bwd_err = phase_backward_vs_plain(attention)
    launches = phase_serving(attention, serve, workload)
    phase_parity(attention, decode, serve, workload)
    phase_grad_parity(attention, workload)
    train_launches = phase_training(attention, measure, optim, workload)
    serving_timing = phase_timing(attention)
    timing = phase_training_timing(attention)
    # the MoE family, after the kernel timings so that those run as before
    phase_serving(attention, serve, workload, "mixtral_like")
    phase_parity(attention, decode, serve, workload, "naive", n_experts=4)
    phase_parity(attention, decode, serve, workload, "flash", n_experts=4)
    phase_moe_training(measure, workload)
    phase_moe_decode(measure, workload)
    source = "tpusched_torch/csrc/"
    replaces = "tpusched/jaxbridge/attention.py:"
    # flash_fwd's own fields are the serving path's, at its (1, 1024, 16, 4,
    # 128) shape, as in the first slice; "training_shape" holds the training
    # path's launches, error and times at (1, 4096, 16, 4, 128).
    print(json.dumps({"kernels": [
        {"name": "flash_fwd", "route": "cuda", "source": source + "flash_fwd.cu",
         "replaces": replaces + "91", "launches": launches,
         "max_abs_err": max_abs_err, **serving_timing,
         "training_shape": {"launches": train_launches[0],
                            **timing["flash_fwd"]}},
        {"name": "flash_bwd_dkdv", "route": "cuda",
         "source": source + "flash_bwd.cu", "replaces": replaces + "218",
         "launches": train_launches[1], "max_abs_err": bwd_err[1],
         **timing["flash_bwd_dkdv"]},
        {"name": "flash_bwd_dq", "route": "cuda",
         "source": source + "flash_bwd.cu", "replaces": replaces + "265",
         "launches": train_launches[2], "max_abs_err": bwd_err[0],
         **timing["flash_bwd_dq"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
