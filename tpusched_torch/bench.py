"""The reference's on-chip workload lines, run on the port.

Counterpart of ``bench_tpu_workload`` in the repository's ``bench.py``
(its lines 2152-2512), which printed the reference's chip numbers. Run as

    python -m tpusched_torch.bench [--device cpu] [--lines NAME,...]

Each line group of :data:`LINES` runs, in the reference's order, what the
reference ran: the same configurations, batches, request counts and
lengths, chunk and bucket sizes, and numpy seeds (``default_rng(0)``,
``(1)``, ``(3)``, ``(5)`` and ``(42)``), so the request sets are the
reference's prompts exactly. Where the reference drew from a
``jax.random.PRNGKey(n)`` (its weights and the solo speculation prompt),
the runner draws from a ``torch.Generator`` seeded with the same ``n``;
the values differ from JAX's. Every line is one JSON object printed by
:func:`emit`, the reference's ``{"metric", "value", "unit",
"vs_baseline", ...}``, whose extra fields add the unrounded measurements,
the model's dimensions, the card's name and power limit (as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them) and the
peak memory of each measurement of the line group. The allocator's peaks
are reset, and every program and cache the previous group held freed,
before each group.

What differs from the reference, on purpose:

- no line's failure is caught: a failing line raises, the run stops and
  the exit code is non-zero. A calibration reading above 1.1 x the card's
  peak prints the reference's "TIMING INVALID" line and then fails;
- a speculative stream that leaves plain greedy decoding is reported as
  the reference reports it, and fails the run unless the plain stream's
  two top logits at the first difference lie within 1/32 of the larger
  one's magnitude (a near tie of bf16 GEMMs of two shapes);
- the texts name the card where the reference names its chip, the HBM
  budget is that of ``h100-80gb``, and the reference's probe of its chip
  has no counterpart: with no CUDA device and no ``--device cpu`` the run
  is refused before its first line, and it never falls back to the CPU.

``--lines`` selects line groups by name, so a full run can be split
across calls. ``context(tiny=True)`` gives every line
``ModelConfig.tiny()``-sized configurations and small request sets
(:meth:`Sizes.tiny`, :func:`tiny_models`): the tests' check of the
runner's paths on the CPU, whose numbers measure nothing.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import attention, budget, measure, optim
from .decode import Generation, init_kv_cache, prefill
from .serve import Request, measure_serving, measure_serving_slo
from .spec_decode import Speculation
from .workload import (ModelConfig, init_params, make_optax_train_step,
                       resolve_device, tree_leaves)

NEAR_TIE = 1 / 32      # the largest margin at which a greedy stream may flip
ACCELERATOR = "h100-80gb"    # the HBM budget's card


def emit(metric: str, value, unit: str, vs_baseline, **extra) -> None:
    """One result line, as the reference prints it."""
    rec = {"metric": metric, "value": value, "unit": unit,
           "vs_baseline": vs_baseline}
    rec.update(extra)
    print(json.dumps(rec), flush=True)


@dataclasses.dataclass(frozen=True)
class RequestSet:
    """``n`` requests drawn from ``default_rng(seed)`` as the reference
    draws them (``bench.py:2318-2324``): for each request its prompt length
    in ``[prompt[0], prompt[1])``, its prompt tokens, then its new-token
    count in ``[gen[0], gen[1])``."""
    n: int
    prompt: Tuple[int, int]
    gen: Tuple[int, int]
    seed: int

    def draw(self, vocab: int) -> List[Request]:
        rng = np.random.default_rng(self.seed)
        return [Request(rid=i,
                        prompt=rng.integers(0, vocab,
                                            size=int(rng.integers(
                                                *self.prompt)),
                                            dtype=np.int32),
                        max_new_tokens=int(rng.integers(*self.gen)))
                for i in range(self.n)]

    def text(self) -> str:
        return (f"prompts {self.prompt[0]}-{self.prompt[1]}, gens "
                f"{self.gen[0]}-{self.gen[1]}")


POISSON_RATE = 4.0     # the SLO line's mean ticks between arrivals


def slo_requests(vocab: int, rs: RequestSet
                 ) -> Tuple[List[Request], List[int]]:
    """The SLO line's requests and arrival ticks, drawn as the reference
    draws them (``bench.py:2486-2493``): every prompt first, then every
    new-token count, then the Poisson gaps between arrivals."""
    rng = np.random.default_rng(rs.seed)
    prompts = [rng.integers(0, vocab, int(rng.integers(*rs.prompt)),
                            dtype=np.int32) for _ in range(rs.n)]
    reqs = [Request(rid=i, prompt=p,
                    max_new_tokens=int(rng.integers(*rs.gen)))
            for i, p in enumerate(prompts)]
    arrivals = np.cumsum(rng.poisson(POISSON_RATE, size=rs.n)).tolist()
    return reqs, arrivals


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Every size the lines take; the defaults are the reference's."""
    calibrate_n: int = 4096
    train: Tuple[int, int] = (2048, 8)        # (seq, batch), train_155m
    long: Tuple[int, int] = (8192, 2)         # long_context's flash line
    ratio: Tuple[int, int] = (4096, 4)        # its naive/flash ratio
    big_seq: int = 4096                       # adamw_0_67b and adamw_xl
    moe_seq: int = 1024
    serve_seq: int = 512                      # seq and max_seq: decode to spec
    decode_batch: int = 8
    decode_steps: Tuple[int, int, int] = (128, 64, 256)   # prompt, k1, k2
    slots: int = 8
    serving: RequestSet = RequestSet(32, (32, 128), (16, 128), 0)
    serve_bucket: int = 128
    long_prompts: RequestSet = RequestSet(16, (256, 448), (16, 64), 1)
    long_bucket: int = 448
    chunk: int = 64
    spec_prompt: int = 64
    spec_steps: int = 127
    spec_k: int = 4
    spec_serving: RequestSet = RequestSet(16, (32, 96), (32, 96), 3)
    int8_seq: int = 2048                      # seq and max_seq
    int8: RequestSet = RequestSet(12, (512, 1024), (32, 96), 5)
    int8_bucket: int = 1024
    slo: RequestSet = RequestSet(24, (48, 192), (16, 96), 42)
    slo_bucket: int = 192
    slo_ttft_ticks: int = 32

    @staticmethod
    def tiny() -> "Sizes":
        """Small enough for the CPU, every line's geometry kept valid
        (prompts within their buckets, prompt + generation + k within
        max_seq)."""
        return Sizes(calibrate_n=64, train=(32, 2), long=(64, 2),
                     ratio=(48, 2), big_seq=32, moe_seq=32, serve_seq=64,
                     decode_batch=2, decode_steps=(8, 4, 12), slots=4,
                     serving=RequestSet(8, (4, 16), (2, 12), 0),
                     serve_bucket=16,
                     long_prompts=RequestSet(6, (16, 24), (2, 8), 1),
                     long_bucket=24, chunk=8, spec_prompt=8, spec_steps=15,
                     spec_serving=RequestSet(6, (4, 12), (4, 12), 3),
                     int8_seq=64, int8=RequestSet(5, (16, 32), (4, 12), 5),
                     int8_bucket=32,
                     slo=RequestSet(8, (4, 24), (2, 10), 42), slo_bucket=24)


Models = Dict[str, Callable[[int], ModelConfig]]


def full_models() -> Models:
    """The reference's presets, each a function of its sequence length."""
    return {name: getattr(ModelConfig, name) for name in
            ("llama_like", "llama_like_big", "llama_like_xl",
             "mixtral_like")}


def tiny_models() -> Models:
    """A ``ModelConfig.tiny()``-sized stand-in for each preset, with the
    preset's attention, remat and grouped-query heads (4 over 2); the xl
    stand-in is bf16, as pure-bf16 AdamW trains it."""
    gqa = dataclasses.replace(ModelConfig.tiny(), n_heads=4, n_kv_heads=2)
    big = dataclasses.replace(gqa, attn="flash", remat=True)
    return {
        "llama_like": lambda seq: dataclasses.replace(gqa, seq=seq),
        "llama_like_big": lambda seq: dataclasses.replace(big, seq=seq),
        "llama_like_xl": lambda seq: dataclasses.replace(
            big, seq=seq, n_layers=3, dtype=torch.bfloat16),
        "mixtral_like": lambda seq: dataclasses.replace(
            gqa, seq=seq, n_experts=4, moe_top_k=2),
    }


def card_name(device: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, or
    "cpu"."""
    if device.type != "cuda":
        return "cpu"
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cards = cards.splitlines()
    return cards[min(device.index, len(cards) - 1)]


class Context:
    """What every line takes: the device, the preset factories and the
    sizes. It prints the lines (:meth:`emit`) and keeps the line group's
    memory peaks."""

    def __init__(self, device, models: Models, sizes: Sizes):
        self.device = resolve_device(device)
        self.models = models
        self.sizes = sizes
        self.card = card_name(self.device)
        self.line = ""
        self.peaks: Dict[str, Optional[List[float]]] = {}

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def model(self, name: str, seq: int) -> ModelConfig:
        return self.models[name](seq)

    def free(self) -> None:
        """Drop what nothing references any more (programs, their graphs'
        pools, caches) and hand the cached blocks back to the card."""
        gc.collect()
        if self.on_card:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def start(self, line: str) -> None:
        """A new line group: freed memory, no peaks."""
        self.free()
        self.line = line
        self.peaks = {}

    def measured(self, label: str, fn: Callable, *args, **kwargs):
        """``fn(*args, **kwargs)``, with the card's peak memory while it
        ran (allocated and reserved GiB, what was already held included)
        kept as ``label``'s."""
        self.free()
        if self.on_card:
            torch.cuda.reset_peak_memory_stats(self.device)
        out = fn(*args, **kwargs)
        self.peaks[label] = ([torch.cuda.max_memory_allocated(self.device)
                              / 2**30,
                              torch.cuda.max_memory_reserved(self.device)
                              / 2**30] if self.on_card else None)
        return out

    def emit(self, metric: str, value, unit: str, vs_baseline,
             **extra) -> None:
        emit(metric, value, unit, vs_baseline, **extra, line=self.line,
             card=self.card, peaks_gib=dict(self.peaks))


def context(device=None, tiny: bool = False) -> Context:
    """The reference's sizes and presets, or with ``tiny`` the small
    ones."""
    if tiny:
        return Context(device, tiny_models(), Sizes.tiny())
    return Context(device, full_models(), Sizes())


def seeded_params(ctx: Context, cfg: ModelConfig, seed: int):
    """Weights from a generator on the run's device seeded with ``seed``,
    where the reference draws from ``jax.random.PRNGKey(seed)``."""
    return init_params(cfg, torch.Generator(device=ctx.device)
                       .manual_seed(seed), ctx.device)


def model_fields(cfg: ModelConfig) -> dict:
    """The dimensions a line ran at (the texts keep the presets' names)."""
    return {"d_model": cfg.d_model, "n_layers": cfg.n_layers,
            "heads": [cfg.n_heads, cfg.kv_heads], "d_ff": cfg.d_ff,
            "vocab": cfg.vocab, "seq": cfg.seq, "dtype": str(cfg.dtype)[6:],
            "attn": cfg.attn, "remat": cfg.remat,
            "n_experts": cfg.n_experts, "params": budget.count_params(cfg)}


def _rate(tflops: float, mfu: Optional[float]) -> Tuple[float, str]:
    """The reference's value and unit of a train line: MFU where the card
    has a known peak, else TFLOP/s."""
    return (round(mfu, 4), "MFU") if mfu else (round(tflops, 1), "TFLOP/s")


def _sync(ctx: Context) -> None:
    if ctx.on_card:
        torch.cuda.synchronize(ctx.device)


def naive_score_bytes(cfg: ModelConfig, batch: int) -> int:
    """Bytes of the (b, h, s, s) score tensors a naive-attention train
    step keeps from its forward for its backward, every layer's at once:
    the f32 softmax output, and its cast to the compute dtype that the
    product with V saves (the same tensor when that dtype is f32)."""
    per_element = 4 + (cfg.dtype.itemsize if cfg.dtype != torch.float32
                       else 0)
    return (per_element * batch * cfg.n_heads * cfg.seq ** 2
            * cfg.n_layers)


# -- the line groups, in the reference's order -------------------------------

def line_calibrate(ctx: Context) -> None:
    """``bench.py:2172-2185``."""
    n = ctx.sizes.calibrate_n
    peak = measure.device_peak_tflops(ctx.device)
    cal = ctx.measured("calibrate", measure.calibrate, n=n,
                       device=ctx.device)
    if peak and cal > 1.1 * peak:
        ctx.emit("TIMING INVALID: calibration matmul exceeds device peak "
                 f"({cal:.0f} > {peak:.0f} TFLOP/s); MFU lines suppressed",
                 round(cal, 1), "TFLOP/s", None, tflops=cal,
                 peak_tflops=peak)
        raise RuntimeError(f"timing invalid: calibrate read {cal} TFLOP/s "
                           f"over the card's peak of {peak}")
    ctx.emit(f"timing calibration: dense {n}^3 bf16 matmul ({ctx.card}, "
             f"peak {peak} TFLOP/s)", round(cal, 1), "TFLOP/s",
             round(cal / peak, 3) if peak else None, tflops=cal,
             peak_tflops=peak)


def line_train_155m(ctx: Context) -> None:
    """``bench.py:2187-2200``: flash, then naive attention."""
    seq, batch = ctx.sizes.train
    cfg = ctx.model("llama_like", seq)
    flash = dataclasses.replace(cfg, attn="flash")
    f_per, f_tf, f_mfu = ctx.measured("flash", measure.measure_train_step,
                                      flash, batch, device=ctx.device)
    n_per, n_tf, n_mfu = ctx.measured("naive", measure.measure_train_step,
                                      cfg, batch, device=ctx.device)
    ctx.emit(f"train-step MFU, llama-like 155M bf16, seq {seq}, b{batch}, "
             f"GQA {cfg.n_heads // cfg.kv_heads}:1, flash attention (one "
             f"{ctx.card}; vs_baseline = naive/flash step-time ratio)",
             *_rate(f_tf, f_mfu), round(n_per / f_per, 2), step_s=f_per,
             tflops=f_tf, mfu=f_mfu, batch=batch, model=model_fields(flash),
             train_step_flops=measure.train_step_flops(flash, batch))
    ctx.emit("train-step MFU, same model, naive attention "
             f"(step {n_per * 1e3:.1f} ms vs flash {f_per * 1e3:.1f} ms)",
             *_rate(n_tf, n_mfu), None, step_s=n_per, tflops=n_tf,
             mfu=n_mfu, batch=batch, model=model_fields(cfg),
             train_step_flops=measure.train_step_flops(cfg, batch),
             naive_score_gib=naive_score_bytes(cfg, batch) / 2**30)


def line_long_context(ctx: Context) -> None:
    """``bench.py:2202-2232``: flash at the long sequence, and the
    naive/flash ratio at the shorter one."""
    (seq, batch), (r_seq, r_batch) = ctx.sizes.long, ctx.sizes.ratio
    long_flash = dataclasses.replace(ctx.model("llama_like", seq),
                                     attn="flash")
    l_per, l_tf, l_mfu = ctx.measured(
        f"flash_{seq}", measure.measure_train_step, long_flash, batch,
        device=ctx.device)
    naive = ctx.model("llama_like", r_seq)
    f4_per, _, _ = ctx.measured(
        f"flash_{r_seq}", measure.measure_train_step,
        dataclasses.replace(naive, attn="flash"), r_batch, device=ctx.device)
    n4_per, _, _ = ctx.measured(f"naive_{r_seq}", measure.measure_train_step,
                                naive, r_batch, device=ctx.device)
    ctx.emit(f"train-step MFU, long-context seq {seq} b{batch}, flash "
             f"attention (step {l_per * 1e3:.1f} ms on {ctx.card}; "
             f"vs_baseline = naive/flash step-time ratio at seq {r_seq}: "
             f"{n4_per * 1e3:.1f}/{f4_per * 1e3:.1f} ms)",
             *_rate(l_tf, l_mfu), round(n4_per / f4_per, 2), step_s=l_per,
             tflops=l_tf, mfu=l_mfu, batch=batch,
             model=model_fields(long_flash),
             train_step_flops=measure.train_step_flops(long_flash, batch),
             ratio_step_s={"naive": n4_per, "flash": f4_per},
             ratio_batch=r_batch,
             naive_score_gib=naive_score_bytes(naive, r_batch) / 2**30)


def line_adamw_0_67b(ctx: Context) -> None:
    """``bench.py:2234-2249``."""
    big = ctx.model("llama_like_big", ctx.sizes.big_seq)
    a_per, a_tf, a_mfu, note = ctx.measured(
        "adamw", measure.measure_adamw_train_step, big, 1, device=ctx.device)
    ctx.emit("train-step MFU, llama-like ~0.67B bf16 AdamW(optax)+remat, "
             f"seq {big.seq}, b1, flash attention ({note}; step "
             f"{a_per * 1e3:.1f} ms, one {ctx.card})",
             *_rate(a_tf, a_mfu), None, step_s=a_per, tflops=a_tf,
             mfu=a_mfu, batch=1, model=model_fields(big),
             train_step_flops=measure.train_step_flops(big, 1))


XL_GATE_STEPS = 3


def xl_gate(ctx: Context, cfg: ModelConfig) -> dict:
    """The reference's "fits and trains" gate for the xl flagship
    (``tests_tpu/test_tpu_kernels.py:514-547``): seeded weights (12) and
    tokens (13), :data:`XL_GATE_STEPS` steps of ``make_optax_train_step``
    with pure-bf16 AdamW (``mu_dtype=bfloat16``; nu follows the params),
    each loss finite and the last below the first, every moment finite
    after them. Returns the losses, the moments' dtypes and the flash
    kernels' launches over the steps."""
    params = seeded_params(ctx, cfg, 12)
    tx = optim.adamw(1e-4, mu_dtype=torch.bfloat16)
    step, init_opt, _, _ = make_optax_train_step(None, cfg, tx)
    state = init_opt(params)
    tokens = torch.randint(0, cfg.vocab, (1, cfg.seq), generator=torch
                           .Generator(device=ctx.device).manual_seed(13),
                           device=ctx.device)
    before = (attention.FLASH_FWD_LAUNCHES,
              attention.FLASH_BWD_DKDV_LAUNCHES,
              attention.FLASH_BWD_DQ_LAUNCHES)
    losses = []
    for _ in range(XL_GATE_STEPS):
        params, state, loss = step(params, state, tokens)
        losses.append(loss.item())
    launches = [a - b for a, b in zip(
        (attention.FLASH_FWD_LAUNCHES, attention.FLASH_BWD_DKDV_LAUNCHES,
         attention.FLASH_BWD_DQ_LAUNCHES), before)]
    moments = tree_leaves(state.mu) + tree_leaves(state.nu)
    finite = bool(torch.stack([torch.isfinite(t).all()
                               for t in moments]).all())
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]
            and finite):
        raise RuntimeError(f"the xl gate failed: losses {losses}, moments "
                           f"finite {finite}")
    return {"losses": losses, "moments_finite": finite,
            "mu_dtype": str(tree_leaves(state.mu)[0].dtype)[6:],
            "nu_dtype": str(tree_leaves(state.nu)[0].dtype)[6:],
            "flash_launches": launches}


def line_adamw_xl(ctx: Context) -> None:
    """``bench.py:2251-2273``: the budget's verdict, the gate, then the
    slope-timed pure-bf16 AdamW step."""
    xl = ctx.model("llama_like_xl", ctx.sizes.big_seq)
    bd = budget.train_hbm_breakdown(xl, 1, mu_dtype="bf16",
                                    accelerator=ACCELERATOR)
    if not bd.fits:
        raise RuntimeError(f"the budget says xl does not fit "
                           f"{ACCELERATOR}: {bd.to_dict()}")
    gate = ctx.measured("gate", xl_gate, ctx, xl)
    x_per, x_tf, x_mfu, xnote = ctx.measured(
        "adamw", measure.measure_adamw_train_step, xl, 1,
        mu_dtype=torch.bfloat16, device=ctx.device)
    ctx.emit("train-step MFU, llama-like ~1.55B bf16 AdamW(optax) "
             "pure-bf16 state + remat, seq "
             f"{xl.seq}, b1, flash attention (budget {bd.total_gib:.1f}/"
             f"{bd.hbm_gib:.0f} GiB; {xnote}; step {x_per * 1e3:.1f} ms, "
             f"one {ctx.card})", *_rate(x_tf, x_mfu), None, step_s=x_per,
             tflops=x_tf, mfu=x_mfu, batch=1, model=model_fields(xl),
             train_step_flops=measure.train_step_flops(xl, 1),
             budget=bd.to_dict(), gate=gate)


def line_moe_train(ctx: Context) -> None:
    """``bench.py:2275-2293``."""
    moe = ctx.model("mixtral_like", ctx.sizes.moe_seq)
    m_per, m_tf, m_mfu = ctx.measured("sgd", measure.measure_train_step,
                                      moe, 1, device=ctx.device)
    note = measure.moe_flops_note(moe, 1)
    ctx.emit(f"train-step MFU, mixtral-like MoE bf16 ({moe.n_experts} "
             f"experts top-{moe.moe_top_k}, GQA), seq {moe.seq}, b1, "
             f"per-device-regime tokens ({note}; step {m_per * 1e3:.1f} ms, "
             f"one {ctx.card})", *_rate(m_tf, m_mfu), None, step_s=m_per,
             tflops=m_tf, mfu=m_mfu, batch=1, model=model_fields(moe),
             train_step_flops=measure.train_step_flops(moe, 1),
             moe_flops_note=note)


def line_decode(ctx: Context) -> None:
    """``bench.py:2295-2305``: greedy ``generate``, slope-timed."""
    cfg = ctx.model("llama_like", ctx.sizes.serve_seq)
    batch = ctx.sizes.decode_batch
    prompt_len, k1, k2 = ctx.sizes.decode_steps
    tok_s, mean_ctx = ctx.measured(
        "decode", measure.measure_decode, cfg, batch, prompt_len=prompt_len,
        k1=k1, k2=k2, device=ctx.device)
    bw = (measure.decode_bandwidth_utilization(cfg, batch, mean_ctx, tok_s)
          if ctx.on_card else None)
    bw_note = f", {bw:.0%} of peak HBM BW" if bw is not None else ""
    ctx.emit("KV-cache greedy decode throughput, llama-like 155M bf16, "
             f"b{batch}, prompt {prompt_len} (one {ctx.card}; decode is "
             f"bandwidth-bound{bw_note})", round(tok_s, 1), "tokens/s", 1.0,
             tokens_per_s=tok_s, mean_ctx=mean_ctx,
             hbm_bandwidth_utilization=bw, model=model_fields(cfg))


def _serve_geometry(ctx: Context, bucket: int, max_seq: int = 0) -> dict:
    return dict(slots=ctx.sizes.slots, max_seq=max_seq or ctx.sizes.serve_seq,
                prompt_bucket=bucket, device=ctx.device)


def _serving_model(ctx: Context):
    """The serving lines' model and its weights (``PRNGKey(0)``'s)."""
    cfg = ctx.model("llama_like", ctx.sizes.serve_seq)
    return cfg, seeded_params(ctx, cfg, 0)


def line_serving(ctx: Context) -> None:
    """``bench.py:2307-2333``: continuous batching of mixed requests."""
    cfg, params = _serving_model(ctx)
    rs = ctx.sizes.serving
    out = ctx.measured("serving", measure_serving, cfg, params,
                       rs.draw(cfg.vocab),
                       **_serve_geometry(ctx, ctx.sizes.serve_bucket))
    ctx.emit("continuous-batching serve throughput, llama-like 155M bf16, "
             f"{ctx.sizes.slots} slots, {rs.n} mixed requests ({rs.text()}), "
             f"occupancy {out['occupancy']:.2f} (one {ctx.card})",
             round(out["tokens_per_s"], 1), "tokens/s", 1.0, **out,
             model=model_fields(cfg))


def line_chunked(ctx: Context) -> None:
    """``bench.py:2335-2363``: long prompts, monolithic then chunked."""
    cfg, params = _serving_model(ctx)
    reqs = ctx.sizes.long_prompts.draw(cfg.vocab)
    geometry = _serve_geometry(ctx, ctx.sizes.long_bucket)
    chunk = ctx.sizes.chunk
    mono = ctx.measured("monolithic", measure_serving, cfg, params, reqs,
                        **geometry)
    chunked = ctx.measured("chunked", measure_serving, cfg, params, reqs,
                           chunk_prefill=chunk, **geometry)
    rs = ctx.sizes.long_prompts
    ctx.emit(f"chunked-prefill serve, long prompts {rs.prompt[0]}-"
             f"{rs.prompt[1]} chunk={chunk}: max resident stall "
             f"{chunked['max_tick_gap_s'] * 1e3:.1f} ms vs monolithic "
             f"{mono['max_tick_gap_s'] * 1e3:.1f} ms; throughput "
             f"{chunked['tokens_per_s']:.0f} vs {mono['tokens_per_s']:.0f} "
             f"tok/s (one {ctx.card})",
             round(chunked["max_tick_gap_s"] * 1e3, 2), "ms",
             round(mono["max_tick_gap_s"]
                   / max(chunked["max_tick_gap_s"], 1e-9), 2),
             chunked=chunked, monolithic=mono, model=model_fields(cfg))


def first_difference(params, cfg: ModelConfig, prompt: np.ndarray,
                     plain: np.ndarray, spec: np.ndarray,
                     device: torch.device) -> Optional[dict]:
    """None for equal streams; else where ``spec`` first leaves ``plain``:
    the plain stream up to that index scored by a solo ``prefill``, and the
    index, both tokens, their logits there and the relative margin (the
    difference over the larger magnitude)."""
    plain, spec = [int(t) for t in plain], [int(t) for t in spec]
    i = next((i for i, (a, b) in enumerate(zip(plain, spec)) if a != b),
             None)
    if i is None:
        return None
    ctx_tokens = torch.as_tensor(np.concatenate(
        [np.asarray(prompt), plain[:i]]), device=device)[None].long()
    with torch.no_grad():
        logits, _ = prefill(params, init_kv_cache(
            cfg, 1, ctx_tokens.shape[1], device), ctx_tokens, cfg)
    row = logits[0, -1].float()
    a, b = row[plain[i]].item(), row[spec[i]].item()
    return {"index": i, "plain": [plain[i], a], "spec": [spec[i], b],
            "margin": abs(a - b) / max(abs(a), abs(b), 1e-30)}


def line_spec_solo(ctx: Context) -> None:
    """``bench.py:2365-2413``: plain greedy ``generate`` against self-draft
    ``speculative_generate``, which must give the same tokens up to a near
    tie. As the reference's timed calls run programs its warm calls
    compiled, each timed call here replays the programs that a warm call
    captured (:class:`~.decode.Generation`,
    :class:`~.spec_decode.Speculation`)."""
    cfg = ctx.model("llama_like", ctx.sizes.serve_seq)
    params = seeded_params(ctx, cfg, 1)
    prompt = torch.randint(0, cfg.vocab, (1, ctx.sizes.spec_prompt),
                           generator=torch.Generator(device=ctx.device)
                           .manual_seed(2), device=ctx.device)
    steps, k = ctx.sizes.spec_steps, ctx.sizes.spec_k
    s0 = ctx.sizes.spec_prompt

    def run():
        plain = Generation(params, cfg, 1, s0, steps, ctx.device)
        spec = Speculation(params, cfg, params, cfg, s0, steps, k,
                           ctx.device)
        plain(prompt)         # warm calls: they capture the programs that
        spec(prompt)          # the timed calls replay
        _sync(ctx)
        t0 = time.perf_counter()
        ref = plain(prompt)
        _sync(ctx)
        plain_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got, stats = spec(prompt)
        spec_s = time.perf_counter() - t0
        return ref[0].cpu().numpy(), plain_s, got, stats, spec_s

    ref, plain_s, got, stats, spec_s = ctx.measured("spec_solo", run)
    tie = first_difference(params, cfg, prompt[0].cpu().numpy(), ref,
                           got[0], ctx.device)
    if tie is not None:
        if tie["margin"] > NEAR_TIE:
            raise RuntimeError(f"speculative decoding left plain greedy "
                               f"decoding without a near tie: {tie}")
        ctx.emit("speculative decode DIVERGED from plain greedy at token "
                 f"{tie['index']} of {steps + 1} (near-tie argmax across "
                 "program shapes?) — exactness holds on CPU; timing "
                 "suppressed", None, "", None, near_tie=tie, **stats,
                 model=model_fields(cfg))
        return
    ctx.emit(f"speculative decode ceiling (self-draft, k={k}, {steps + 1} "
             f"tokens, 155M bf16): {stats['target_calls']} target streams "
             f"vs {stats['plain_calls']} plain; exact-output asserted (one "
             f"{ctx.card}; vs_baseline = plain/spec wall ratio)",
             round((steps + 1) / spec_s, 1), "tokens/s",
             round(plain_s / spec_s, 2), plain_s=plain_s, spec_s=spec_s,
             **stats, model=model_fields(cfg))


def line_spec_serving(ctx: Context) -> None:
    """``bench.py:2415-2443``: the plain engine against the self-draft
    speculative engine on one request set."""
    cfg, params = _serving_model(ctx)
    rs, k = ctx.sizes.spec_serving, ctx.sizes.spec_k
    reqs = rs.draw(cfg.vocab)
    geometry = _serve_geometry(ctx, ctx.sizes.serve_bucket)
    plain = ctx.measured("plain", measure_serving, cfg, params, reqs,
                         **geometry)
    spec = ctx.measured("speculative", measure_serving, cfg, params, reqs,
                        draft_params=params, draft_cfg=cfg, spec_k=k,
                        **geometry)
    ctx.emit(f"batched speculative serving ceiling (self-draft k={k}, "
             f"{ctx.sizes.slots} slots, {rs.n} requests): "
             f"{spec['spec_rounds']:.0f} verify rounds, accept "
             f"{spec['spec_accepted']:.0f}/{spec['spec_drafted']:.0f} (one "
             f"{ctx.card}; vs_baseline = plain/spec wall ratio)",
             round(spec["tokens_per_s"], 1), "tokens/s",
             round(plain["elapsed_s"] / max(spec["elapsed_s"], 1e-9), 2),
             **spec, plain=plain, model=model_fields(cfg))


def line_int8_serving(ctx: Context) -> None:
    """``bench.py:2445-2480``: the exact and the int8 arena on one set of
    long prompts."""
    seq = ctx.sizes.int8_seq
    cfg = ctx.model("llama_like", seq)
    params = seeded_params(ctx, cfg, 4)
    rs = ctx.sizes.int8
    reqs = rs.draw(cfg.vocab)
    geometry = _serve_geometry(ctx, ctx.sizes.int8_bucket, seq)
    exact = ctx.measured("exact", measure_serving, cfg, params, reqs,
                         **geometry)
    i8_cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    quant = ctx.measured("int8", measure_serving, i8_cfg, params, reqs,
                         **geometry)
    slots = ctx.sizes.slots
    exact_gib = budget.serve_hbm_breakdown(cfg, slots, seq).kv_arena_gib
    int8_gib = budget.serve_hbm_breakdown(i8_cfg, slots, seq).kv_arena_gib
    ctx.emit(f"int8 KV arena serving, long prompts {rs.prompt[0]}-"
             f"{rs.prompt[1]}, {slots} slots x {seq} rows: "
             f"{quant['tokens_per_s']:.0f} vs exact "
             f"{exact['tokens_per_s']:.0f} tok/s; arena {int8_gib:.2f} vs "
             f"{exact_gib:.2f} GiB (one {ctx.card}; vs_baseline = "
             "int8/exact tok/s)", round(quant["tokens_per_s"], 1),
             "tokens/s",
             round(quant["tokens_per_s"] / max(exact["tokens_per_s"], 1e-9),
                   2), int8=quant, exact=exact,
             arena_gib={"int8": int8_gib, "exact": exact_gib},
             model=model_fields(cfg))


def line_slo(ctx: Context) -> None:
    """``bench.py:2482-2509``: Poisson arrivals, monolithic and chunked,
    against a TTFT SLO in ticks."""
    cfg, params = _serving_model(ctx)
    rs, chunk = ctx.sizes.slo, ctx.sizes.chunk
    reqs, arrivals = slo_requests(cfg.vocab, rs)
    for label, ckw in (("monolithic", {}),
                       (f"chunked cp={chunk}", {"chunk_prefill": chunk})):
        m = ctx.measured(label, measure_serving_slo, cfg, params, reqs,
                         arrivals, ttft_slo_ticks=ctx.sizes.slo_ttft_ticks,
                         **_serve_geometry(ctx, ctx.sizes.slo_bucket), **ckw)
        ctx.emit(f"on-chip serving SLO [{label}]: 155M bf16, "
                 f"{ctx.sizes.slots} slots, {rs.n} Poisson arrivals — TTFT "
                 f"p50/p99 {m['ttft_s_p50'] * 1e3:.1f}/"
                 f"{m['ttft_s_p99'] * 1e3:.1f} ms, per-token "
                 f"{m['per_token_s'] * 1e3:.2f} ms, goodput "
                 f"{m['goodput_tokens_per_s']:.0f} tok/s at a "
                 f"{ctx.sizes.slo_ttft_ticks}-tick TTFT SLO, attainment "
                 f"{m['slo_attainment']:.2f} (one {ctx.card})",
                 round(m["ttft_s_p99"] * 1e3, 2), "ms",
                 round(m["slo_attainment"], 3), **m, model=model_fields(cfg))


LINES: Dict[str, Callable[[Context], None]] = {
    "calibrate": line_calibrate,
    "train_155m": line_train_155m,
    "long_context": line_long_context,
    "adamw_0_67b": line_adamw_0_67b,
    "adamw_xl": line_adamw_xl,
    "moe_train": line_moe_train,
    "decode": line_decode,
    "serving": line_serving,
    "chunked": line_chunked,
    "spec_solo": line_spec_solo,
    "spec_serving": line_spec_serving,
    "int8_serving": line_int8_serving,
    "slo": line_slo,
}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpusched_torch.bench",
        description="The reference's on-chip workload lines on the port, "
                    "one JSON line each.")
    parser.add_argument("--device", default=None,
                        help="'cpu' to run there (default: the card)")
    parser.add_argument("--lines", default=None,
                        help="comma-separated line groups to run, of: "
                             + ", ".join(LINES) + " (default: all)")
    args = parser.parse_args(argv)
    names = args.lines.split(",") if args.lines else list(LINES)
    unknown = sorted(set(names) - set(LINES))
    if unknown:
        parser.error(f"unknown line groups: {', '.join(unknown)}")
    if args.device is None and not torch.cuda.is_available():
        print("tpusched_torch.bench: no CUDA device; the runner runs on the "
              "card unless --device cpu is given", file=sys.stderr)
        return 1
    ctx = context(args.device)
    for name in LINES:           # the reference's order, whatever was asked
        if name in names:
            ctx.start(name)
            LINES[name](ctx)     # a failure raises: the run stops here
    return 0


if __name__ == "__main__":
    sys.exit(main())
