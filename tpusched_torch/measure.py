"""Training step time, TFLOP/s and MFU, and decode throughput and HBM
bandwidth utilization, on the card.

Counterpart of the training and decode half of
``tpusched/jaxbridge/measure.py``. The method is the reference's: run K
dependent steps, fence the last one, and take the slope between two chain
lengths K1 < K2, (t2 − t1) / (K2 − K1), so the fixed cost of starting and
fencing a chain cancels. PyTorch runs eagerly, so a chain is K calls of the
step, each consuming the previous one's output; the fence is
``torch.cuda.synchronize()`` and then a scalar's ``.item()``. FLOPs and
decode bytes are counted analytically (:func:`train_step_flops`,
:func:`decode_bytes_per_token`), so remat's recompute shows as lost MFU, not
as hidden work.

Every entry point runs on the card unless given ``device="cpu"``; on the CPU
there is no peak to hold a rate against, and MFU and bandwidth utilization
are None.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from . import optim
from .decode import generate
from .workload import (ModelConfig, init_params, make_optax_train_step,
                       moe_capacity, resolve_device, sgd_train_step,
                       tree_leaves)

# dense bf16 peak TFLOP/s by device name (NVIDIA's data sheets)
_PEAK_TFLOPS = (
    ("H100 PCIe", 756.0),
    ("H100 80GB HBM3", 989.0),           # the SXM part's name in torch
    ("H100 SXM", 989.0),
)

# HBM bandwidth peak GB/s by device name (NVIDIA's data sheets): the decode
# roofline, as a decode step streams every weight and the live KV prefix
_PEAK_HBM_GBPS = (
    ("H100 PCIe", 2000.0),
    ("H100 80GB HBM3", 3350.0),
    ("H100 SXM", 3350.0),
)


def _peak_by_name(table, device) -> Optional[float]:
    """The entry of ``table`` for ``device`` (default: the current CUDA
    card), or None for an unknown card or the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for key, peak in table:
        if key in name:
            return peak
    return None


def device_peak_tflops(device=None) -> Optional[float]:
    """bf16 dense peak of ``device`` (default: the current CUDA card), or
    None for an unknown card or the CPU: callers then make no MFU claim."""
    return _peak_by_name(_PEAK_TFLOPS, device)


def device_peak_hbm_gbps(device=None) -> Optional[float]:
    """HBM bandwidth peak of ``device`` in GB/s (default: the current CUDA
    card), or None for an unknown card or the CPU."""
    return _peak_by_name(_PEAK_HBM_GBPS, device)


def decode_bytes_per_token(cfg: ModelConfig, batch: int,
                           mean_ctx: int) -> int:
    """HBM bytes one decode STEP must stream, the bandwidth roofline's
    numerator: every matmul weight once per step (shared by the batch), the
    embedding rows the batch gathers (not the table), and each sequence's
    live KV prefix. An MoE layer streams all E expert stacks (dropless
    decode runs every expert) and its f32 router; an int8 cache is one byte
    an element plus an f32 scale per (row, KV head)."""
    itemsize = cfg.dtype.itemsize
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    d_kv = (d // cfg.n_heads) * cfg.kv_heads
    attn_w = d * d + d * d_kv * 2 + d * d                 # wq wk wv wo
    if cfg.n_experts:
        per_layer = attn_w + 3 * d * f * cfg.n_experts
        extra = cfg.n_layers * d * cfg.n_experts * 4     # f32 router
    else:
        per_layer = attn_w + 3 * d * f
        extra = 0
    streamed = v * d + cfg.n_layers * per_layer + batch * d  # out + embed rows
    kv_elems = batch * mean_ctx * cfg.n_layers * 2 * d_kv
    if cfg.kv_cache_dtype == "int8":
        kv_bytes = kv_elems + (kv_elems // (d // cfg.n_heads)) * 4
    else:
        kv_bytes = kv_elems * itemsize
    return streamed * itemsize + kv_bytes + extra


def decode_bandwidth_utilization(cfg: ModelConfig, batch: int,
                                 mean_ctx: int,
                                 tokens_per_s: float) -> Optional[float]:
    """Achieved share of the current card's HBM bandwidth in a decode loop:
    steps/s × :func:`decode_bytes_per_token` over the peak; None on the CPU
    or an unknown card."""
    peak = device_peak_hbm_gbps()
    if peak is None:
        return None
    achieved = tokens_per_s / batch * decode_bytes_per_token(cfg, batch,
                                                             mean_ctx)
    return achieved / (peak * 1e9)


def time_chained(run: Callable[[int], float], k1: int = 4, k2: int = 16,
                 repeats: int = 3) -> float:
    """Per-iteration seconds via the two-point slope. ``run(k)`` executes a
    K-long dependent chain to a fence and returns elapsed wall seconds; it
    must already be warm for both k. The median of ``repeats`` slopes
    (medians of the raw times could pair a fast t1 with a slow t2)."""
    slopes = []
    for _ in range(repeats):
        t1 = run(k1)
        t2 = run(k2)
        slopes.append((t2 - t1) / (k2 - k1))
    return float(np.median(slopes))


def _fence(scalar: torch.Tensor) -> float:
    if scalar.device.type == "cuda":
        torch.cuda.synchronize(scalar.device)
    return scalar.item()


def _timed(fn, *args) -> float:
    """Wall seconds of ``fn(*args)``, fenced on the scalar it returns."""
    t0 = time.perf_counter()
    _fence(fn(*args))
    return time.perf_counter() - t0


def train_step_flops(cfg: ModelConfig, batch: int) -> int:
    """Analytic FLOPs of one train step, counting what the code runs:
    parameter matmuls 6·N per token (2 forward, 4 backward; the embedding
    gather costs none, the output projection is in N), and causal attention
    as 9 causal-halved score-sized matmuls per layer (forward QKᵀ and PV;
    the dK/dV kernel recomputes S and forms dV, dP and dK; the dQ kernel
    recomputes S and forms dP and dQ): 9·B·S²·d_model. An MoE layer's MLP
    term is what ``workload._moe_mlp`` runs instead (:func:`_moe_layer_flops`):
    the router, the experts over E·C slots (padding included), and the
    one-hot dispatch and combine einsums."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    d_kv = (d // cfg.n_heads) * cfg.kv_heads
    tokens = batch * cfg.seq
    per_layer_attn = d * d * 2 + d * d_kv * 2
    matmul = 6 * (v * d + cfg.n_layers * per_layer_attn) * tokens
    if cfg.n_experts:
        matmul += cfg.n_layers * sum(_moe_layer_flops(cfg, tokens).values())
    else:
        matmul += 6 * cfg.n_layers * (d * f * 3) * tokens
    attn = 9 * batch * cfg.seq**2 * d * cfg.n_layers
    return matmul + attn


def _moe_layer_flops(cfg: ModelConfig, tokens: int) -> dict:
    """One MoE layer's FLOPs in a train step: the router (a d×E matmul,
    6·n·d·E), the experts (6N over E·C slots: 18·E·C·d·f), and the dispatch
    and combine einsums, 5 of (k·n)·E·C·d multiply-adds (dispatch and
    combine forward, three live backward contractions; the one-hots carry
    no gradient): 10·k·n·E·C·d."""
    d, f = cfg.d_model, cfg.d_ff
    e, k = cfg.n_experts, cfg.moe_top_k
    cap = moe_capacity(cfg, tokens)
    return {"router": 6 * tokens * d * e,
            "experts": 18 * e * cap * d * f,
            "dispatch": 10 * k * tokens * e * cap * d}


def moe_flops_note(cfg: ModelConfig, batch: int) -> str:
    """The MoE step's FLOPs split, model against dispatch, for a line that
    quotes its MFU."""
    tokens = batch * cfg.seq
    total = train_step_flops(cfg, batch)
    dispatch = cfg.n_layers * _moe_layer_flops(cfg, tokens)["dispatch"]
    return (f"E={cfg.n_experts} top{cfg.moe_top_k} "
            f"C={moe_capacity(cfg, tokens)}; dispatch/combine einsums are "
            f"{100 * dispatch / total:.0f}% of the {total / 1e12:.2f} "
            f"TFLOP step budget")


def _tokens(cfg: ModelConfig, batch: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(1)
    return torch.randint(0, cfg.vocab, (batch, cfg.seq), generator=gen,
                         device=device)


def _rates(cfg: ModelConfig, batch: int, per_step: float, device):
    tflops = train_step_flops(cfg, batch) / per_step / 1e12
    peak = device_peak_tflops(device)
    return tflops, (tflops / peak if peak else None)


def measure_train_step(cfg: ModelConfig, batch: int, k1: int = 2,
                       k2: int = 8, repeats: int = 3, lr: float = 1e-4,
                       device=None) -> Tuple[float, float, Optional[float]]:
    """Median per-step seconds, TFLOP/s and MFU (None on the CPU or an
    unknown card) of :func:`workload.sgd_train_step`, each step taking the
    previous one's parameters."""
    device = resolve_device(device)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    tokens = _tokens(cfg, batch, device)

    def chain(k):
        p, loss = params, None
        for _ in range(k):
            p, loss = sgd_train_step(p, tokens, cfg, lr=lr)
        return loss

    for k in (k1, k2):
        _timed(chain, k)
    per_step = time_chained(lambda k: _timed(chain, k), k1, k2, repeats)
    return (per_step, *_rates(cfg, batch, per_step, device))


def measure_adamw_train_step(cfg: ModelConfig, batch: int, k1: int = 1,
                             k2: int = 4, repeats: int = 3,
                             lr: float = 1e-4, mu_dtype=None, device=None
                             ) -> Tuple[float, float, Optional[float], str]:
    """Per-step seconds, TFLOP/s, MFU and an accounting note for AdamW
    training with full optimizer state, through ``make_optax_train_step``
    (value and grad, then the in-place AdamW update), mu in ``mu_dtype``
    (f32 by default) over params in ``cfg.master_dtype``. Params and state are built fresh on the device for
    every run, so each chain starts from the same point and no second copy
    is kept. Returns (per_step_s, tflops, mfu, note)."""
    device = resolve_device(device)
    tx = optim.adamw(lr, mu_dtype=mu_dtype if mu_dtype is not None
                     else torch.float32)
    tokens = _tokens(cfg, batch, device)
    step, init_opt, _, _ = make_optax_train_step(None, cfg, tx)

    def fresh():
        p = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                        device)
        return p, init_opt(p)

    def run(k: int) -> float:
        params, state = fresh()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        loss = None
        for _ in range(k):
            params, state, loss = step(params, state, tokens)
        _fence(loss)
        return time.perf_counter() - t0

    params, state = fresh()
    leaves = tree_leaves(params)
    state_gib = sum(t.numel() * t.element_size() for t in
                    leaves + tree_leaves(state.mu) + tree_leaves(state.nu)
                    ) / 2**30
    note = (f"{sum(t.numel() for t in leaves) / 1e9:.2f}B params, "
            f"params+AdamW state {state_gib:.1f} GiB resident, "
            f"remat={cfg.remat}")
    del params, state, leaves
    run(k1)                                  # warm: builds the kernels
    run(k2)
    per_step = time_chained(run, k1, k2, repeats)
    return (per_step, *_rates(cfg, batch, per_step, device), note)


def measure_decode(cfg: ModelConfig, batch: int, prompt_len: int = 128,
                   k1: int = 64, k2: int = 256, repeats: int = 3,
                   device=None) -> Tuple[float, int]:
    """Decode throughput (tokens/s across the batch) of greedy
    ``decode.generate``, slope-timed between runs of k1 and k2 decode steps
    so the prefill and the fence cancel. Returns (tokens_per_s, mean_ctx),
    mean_ctx the mean live context over the slope window, from the same
    prompt_len, k1 and k2."""
    device = resolve_device(device)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    gen = torch.Generator(device=device).manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                           device=device)

    def run(k):
        return generate(params, prompt, cfg, k).sum()

    for k in (k1, k2):
        _timed(run, k)
    per_token = time_chained(lambda k: _timed(run, k), k1, k2, repeats)
    return batch / per_token, prompt_len + (k1 + k2) // 2
