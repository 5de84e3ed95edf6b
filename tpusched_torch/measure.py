"""Training step time, TFLOP/s and MFU on the card.

Counterpart of the training half of ``tpusched/jaxbridge/measure.py``. The
method is the reference's: run K dependent steps, fence the last one, and
take the slope between two chain lengths K1 < K2, (t2 − t1) / (K2 − K1), so
the fixed cost of starting and fencing a chain cancels. PyTorch runs eagerly,
so a chain is K calls of the step, each consuming the previous one's
parameters; the fence is ``torch.cuda.synchronize()`` and then the last
loss's ``.item()``. FLOPs are counted analytically (:func:`train_step_flops`),
so remat's recompute shows as lost MFU, not as hidden work.

Every entry point runs on the card unless given ``device="cpu"``; on the CPU
there is no peak to hold a rate against, and MFU is None.
"""
from __future__ import annotations

import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from . import optim
from .workload import (ModelConfig, init_params, make_optax_train_step,
                       resolve_device, sgd_train_step, tree_leaves)

# dense bf16 peak TFLOP/s by device name (NVIDIA's data sheets)
_PEAK_TFLOPS = (
    ("H100 PCIe", 756.0),
    ("H100 80GB HBM3", 989.0),           # the SXM part's name in torch
    ("H100 SXM", 989.0),
)


def device_peak_tflops(device=None) -> Optional[float]:
    """bf16 dense peak of ``device`` (default: the current CUDA card), or
    None for an unknown card or the CPU: callers then make no MFU claim."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    for key, peak in _PEAK_TFLOPS:
        if key in name:
            return peak
    return None


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


def _fence(loss: torch.Tensor) -> float:
    if loss.device.type == "cuda":
        torch.cuda.synchronize(loss.device)
    return loss.item()


def _timed(fn, *args) -> float:
    t0 = time.perf_counter()
    out = fn(*args)
    _fence(out[-1])
    return time.perf_counter() - t0


def train_step_flops(cfg: ModelConfig, batch: int) -> int:
    """Analytic FLOPs of one train step, counting what the code runs:
    parameter matmuls 6·N per token (2 forward, 4 backward; the embedding
    gather costs none, the output projection is in N), and causal attention
    as 9 causal-halved score-sized matmuls per layer (forward QKᵀ and PV;
    the dK/dV kernel recomputes S and forms dV, dP and dK; the dQ kernel
    recomputes S and forms dP and dQ): 9·B·S²·d_model."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    d_kv = (d // cfg.n_heads) * cfg.kv_heads
    tokens = batch * cfg.seq
    per_layer_attn = d * d * 2 + d * d_kv * 2
    matmul = 6 * (v * d + cfg.n_layers * per_layer_attn) * tokens
    matmul += 6 * cfg.n_layers * (d * f * 3) * tokens
    attn = 9 * batch * cfg.seq**2 * d * cfg.n_layers
    return matmul + attn


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
        return p, loss

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
