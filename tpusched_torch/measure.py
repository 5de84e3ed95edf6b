"""Training step time, TFLOP/s and MFU, decode throughput and HBM bandwidth
utilization on the card, the in-band goodput reporter, and the timing
path's calibration.

Counterpart of ``tpusched/jaxbridge/measure.py``. The method is the
reference's: run K dependent steps, fence the last one, and take the slope
between two chain lengths K1 < K2, (t2 − t1) / (K2 − K1), so the fixed
cost of starting and fencing a chain cancels. PyTorch runs eagerly, so a chain is K calls of the
step, each consuming the previous one's output; the fence is
``torch.cuda.synchronize()`` and then a scalar's ``.item()``. FLOPs and
decode bytes are counted analytically (:func:`train_step_flops`,
:func:`decode_bytes_per_token`), so remat's recompute shows as lost MFU, not
as hidden work. :func:`calibrate` times a chain of bf16 matmuls of known
cost the same way: a reading above the card's peak means the timing path
is broken.

:class:`GoodputReporter` folds step times, items, TTFT and stalls into one
:class:`GangMemberStatus` report a window for the scheduler's telemetry
plane; the record is this package's own copy of the scheduler's, with the
same fields, since this package never imports ``tpusched``.

Every entry point runs on the card unless given ``device="cpu"``; on the CPU
there is no peak to hold a rate against, and MFU and bandwidth utilization
are None.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from . import optim
from .decode import generate
from .workload import (ModelConfig, init_params, make_optax_train_step,
                       make_sharded_train_step, moe_capacity, resolve_device,
                       tree_leaves, tree_map)


@dataclasses.dataclass
class GangMemberStatus:
    """One in-band progress report of a running gang member:
    ``tpusched.api.core.GangMemberStatus``'s fields and defaults, copied.
    The apiserver reads reports by attribute, so this record reaches a real
    aggregator unchanged. ``throughput`` is items of ``unit`` a second
    across the member, ``step`` its step index or serving tick, ``ttft_s``
    its serving time to first token over the window (0: not serving),
    ``stall_s`` the checkpoint or restore stall in the window, and
    ``timestamp`` 0 until the server stamps it."""
    pod_key: str = ""
    gang: str = ""
    step: int = 0
    step_time_s: float = 0.0
    throughput: float = 0.0
    unit: str = "tokens"
    ttft_s: float = 0.0
    stall_s: float = 0.0
    timestamp: float = 0.0


class GoodputReporter:
    """The in-band goodput emitter, as the reference's. A training or
    serving loop folds observations in (:meth:`observe_step` a step or
    tick, :meth:`observe_ttft` and :meth:`observe_stall` as they happen),
    and the reporter sends at most one :class:`GangMemberStatus` a
    ``min_interval_s`` through ``clientset.report_status``. Sending is
    advisory: never retried, and a lost report is superseded by the next
    window's.

    Throughput is Σitems / Σstep time over the window, the device rate;
    stalls ride apart in ``stall_s``. Clocks are monotonic (``clock`` is
    injectable for tests); the server stamps the wall time on ingest."""

    def __init__(self, clientset, pod_key: str, gang: str = "",
                 unit: str = "tokens", min_interval_s: float = 5.0,
                 clock=time.monotonic):
        self._client = clientset
        self.pod_key = pod_key
        self.gang = gang
        self.unit = unit
        self.min_interval_s = min_interval_s
        self._clock = clock
        self._last_flush = -1.0          # < 0: never flushed
        self._step = 0
        self._step_time_sum = 0.0
        self._steps_observed = 0
        self._items = 0.0
        self._ttft_s = 0.0
        self._stall_s = 0.0
        self.sent = 0

    def observe_step(self, step: int, step_time_s: float,
                     items: float = 0.0) -> None:
        """One completed step (training) or tick (serving): its index, its
        seconds, and the items (tokens, examples, requests) it produced."""
        self._step = max(self._step, int(step))
        if step_time_s > 0:
            self._step_time_sum += step_time_s
            self._steps_observed += 1
        self._items += max(0.0, items)

    def observe_ttft(self, ttft_s: float) -> None:
        """Serving time to first token over the window (the latest wins)."""
        if ttft_s > 0:
            self._ttft_s = ttft_s

    def observe_stall(self, seconds: float) -> None:
        """Checkpoint, restore or other unproductive seconds."""
        self._stall_s += max(0.0, seconds)

    def maybe_flush(self) -> bool:
        """:meth:`flush` unless the last one was under ``min_interval_s``
        ago; call it freely from the loop."""
        now = self._clock()
        if 0 <= self._last_flush and now - self._last_flush \
                < self.min_interval_s:
            return False
        return self.flush()

    def flush(self) -> bool:
        """Send the window now; an empty window is skipped. The window is
        reset whether or not the send succeeds, so stale numbers never
        spill into the next one."""
        if self._steps_observed == 0 and self._items == 0 \
                and self._ttft_s == 0 and self._stall_s == 0:
            return False
        report = GangMemberStatus(
            pod_key=self.pod_key, gang=self.gang, step=self._step,
            step_time_s=(self._step_time_sum / self._steps_observed
                         if self._steps_observed else 0.0),
            throughput=(self._items / self._step_time_sum
                        if self._step_time_sum > 0 else 0.0),
            unit=self.unit, ttft_s=self._ttft_s, stall_s=self._stall_s)
        self._last_flush = self._clock()
        self._step_time_sum = 0.0
        self._steps_observed = 0
        self._items = 0.0
        self._ttft_s = 0.0
        self._stall_s = 0.0
        self._client.report_status([report])
        self.sent += 1
        return True


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


def calibrate(n: int = 4096, k1: int = 16, k2: int = 64,
              device=None) -> float:
    """Measured TFLOP/s of a chain of dependent bf16 n×n matmuls,
    ``(x @ b) * (1/n)``, k long and summed to an f32 scalar, timed at k1 and
    k2 and taken from the slope (:func:`time_chained`): the probe of known
    cost that validates the timing path. A reading above
    :func:`device_peak_tflops` means the timing is broken."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    a = torch.randn(n, n, generator=gen, device=device).to(torch.bfloat16)
    b = torch.randn(n, n, generator=gen, device=device).to(torch.bfloat16)

    def chain(k):
        x = a
        for _ in range(k):
            x = (x @ b) * (1.0 / n)
        return x.float().sum()

    for k in (k1, k2):                       # warm both lengths
        _timed(chain, k)
    per_iter = time_chained(lambda k: _timed(chain, k), k1, k2)
    return 2 * n**3 / per_iter / 1e12


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
                       reporter: Optional[GoodputReporter] = None,
                       device=None) -> Tuple[float, float, Optional[float]]:
    """Median per-step seconds, TFLOP/s and MFU (None on the CPU or an
    unknown card) of the SGD step (``make_sharded_train_step`` without a
    mesh), each step taking the previous one's parameters. As the
    reference copies its seeded params into a donated chain for every run,
    each run copies them into the parameters the step is bound to and
    updates those in place, so every run replays the one CUDA graph that
    the first warm run captured. ``reporter`` gets the measured step time
    and batch·seq tokens a step as one report."""
    device = resolve_device(device)
    start = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                        device)
    params = tree_map(torch.clone, start)
    tokens = _tokens(cfg, batch, device)
    step, _, _ = make_sharded_train_step(None, cfg, lr=lr)

    def chain(k):
        tree_map(lambda p, s: p.copy_(s), params, start)
        loss = None
        for _ in range(k):
            _, loss = step(params, tokens)
        return loss

    for k in (k1, k2):
        _timed(chain, k)
    per_step = time_chained(lambda k: _timed(chain, k), k1, k2, repeats)
    if reporter is not None:
        reporter.observe_step(k2, per_step, items=batch * cfg.seq)
        reporter.flush()
    return (per_step, *_rates(cfg, batch, per_step, device))


def measure_adamw_train_step(cfg: ModelConfig, batch: int, k1: int = 1,
                             k2: int = 4, repeats: int = 3,
                             lr: float = 1e-4, mu_dtype=None, device=None
                             ) -> Tuple[float, float, Optional[float], str]:
    """Per-step seconds, TFLOP/s, MFU and an accounting note for AdamW
    training with full optimizer state, through ``make_optax_train_step``
    (value and grad, then the in-place AdamW update), mu in ``mu_dtype``
    (f32 by default) over params in ``cfg.master_dtype``. Every run starts
    from the seeded init: ``fresh()`` copies it into the params and state
    the step is bound to (moments zeroed, count 0), so every run replays
    the one CUDA graph that the first warm run captured, outside the
    slope. Returns (per_step_s, tflops, mfu, note)."""
    device = resolve_device(device)
    tx = optim.adamw(lr, mu_dtype=mu_dtype if mu_dtype is not None
                     else torch.float32)
    tokens = _tokens(cfg, batch, device)
    step, init_opt, _, _ = make_optax_train_step(None, cfg, tx)
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device)
    state = init_opt(params)

    def fresh():
        seeded = init_params(
            cfg, torch.Generator(device=device).manual_seed(0), device)
        tree_map(lambda p, s: p.copy_(s), params, seeded)
        del seeded
        for t in tree_leaves(state.mu) + tree_leaves(state.nu):
            t.zero_()
        state.count = 0

    def run(k: int) -> float:
        fresh()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        loss = None
        for _ in range(k):
            _, _, loss = step(params, state, tokens)
        _fence(loss)
        return time.perf_counter() - t0

    leaves = tree_leaves(params)
    state_gib = sum(t.numel() * t.element_size() for t in
                    leaves + tree_leaves(state.mu) + tree_leaves(state.nu)
                    ) / 2**30
    note = (f"{sum(t.numel() for t in leaves) / 1e9:.2f}B params, "
            f"params+AdamW state {state_gib:.1f} GiB resident, "
            f"remat={cfg.remat}")
    del leaves
    run(k1)                         # warm: builds the kernels, captures
    run(k2)
    per_step = time_chained(run, k1, k2, repeats)
    return (per_step, *_rates(cfg, batch, per_step, device), note)


def measure_decode(cfg: ModelConfig, batch: int, prompt_len: int = 128,
                   k1: int = 64, k2: int = 256, repeats: int = 3,
                   device=None) -> Tuple[float, int]:
    """Decode throughput (tokens/s across the batch) of greedy
    ``decode.generate``, slope-timed between runs of k1 and k2 decode steps
    so the prefill, the step program's capture and the fence cancel (on the
    card each step is one replay of a CUDA graph, as the reference times
    its one jitted program). Returns (tokens_per_s, mean_ctx),
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
