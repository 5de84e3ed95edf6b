"""HBM budget: will a training or serving job fit its cards?

Counterpart of ``tpusched/jaxbridge/budget.py``, with its formulas and its
default safety factor of 1.10. An analytic, sharding-aware memory model of
the dense and MoE decoder LMs, derived from the parameter tree
``workload.init_params`` builds, so a capacity plan can be checked by
arithmetic before a gang is submitted:

- master params, the AdamW moments (mu and nu in configurable dtypes; nu
  follows mu when not given), a compute-dtype copy when ``param_dtype``
  differs, and gradients, all divided by fsdp × tp;
- activations under remat: each layer's residual and ONE block's recompute
  workspace; without remat every block's internals. Flash attention drops
  the s² score tensor, naive keeps it. Divided by sp;
- the (b, s, vocab) f32 loss logits, also divided by tp with
  ``vocab_parallel_loss``;
- serving: params and the (slots, max_seq) GQA KV arena (an int8 cache is
  one byte an element plus f32 scale planes).

Everything is GiB plus a ``fits`` verdict against :data:`ACCELERATORS`.
The table copies the scheduler's accelerator catalog
(``tpusched/api/topology.py``) by name, this package never importing
``tpusched``, and adds this port's card, ``h100-80gb``.
:func:`tpu_memory_request_mb` keeps the reference's name: it is the
scheduler's memory request unit.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from .workload import ModelConfig

GiB = 1024 ** 3


@dataclasses.dataclass(frozen=True)
class Accelerator:
    name: str
    hbm_mb_per_chip: int


# tpusched.api.topology.ACCELERATORS' memory per chip, copied by name, and
# the H100 80 GB by the same data-sheet convention (80 × 1024 MB)
ACCELERATORS: Dict[str, Accelerator] = {a.name: a for a in (
    Accelerator("tpu-v4", 32 * 1024),
    Accelerator("tpu-v5e", 16 * 1024),
    Accelerator("tpu-v5p", 95 * 1024),
    Accelerator("tpu-v6e", 32 * 1024),
    Accelerator("h100-80gb", 80 * 1024),
)}


def dtype_bytes(dt: Any) -> int:
    """Width of a torch or numpy dtype, or of the strings 'bf16', 'f32',
    'f16' and 'int8' (and 'bfloat16', 'float32'); None counts as f32."""
    if dt is None:
        return 4
    if isinstance(dt, str):
        return {"bf16": 2, "bfloat16": 2, "f32": 4, "float32": 4,
                "f16": 2, "int8": 1}[dt]
    if isinstance(dt, torch.dtype):
        return dt.itemsize
    import numpy as np
    return np.dtype(dt).itemsize


def count_params(cfg: ModelConfig) -> int:
    """The leaf count of ``workload.init_params``' tree, analytically."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    d_kv = (d // cfg.n_heads) * cfg.kv_heads
    per_layer = d * d * 2 + d * d_kv * 2 + 2 * d          # attn + 2 norms
    if cfg.n_experts:
        per_layer += cfg.n_experts * 3 * d * f + d * cfg.n_experts
    else:
        per_layer += 3 * d * f
    return v * d * 2 + d + cfg.n_layers * per_layer       # embed+out+ln_f


@dataclasses.dataclass
class TrainBreakdown:
    params_gib: float
    optimizer_gib: float
    grads_gib: float
    activations_gib: float
    logits_gib: float
    total_gib: float          # the sum × the safety factor
    n_params: int
    hbm_gib: Optional[float]  # per card, None without an accelerator
    fits: Optional[bool]
    utilization: Optional[float]
    note: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _verdict(total: float, accelerator: str):
    if not accelerator:
        return None, None, None
    hbm = ACCELERATORS[accelerator].hbm_mb_per_chip / 1024
    return hbm, total <= hbm, total / hbm


def train_hbm_breakdown(cfg: ModelConfig, batch: int, *,
                        mu_dtype: Any = "f32", nu_dtype: Any = None,
                        fsdp: int = 1, tp: int = 1, dp: int = 1,
                        sp: int = 1, accelerator: str = "",
                        safety: float = 1.10) -> TrainBreakdown:
    """Resident GiB a card for one AdamW train step of ``cfg`` at ``batch``
    rows a dp replica: params, optimizer state and gradients shard over
    fsdp × tp, activations over sp, the loss logits also over tp with
    ``vocab_parallel_loss``."""
    n = count_params(cfg)
    master_b = dtype_bytes(cfg.master_dtype)
    compute_b = dtype_bytes(cfg.dtype)
    pshard = max(1, fsdp) * max(1, tp)
    ashard = max(1, sp)
    params_gib = n * master_b / pshard / GiB
    if cfg.param_dtype is not None:
        params_gib += n * compute_b / pshard / GiB   # the compute cast
    opt_gib = n * (dtype_bytes(mu_dtype)
                   + dtype_bytes(nu_dtype if nu_dtype is not None
                                 else mu_dtype)) / pshard / GiB
    grads_gib = n * master_b / pshard / GiB
    d, f, s = cfg.d_model, cfg.d_ff, cfg.seq
    ff_width = 3 * f * (cfg.moe_top_k if cfg.n_experts else 1)
    block_internals = batch * s * (4 * d + ff_width) * compute_b
    if cfg.attn == "naive":
        block_internals += batch * cfg.n_heads * s * s * compute_b
    residuals = cfg.n_layers * batch * s * d * compute_b
    if cfg.remat:
        acts = residuals + block_internals            # one block recomputes
    else:
        acts = residuals + cfg.n_layers * block_internals
    acts_gib = acts / ashard / GiB
    logits_gib = (batch * s * cfg.vocab * 4
                  / (tp if cfg.vocab_parallel_loss else 1) / ashard / GiB)
    total = (params_gib + opt_gib + grads_gib + acts_gib
             + logits_gib) * safety
    note = (f"{n / 1e9:.2f}B params, shard fsdp{fsdp}×tp{tp}, "
            f"acts ÷ sp{sp}, batch/replica {batch}, safety ×{safety}")
    return TrainBreakdown(params_gib, opt_gib, grads_gib, acts_gib,
                          logits_gib, total, n, *_verdict(total, accelerator),
                          note)


@dataclasses.dataclass
class ServeBreakdown:
    params_gib: float
    kv_arena_gib: float
    total_gib: float
    hbm_gib: Optional[float]
    fits: Optional[bool]
    utilization: Optional[float]

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def serve_hbm_breakdown(cfg: ModelConfig, slots: int, max_seq: int, *,
                        tp: int = 1, accelerator: str = "",
                        safety: float = 1.10) -> ServeBreakdown:
    """Resident GiB a card for the continuous-batching engine: tp-sharded
    params and the (slots, max_seq, kv_heads, head_dim) K/V arena (int8:
    one byte an element and an f32 scale a row and head)."""
    n = count_params(cfg)
    params_gib = n * dtype_bytes(cfg.dtype) / max(1, tp) / GiB
    hd = cfg.d_model // cfg.n_heads
    rows = slots * max_seq * cfg.kv_heads
    if cfg.kv_cache_dtype == "int8":
        per_layer = 2 * (rows * hd + rows * 4)
    else:
        per_layer = 2 * rows * hd * dtype_bytes(cfg.dtype)
    kv_gib = cfg.n_layers * per_layer / max(1, tp) / GiB
    total = (params_gib + kv_gib) * safety
    return ServeBreakdown(params_gib, kv_gib, total,
                          *_verdict(total, accelerator))


def tpu_memory_request_mb(breakdown) -> int:
    """A breakdown as the scheduler's memory request, in MB."""
    return int(breakdown.total_gib * 1024 + 0.5)


def validate_plan(plan: Dict[str, Any]) -> Dict[str, Any]:
    """A JSON plan's check, as the reference's: ``plan`` is {"model":
    {ModelConfig fields, "dtype"/"param_dtype" as "bf16" or "f32"},
    "batch_per_replica", "mesh": {dp?, fsdp?, sp?, tp?}, "accelerator",
    "mu_dtype"?, "nu_dtype"?, "safety"?}. Returns the breakdown, the cards
    the mesh implies, the memory request and the verdict."""
    m = dict(plan["model"])
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}
    m["dtype"] = dt[m.get("dtype", "bf16")]
    if m.get("param_dtype"):
        m["param_dtype"] = dt[m["param_dtype"]]
    cfg = ModelConfig(**m)
    mesh = {k: int(v) for k, v in (plan.get("mesh") or {}).items()}
    bd = train_hbm_breakdown(
        cfg, int(plan.get("batch_per_replica", 1)),
        mu_dtype=plan.get("mu_dtype", "f32"),
        nu_dtype=plan.get("nu_dtype"),
        dp=mesh.get("dp", 1), fsdp=mesh.get("fsdp", 1),
        sp=mesh.get("sp", 1), tp=mesh.get("tp", 1),
        accelerator=plan.get("accelerator", ""),
        safety=float(plan.get("safety", 1.10)))
    chips = 1
    for v in mesh.values():
        chips *= max(1, v)
    return {"breakdown": bd.to_dict(), "chips": chips,
            "tpu_memory_request_mb": tpu_memory_request_mb(bd),
            "fits": bd.fits}
