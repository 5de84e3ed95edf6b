"""The Llama- and Mixtral-style decoder LMs in PyTorch: config, parameters,
forward, and the single-card train steps.

Counterpart of ``tpusched/jaxbridge/workload.py``. Plain functions on
tensors over the same parameter dict as the reference: keys
``embed``/``out``/``ln_f``/``layers[i]``, weights stored ``(in, out)`` and
used as ``h @ W``; an MoE layer (``n_experts > 0``) holds an f32 ``router``
(d, E) and expert stacks with a leading E axis. :class:`DecoderLM` is a
thin ``nn.Module`` owning those tensors so ``.to()`` and ``state_dict()``
work. Training: ``loss_fn``, ``value_and_grad`` (autograd over the dict's
tensors), ``sgd_train_step``, and ``make_optax_train_step``/
``make_accum_train_step`` around an optimizer from ``optim``. The three
step builders return programs (:mod:`.program`) that update params and
state in place: captured at their first call on the card, as one CUDA
graph on one card and as a chain of graphs broken at each collective over
a mesh (the backward's and the remat recompute's included), their bodies
called as they are on the CPU.

Parallelism (``mesh``): ``param_specs`` gives each leaf the reference's
partition spec, ``shard_params`` cuts this rank's slice, and the forward,
decode and loss take the tp axis (``tp=``) and run one code path for tp = 1
and tp > 1, with head counts read from the shard's weights and the
collectives of :mod:`.mesh` after the row-parallel products. The forward
and loss also take the fsdp axis (``fsdp=``: each sharded weight gathered
where it is used, its gradient reduce-scattered) and the sp axis (``sp=``:
this rank's chunk of the sequence, attention by :class:`TrainShardings`).
MoE layers take the ep axis and, in training, the axes the tokens are split
over (``moe=``, :class:`ExpertAxes`): each rank runs its E/ep experts, and
the capacity path routes the global batch's tokens as one program would.
The three train steps take meshes whose axes are in {slice, dp, fsdp, sp,
ep, tp}; a pp axis trains through ``pipeline.make_pipeline_train_step``.

Every entry point runs on the CUDA card unless the caller passes
``device="cpu"``; with no card and no explicit device it raises.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import math
import numbers
import types
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import attention, tracing
from .program import Program
from .mesh import (BATCH_AXES, DATA_AXES_BUT_FSDP, Axis, Mesh, all_reduce,
                   copy_to, gather, gather_last, local_chunk, reduce_from,
                   scatter_last)
from .mesh import all_gather as mesh_all_gather

Params = Dict[str, Any]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the one asked for, else the CUDA
    card. Never falls back to the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: tpusched_torch runs on the "
                               "card unless device='cpu' is passed")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        # "cuda" and "cuda:0" must compare equal to a tensor's device
        device = torch.device("cuda", torch.cuda.current_device())
    return device


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab: int = 2048
    d_model: int = 256
    n_layers: int = 2
    n_heads: int = 4
    d_ff: int = 512
    seq: int = 128
    dtype: torch.dtype = torch.float32
    # "naive" (materialized) or "flash" (the hand-written kernel); "ring"
    # and "ringflash" need an sp mesh and resolve to naive without one,
    # as in the reference
    attn: str = "naive"
    n_kv_heads: int = 0                  # 0 => n_heads (plain MHA)
    # mixture of experts (0 => dense SwiGLU): n_experts stacked SwiGLU
    # experts behind a top-k router, capacity dispatch in training and
    # dropless routing at inference, as in the reference
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    param_dtype: Optional[torch.dtype] = None   # master dtype when != dtype
    vocab_parallel_loss: bool = False           # training only
    remat: bool = False                         # training only
    kv_cache_dtype: Any = None                  # None (exact) or "int8"

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def master_dtype(self) -> torch.dtype:
        return self.param_dtype if self.param_dtype is not None else self.dtype

    def __post_init__(self):
        if self.n_heads % self.kv_heads:
            raise ValueError(
                f"n_kv_heads ({self.kv_heads}) must divide n_heads "
                f"({self.n_heads}) — each KV head serves an equal group")
        if self.d_model % self.n_heads:
            raise ValueError(
                f"n_heads ({self.n_heads}) must divide d_model ({self.d_model})")
        if self.kv_cache_dtype not in (None, "int8"):
            raise ValueError(
                f"kv_cache_dtype must be None or the string 'int8', got "
                f"{self.kv_cache_dtype!r}")

    @staticmethod
    def tiny() -> "ModelConfig":
        return ModelConfig(vocab=256, d_model=64, n_layers=2, n_heads=2,
                           d_ff=128, seq=32)

    @staticmethod
    def llama_like(seq: int = 2048) -> "ModelConfig":
        """Scaled-down Llama-3 proportions with 4:1 grouped-query attention."""
        return ModelConfig(vocab=32000, d_model=1024, n_layers=8, n_heads=8,
                           d_ff=2816, seq=seq, dtype=torch.bfloat16,
                           n_kv_heads=2)

    @staticmethod
    def llama_like_big(seq: int = 4096) -> "ModelConfig":
        """The representative single-card config: ~0.67B parameters, 12
        layers, d_model 2048, 16 heads over 4 KV heads (head_dim 128),
        SwiGLU d_ff 5632, bf16, flash attention."""
        return ModelConfig(vocab=32000, d_model=2048, n_layers=12,
                           n_heads=16, d_ff=5632, seq=seq,
                           dtype=torch.bfloat16, n_kv_heads=4,
                           attn="flash", remat=True)

    @staticmethod
    def llama_like_xl(seq: int = 4096) -> "ModelConfig":
        """~1.55B parameters: 20 layers, d_model 2560, 20 heads over 5 KV
        heads (head_dim 128), d_ff 6912, bf16, flash attention."""
        return ModelConfig(vocab=32000, d_model=2560, n_layers=20,
                           n_heads=20, d_ff=6912, seq=seq,
                           dtype=torch.bfloat16, n_kv_heads=5,
                           attn="flash", remat=True)

    @staticmethod
    def mixtral_like(seq: int = 2048, n_experts: int = 8) -> "ModelConfig":
        """Scaled-down Mixtral proportions: 8 SwiGLU experts, top-2, GQA."""
        return ModelConfig(vocab=32000, d_model=1024, n_layers=8, n_heads=8,
                           d_ff=2816, seq=seq, dtype=torch.bfloat16,
                           n_kv_heads=2, n_experts=n_experts, moe_top_k=2)


def param_shapes(cfg: ModelConfig) -> Params:
    """The shape of every parameter, in the parameter dict's structure."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    d_kv = cfg.head_dim * cfg.kv_heads
    layer = {"wq": (d, d), "wk": (d, d_kv), "wv": (d, d_kv), "wo": (d, d),
             "ln_attn": (d,), "ln_mlp": (d,)}
    if cfg.n_experts:
        e = cfg.n_experts
        layer.update(router=(d, e), w_gate=(e, d, f), w_up=(e, d, f),
                     w_down=(e, f, d))
    else:
        layer.update(w_gate=(d, f), w_up=(d, f), w_down=(f, d))
    return {"embed": (v, d), "out": (d, v), "ln_f": (d,),
            "layers": [dict(layer) for _ in range(cfg.n_layers)]}


def param_dtype(cfg: ModelConfig, name: str) -> torch.dtype:
    """The dtype a parameter is stored in: the MoE router is always float32
    (its softmax logits are f32), every other leaf ``cfg.master_dtype``."""
    return torch.float32 if name == "router" else cfg.master_dtype


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random weights, ``normal / sqrt(fan_in)``, ones for the norms, in
    :func:`param_dtype`. The fan-in of a matrix is its second-to-last axis,
    so each expert of a stack (E, in, out) is scaled by its own. The normals
    are drawn on the generator's device (so a CUDA generator fills a large
    model on the card) and scaled in float32 before the cast. Same shapes
    and scaling as the reference; the numbers differ, as torch's generator
    is not JAX's."""
    device = resolve_device(device)

    def init(name, shape):
        dt = param_dtype(cfg, name)
        if name.startswith("ln_"):
            return torch.ones(shape, dtype=dt, device=device)
        x = torch.randn(shape, generator=generator, device=generator.device)
        return (x / math.sqrt(shape[-2])).to(device=device, dtype=dt)

    shapes = param_shapes(cfg)
    params: Params = {name: init(name, shapes[name])
                      for name in ("embed", "out", "ln_f")}
    params["layers"] = [{name: init(name, shape)
                         for name, shape in ls.items()}
                        for ls in shapes["layers"]]
    return params


class DecoderLM(nn.Module):
    """Owns a parameter dict's tensors as frozen ``nn.Parameter``s, so the
    model moves with ``.to()`` and saves with ``state_dict()``.
    :attr:`params` gives the dict back for the functions of this package."""

    def __init__(self, cfg: ModelConfig, params: Params):
        super().__init__()
        self.cfg = cfg

        def frozen(t):
            return nn.Parameter(t, requires_grad=False)

        self.embed = frozen(params["embed"])
        self.out = frozen(params["out"])
        self.ln_f = frozen(params["ln_f"])
        self.layers = nn.ModuleList(
            nn.ParameterDict({k: frozen(t) for k, t in layer.items()})
            for layer in params["layers"])

    @property
    def params(self) -> Params:
        return {"embed": self.embed, "out": self.out, "ln_f": self.ln_f,
                "layers": [dict(layer.items()) for layer in self.layers]}

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self.params, tokens, self.cfg)


def _rmsnorm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + 1e-6).to(x.dtype)) * w


def _as_pos_vec(pos, device) -> torch.Tensor:
    """A scalar position (training, uniform decode) or a (b,) vector
    (continuous batching) as a rank-1 tensor that broadcasts over batch. A
    tensor is taken as it is, on its own device (a decode program's cursor
    stays there: nothing is uploaded or read back); an int is filled in on
    ``device``, which a CUDA graph can record where an upload it cannot."""
    if isinstance(pos, torch.Tensor):
        off = pos
    elif isinstance(pos, numbers.Integral):
        off = torch.full((), int(pos), dtype=torch.long, device=device)
    else:
        off = torch.as_tensor(pos, device=device)
    return off[None] if off.ndim == 0 else off


def _rotary(x: torch.Tensor, pos_offset=0) -> torch.Tensor:
    """Half-split rotary embedding over the head dim; ``pos_offset`` is a
    scalar (an int, or a 0-d tensor) or a (b,) tensor of absolute start
    positions."""
    b, s, h, hd = x.shape
    half = hd // 2
    off = _as_pos_vec(pos_offset, x.device)
    pos = off[:, None] + torch.arange(s, device=x.device)[None, :]
    inv_freq = 1.0 / (10000 ** (
        torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = pos.float()[:, :, None, None] * inv_freq   # (b or 1, s, 1, half)
    x1, x2 = x[..., :half], x[..., half:]
    cos, sin = torch.cos(ang).to(x.dtype), torch.sin(ang).to(x.dtype)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _qkv(h: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ModelConfig,
         pos_offset=0, tp: Optional[Axis] = None):
    """Projections and rotary (GQA). The head counts are the weights': all
    of ``cfg``'s, or this rank's share of them under tp (the projections
    are column-parallel)."""
    b, s, _ = h.shape
    hd = cfg.head_dim
    h = copy_to(h, tp)
    q = _rotary((h @ p["wq"]).reshape(b, s, -1, hd), pos_offset)
    k = _rotary((h @ p["wk"]).reshape(b, s, -1, hd), pos_offset)
    v = (h @ p["wv"]).reshape(b, s, -1, hd)
    return q, k, v


def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    """Tokens each expert accepts in the capacity path, padded to a multiple
    of 4 (Python's precedence: ``(int(...) + 3) & ~3``), at least 4; the one
    definition ``_moe_mlp`` and ``measure.train_step_flops`` share."""
    return max(4, int(cfg.moe_capacity_factor * cfg.moe_top_k * tokens
                      / cfg.n_experts) + 3 & ~3)


def _router_gates(x: torch.Tensor, p: Dict[str, torch.Tensor],
                  cfg: ModelConfig):
    """The routing decision, shared by the capacity and dropless paths: f32
    router logits, softmax, top-k, gates renormalized over the k. Returns
    (probs (n, E) f32, gate (n, k), idx (n, k)). Ties go to the lower
    expert, as ``jax.lax.top_k`` breaks them (``torch.topk`` does not): the
    first k of a stable descending sort."""
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    idx = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[:, :cfg.moe_top_k]
    gate = probs.gather(-1, idx)
    return probs, gate / gate.sum(dim=-1, keepdim=True), idx


@dataclasses.dataclass(frozen=True)
class ExpertAxes:
    """The mesh axes an MoE layer runs over besides tp: ``ep`` shards the
    expert stacks (E/ep experts a rank), and the capacity path gathers its
    input's rows over ``batch`` and its sequence over ``sp``, so that it
    ranks the global batch's tokens for capacity as one program does. Every
    rank of ep holds the same tokens (ep is not a batch axis)."""
    ep: Optional[Axis] = None
    batch: Optional[Axis] = None
    sp: Optional[Axis] = None


NO_EXPERT_AXES = ExpertAxes()


def _my_experts(p: Dict[str, torch.Tensor], ep: Optional[Axis]) -> slice:
    """This rank's columns of the (·, E) routing tensors: the experts its
    stacks hold, the ep index's run of them."""
    n = p["w_gate"].shape[0]
    lo = ep.index * n if ep is not None else 0
    return slice(lo, lo + n)


def _moe_mlp(h: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ModelConfig,
             tp: Optional[Axis] = None, moe: ExpertAxes = NO_EXPERT_AXES
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE with capacity dispatch (training): positions in each expert
    from an f32 cumsum over the k-major slots, so every top-1 slot claims
    capacity before any top-2 slot; a slot past capacity is dropped (its
    token keeps the residual only). One-hot dispatch and combine einsums in
    f32, the experts as batched (E, C, d) x (E, d, f) products in
    ``cfg.dtype``. Returns (out, aux), aux the switch load-balance loss
    E·Σ f_e·P_e with f_e from the top-1 choices.

    The routing is replicated: the input is gathered over ``moe.sp`` along
    the sequence and over ``moe.batch`` along the rows (each gather's
    backward the reduce-scatter sum), so every rank ranks the global B·S
    tokens in (b, s) order with the global capacity, f_e and P_e, and keeps
    its own rows and chunk of the output at the end. Under tp the expert
    stacks are sharded on d_ff and under ep on E, so each rank's expert
    outputs are partial sums: the input and the gates enter the rank-local
    products through ``copy_to`` over ep and tp (their gradients, the
    router's included, are summed over both), each rank dispatches to its
    own E/ep experts only, and the combined f32 output is summed over tp
    and ep before its cast."""
    whole = gather(gather(h, moe.sp, 1), moe.batch, 0)
    b, s, d = whole.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    n = b * s
    x = whole.reshape(n, d)
    cap = moe_capacity(cfg, n)
    probs, gate, idx = _router_gates(x, p, cfg)

    flat = F.one_hot(idx.t().reshape(k * n), e).float()    # (k·n, E)
    slot_pos = ((torch.cumsum(flat, dim=0) - 1.0) * flat).sum(dim=-1)
    keep = slot_pos < cap
    gate_flat = gate.t().reshape(k * n) * keep
    # a dropped slot's capacity one-hot is a zero row (F.one_hot would raise)
    cap_onehot = (slot_pos[:, None] == torch.arange(
        cap, device=h.device)).float()
    mine = flat[:, _my_experts(p, moe.ep)] * keep[:, None]
    dispatch = mine[:, :, None] * cap_onehot[:, None, :]   # (k·n, E/ep, C)
    x_rep = copy_to(x, moe.ep).repeat(k, 1)                # k-major copies
    expert_in = copy_to(torch.einsum("tec,td->ecd", dispatch,
                                     x_rep.float()).to(cfg.dtype), tp)
    g = torch.einsum("ecd,edf->ecf", expert_in, p["w_gate"])
    u = torch.einsum("ecd,edf->ecf", expert_in, p["w_up"])
    out_e = torch.einsum("ecf,efd->ecd", F.silu(g) * u, p["w_down"])
    combine = dispatch * copy_to(copy_to(gate_flat, moe.ep), tp)[:, None,
                                                                None]
    out = torch.einsum("ecd,tec->td", out_e.float(), combine)
    out = reduce_from(reduce_from(out.reshape(k, n, d).sum(dim=0), tp),
                      moe.ep)
    out = out.reshape(b, s, d).to(h.dtype)
    out = local_chunk(local_chunk(out, moe.batch, 0), moe.sp, 1)

    f_e = F.one_hot(idx[:, 0], e).float().mean(dim=0)
    aux = e * (f_e * probs.mean(dim=0)).sum()
    return out, aux


def _moe_mlp_dropless(h: torch.Tensor, p: Dict[str, torch.Tensor],
                      cfg: ModelConfig, tp: Optional[Axis] = None,
                      ep: Optional[Axis] = None
                      ) -> Tuple[torch.Tensor, float]:
    """Inference MoE: every expert runs on every token and the top-k gates,
    scattered into an (n, E) f32 weight, combine them, so a token's output
    depends on that token alone (what a KV-cache decode of one token must
    reproduce from the prefill). Returns (out, 0.0). Under tp as
    :func:`_moe_mlp`. Under ep each rank runs its E/ep experts on every
    token, and the experts' outputs are gathered over ep so that every rank
    combines all E in one sum, in one card's order: partial sums over ep,
    added after, round differently: on an H100 in bf16 they moved 12 of
    16 greedy ``mixtral_like`` streams off one card's, where the gathered
    combine moved none."""
    b, s, d = h.shape
    x = h.reshape(b * s, d)
    _, gate, idx = _router_gates(x, p, cfg)
    w = torch.zeros(b * s, cfg.n_experts, dtype=torch.float32,
                    device=h.device).scatter(1, idx, gate)
    xc = copy_to(copy_to(x.to(cfg.dtype), ep), tp)
    g = torch.einsum("nd,edf->enf", xc, p["w_gate"])
    u = torch.einsum("nd,edf->enf", xc, p["w_up"])
    oe = torch.einsum("enf,efd->end", F.silu(g) * u, p["w_down"])
    # (E/ep, n, d) -> (E, n, d), contiguous as one card's
    oe = gather_last(oe.permute(1, 2, 0), ep).permute(2, 0, 1).contiguous()
    out = reduce_from(torch.einsum("end,ne->nd", oe.float(), copy_to(w, tp)),
                      tp)
    return out.reshape(b, s, d).to(h.dtype), 0.0


def _mlp(h: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ModelConfig,
         dropless: bool = False, tp: Optional[Axis] = None,
         moe: ExpertAxes = NO_EXPERT_AXES):
    """SwiGLU MLP, dense or MoE by config. Returns (out, aux); aux is 0.0
    but for the MoE capacity path. Under tp w_gate/w_up are column- and
    w_down row-parallel."""
    if cfg.n_experts:
        if dropless:
            return _moe_mlp_dropless(h, p, cfg, tp, moe.ep)
        return _moe_mlp(h, p, cfg, tp, moe)
    h = copy_to(h, tp)
    out = (F.silu(h @ p["w_gate"]) * (h @ p["w_up"])) @ p["w_down"]
    return reduce_from(out, tp), 0.0


def _finish_block(x: torch.Tensor, p: Dict[str, torch.Tensor],
                  o: torch.Tensor, cfg: ModelConfig, dropless: bool = False,
                  tp: Optional[Axis] = None,
                  moe: ExpertAxes = NO_EXPERT_AXES):
    """Residual and MLP tail, shared by the forward and the decode path;
    ``dropless`` selects the inference MoE routing. ``o`` holds this rank's
    heads under tp (wo is row-parallel). Returns (x, aux)."""
    b, s, _ = x.shape
    x = x + reduce_from(o.reshape(b, s, -1) @ p["wo"], tp)
    out, aux = _mlp(_rmsnorm(x, p["ln_mlp"]), p, cfg, dropless, tp, moe)
    return x + out, aux


def _block(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ModelConfig,
           attn_fn: Optional[Callable] = None, dropless: bool = False,
           tp: Optional[Axis] = None, pos_offset: int = 0,
           fsdp: Optional[Axis] = None, moe: ExpertAxes = NO_EXPERT_AXES):
    p = _gather_fsdp(p, cfg, fsdp)
    h = _rmsnorm(x, p["ln_attn"])
    q, k, v = _qkv(h, p, cfg, pos_offset, tp)
    if attn_fn is None:
        attn_fn = attention.naive_attention
    return _finish_block(x, p, attn_fn(q, k, v), cfg, dropless, tp, moe)


def _resolve_attn_fn(cfg: ModelConfig, attn_fn: Optional[Callable] = None):
    if attn_fn is not None:
        return attn_fn
    if cfg.attn == "flash":
        return attention.flash_attention_gqa
    return attention.naive_attention


@functools.lru_cache(maxsize=None)
def _fsdp_dims(cfg: ModelConfig) -> Dict[str, Optional[int]]:
    """By leaf name (the top-level ones and a layer's), the dim that
    :func:`param_specs` puts over fsdp, or None for a leaf whole over it."""
    specs = param_specs(cfg, Mesh({"fsdp": 1}))
    named = {**{k: specs[k] for k in ("embed", "out", "ln_f")},
             **specs["layers"][0]}
    return {k: spec.index("fsdp") if "fsdp" in spec else None
            for k, spec in named.items()}


def _gather_fsdp(p: Dict[str, torch.Tensor], cfg: ModelConfig,
                 fsdp: Optional[Axis],
                 reduce: bool = True) -> Dict[str, torch.Tensor]:
    """The leaves of ``p`` (a layer, or the top-level leaves) whole: each
    leaf sharded over fsdp gathered along its dim, its gradient
    reduce-scattered back (:func:`mesh.gather`; with ``reduce=False``
    this rank's chunk of its own gradient, where the fsdp ranks compute on
    the same rows). Called where the weights are used, inside a
    checkpointed block too, so remat gathers again, as ZeRO-3 does."""
    if fsdp is None or fsdp.size == 1:
        return p
    dims = _fsdp_dims(cfg)
    return {k: w if dims[k] is None else gather(w, fsdp, dims[k], reduce)
            for k, w in p.items()}


def embed(params: Params, tokens: torch.Tensor, tp: Optional[Axis] = None,
          cfg: Optional[ModelConfig] = None,
          fsdp: Optional[Axis] = None) -> torch.Tensor:
    """The token embeddings (b, s, d); under tp each rank holds d/tp of the
    columns and the rows are joined across tp. Under fsdp (with ``cfg``)
    the table's vocab rows are gathered first."""
    table = _gather_fsdp({"embed": params["embed"]}, cfg, fsdp)["embed"]
    return gather_last(table[tokens], tp)


def unembed(params: Params, x: torch.Tensor, cfg: ModelConfig,
            tp: Optional[Axis] = None,
            fsdp: Optional[Axis] = None) -> torch.Tensor:
    """Logits of the final hidden states ``x`` (already normed). Under tp
    ``out`` is row-parallel and the logits are summed over tp, or, with
    ``cfg.vocab_parallel_loss``, column-parallel and each rank keeps its
    vocab/tp of them (for :func:`_nll` with ``vocab_axis``).
    Under fsdp ``out`` is gathered first."""
    out = _gather_fsdp({"out": params["out"]}, cfg, fsdp)["out"]
    if cfg.vocab_parallel_loss:
        return copy_to(x, tp) @ out
    return reduce_from(scatter_last(x, tp) @ out, tp)


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            attn_fn: Optional[Callable] = None, with_aux: bool = False,
            dropless: bool = False, tp: Optional[Axis] = None,
            fsdp: Optional[Axis] = None, pos_offset: int = 0,
            moe: ExpertAxes = NO_EXPERT_AXES):
    """Logits (b, s, vocab) for tokens (b, s), and with ``with_aux`` also
    the MoE aux loss summed over layers (an f32 scalar, 0 for a dense
    model). ``dropless`` routes MoE layers as inference does. With
    ``cfg.remat`` and gradients on, each block is checkpointed: its
    activations are dropped after the forward and recomputed in the
    backward, as under the reference's ``jax.checkpoint`` (so flash
    attention's forward kernel runs twice per layer and step). ``tp`` and
    ``fsdp``: the tensor-parallel and fully-sharded axes of sharded
    ``params`` (``shard_params``). ``pos_offset``: the position of
    ``tokens``' first column, a sequence chunk's under sp. ``moe``: the
    MoE layers' axes (:class:`ExpertAxes`)."""
    attn_fn = _resolve_attn_fn(cfg, attn_fn)
    remat = cfg.remat and torch.is_grad_enabled()
    x = embed(params, tokens, tp, cfg, fsdp)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in params["layers"]:
        if remat:
            # no block draws a random number, so no RNG state is saved and
            # restored around it: a CUDA graph capture refuses that read
            x, aux = checkpoint(_block, x, layer, cfg, attn_fn, dropless, tp,
                                pos_offset, fsdp, moe, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            x, aux = _block(x, layer, cfg, attn_fn, dropless, tp, pos_offset,
                            fsdp, moe)
        aux_total = aux_total + aux
    logits = unembed(params, _rmsnorm(x, params["ln_f"]), cfg, tp, fsdp)
    return (logits, aux_total) if with_aux else logits


def cast_params_for_compute(params: Params, cfg: ModelConfig) -> Params:
    """Cast master-dtype weights to the compute dtype (f32 masters, bf16
    compute); the identity when the two agree. Leaves named ``router``
    stay f32."""
    if cfg.master_dtype == cfg.dtype:
        return params

    def cast(tree):
        if isinstance(tree, dict):
            return {k: v if k == "router" else cast(v)
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [cast(v) for v in tree]
        return tree.to(cfg.dtype)

    return cast(params)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of a parameter tree (dicts and lists of
    tensors), with the matching leaves of ``rest`` as further arguments."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def _cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                   vocab_axis: Optional[Axis] = None) -> torch.Tensor:
    """Token-mean NLL (:func:`_nll`'s mean)."""
    return _nll(logits, targets, vocab_axis).mean()


def _nll(logits: torch.Tensor, targets: torch.Tensor,
         vocab_axis: Optional[Axis] = None) -> torch.Tensor:
    """Each position's NLL, f32: log-softmax, the target's entry. With
    ``vocab_axis`` the logits are this rank's vocab/tp columns and the loss
    takes the logsumexp form over the sharded vocabulary, as the
    reference's: the max and the sum of exponentials are reduced over the
    axis, and the target's logit comes from the rank that holds it (the
    full logits are never gathered)."""
    logits = logits.float()
    if vocab_axis is None or vocab_axis.size == 1:
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(-1, targets[..., None])[..., 0]
    m = all_reduce(logits.detach().amax(dim=-1, keepdim=True), vocab_axis,
                   "max")
    lse = torch.log(reduce_from(torch.exp(logits - m).sum(dim=-1),
                                vocab_axis)) + m[..., 0]
    v = logits.shape[-1]
    local = targets - vocab_axis.index * v
    mine = (local >= 0) & (local < v)
    picked = logits.gather(-1, local.clamp(0, v - 1)[..., None])[..., 0]
    target_logit = reduce_from(torch.where(mine, picked, 0.0), vocab_axis)
    return lse - target_logit


def loss_fn(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            attn_fn: Optional[Callable] = None, tp: Optional[Axis] = None,
            sp: Optional[Axis] = None, fsdp: Optional[Axis] = None,
            moe: ExpertAxes = NO_EXPERT_AXES) -> torch.Tensor:
    """Next-token loss, the mean over every row's S − 1 predicted positions,
    plus ``cfg.moe_aux_weight`` times the MoE aux loss (0 for a dense
    model), through the compute-dtype cast (so master-dtype gradients come
    back). With ``cfg.vocab_parallel_loss`` under tp, the vocab-parallel
    form. Under ``sp`` the rank runs its chunk of the sequence (rotary from
    the chunk's offset): a position's target is the next token of the whole
    sequence, so the last position of chunk i takes chunk i + 1's first
    token and only the last chunk drops one, and the rank returns its share
    of the mean over all B × (S − 1) positions; the sum over sp is the
    loss, never a mean of the ranks' means. The MoE aux is the global
    batch's on every rank (``moe`` gathers the tokens), so each sp rank
    adds aux / sp: the sum over sp counts it once, in the loss and in the
    router's gradient alike."""
    params = cast_params_for_compute(params, cfg)
    b, s = tokens.shape
    n, i = (sp.size, sp.index) if sp is not None else (1, 0)
    if s % n:
        raise ValueError(f"seq {s} does not split over sp of {n}")
    lo, hi = i * (s // n), (i + 1) * (s // n)
    targets = tokens[:, lo + 1:hi + 1]
    logits, aux = forward(params, tokens[:, lo:hi], cfg, attn_fn,
                          with_aux=True, tp=tp, fsdp=fsdp, pos_offset=lo,
                          moe=moe)
    vocab_axis = tp if cfg.vocab_parallel_loss else None
    nll = _nll(logits[:, :targets.shape[1]], targets, vocab_axis)
    return nll.sum() / (b * (s - 1)) + cfg.moe_aux_weight * aux / n


def value_and_grad(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                   attn_fn: Optional[Callable] = None,
                   tp: Optional[Axis] = None, sp: Optional[Axis] = None,
                   fsdp: Optional[Axis] = None,
                   moe: ExpertAxes = NO_EXPERT_AXES):
    """(loss, grads) of :func:`loss_fn`, grads in the parameter tree's
    structure and dtypes; ``params`` themselves are left untouched. Under
    tp the grads are this rank's shards' and every replicated leaf's full
    gradient; under fsdp a sharded leaf's gradient is summed over fsdp
    (the reduce-scatter); under sp every grad is this rank's share. The
    forward and the backward (with remat, its recomputed forward too) are
    the device-timed phases ``train.forward`` and ``train.backward``."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    it = iter(leaves)
    phase = tracing.device_begin("train.forward", leaves[0])
    loss = loss_fn(tree_map(lambda _: next(it), params), tokens, cfg, attn_fn,
                   tp, sp, fsdp, moe)
    tracing.device_end(phase)
    phase = tracing.device_begin("train.backward", leaves[0])
    grads = iter(torch.autograd.grad(loss, leaves))
    tracing.device_end(phase)
    return loss.detach(), tree_map(lambda _: next(grads), params)


def sgd_train_step(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                   lr: float = 1e-3, attn_fn: Optional[Callable] = None):
    """One plain SGD step: (new params, loss)."""
    loss, grads = value_and_grad(params, tokens, cfg, attn_fn)
    new = tree_map(lambda p, g: p - lr * g.to(p.dtype), params, grads)
    return new, loss


# -- shardings -------------------------------------------------------------------
#
# Axis conventions, as the reference's (any subset may be on the mesh):
# slice, dp and fsdp shard the batch, fsdp also every matrix's non-tp dim
# (ZeRO-3), sp the sequence, ep the MoE experts, tp the model. A pp axis
# trains through pipeline.make_pipeline_train_step, which stacks the
# layers; the flat steps and shard_params refuse it, and the serving engine
# runs its ranks as replicas.

PORTED_AXES = ("slice", "dp", "fsdp", "sp", "ep", "tp")


def check_mesh_axes(mesh: Optional[Mesh], cfg: Optional[ModelConfig] = None,
                    serving: bool = False) -> None:
    """Raise for a pp axis (NotImplementedError, naming the pipeline and
    ROADMAP) unless ``serving`` (the engine serves over pp as replicas), an
    axis the port does not know, or an ep that does not divide ``cfg``'s
    experts (ValueError)."""
    for a in () if mesh is None else mesh.axis_names:
        if a == "pp" and serving:
            continue
        if a == "pp":
            raise NotImplementedError(
                "the 'pp' mesh axis trains through "
                "pipeline.make_pipeline_train_step (stacked layers); the "
                "flat train steps and shard_params do not run it: ROADMAP "
                "'Parallelism'")
        if a not in PORTED_AXES:
            raise ValueError(f"unknown mesh axis {a!r}")
    ep = mesh.shape.get("ep", 1) if mesh is not None else 1
    if cfg is not None and cfg.n_experts % ep:
        raise ValueError(f"n_experts {cfg.n_experts} not divisible by ep "
                         f"{ep}")


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(a for a in BATCH_AXES if a in mesh.axis_names)


def param_specs(cfg: ModelConfig, mesh: Mesh) -> Params:
    """Per leaf, the tuple of mesh axis names (or None) along each dim, as
    the reference's ``PartitionSpec``: column-parallel in (wq/wk/wv/w_gate/
    w_up and ``embed``: the output dim over tp), row-parallel out (wo/w_down:
    the input dim over tp), ``out`` row-parallel or, with
    ``cfg.vocab_parallel_loss``, column-parallel; the other dim of every
    matrix over fsdp, MoE expert stacks' E over ep; norms and the router
    replicated. An axis missing from the mesh is None."""
    names = mesh.axis_names
    tp = "tp" if "tp" in names else None
    fsdp = "fsdp" if "fsdp" in names else None
    ep = "ep" if "ep" in names else None
    col, row, vec = (fsdp, tp), (tp, fsdp), (None,)
    layer = {"wq": col, "wk": col, "wv": col, "wo": row,
             "ln_attn": vec, "ln_mlp": vec}
    if cfg.n_experts:
        layer.update(router=(None, None), w_gate=(ep, fsdp, tp),
                     w_up=(ep, fsdp, tp), w_down=(ep, tp, fsdp))
    else:
        layer.update(w_gate=col, w_up=col, w_down=row)
    return {"embed": col, "out": col if cfg.vocab_parallel_loss else row,
            "ln_f": vec, "layers": [dict(layer) for _ in range(cfg.n_layers)]}


def moe_act_spec(cfg: ModelConfig, mesh: Mesh) -> Optional[Axis]:
    """The axis the (E, C, d) expert buffers split their E over: the ep
    axis, or None for a dense model or a mesh without ep (the reference's
    ``P("ep", None, None)`` sharding)."""
    return mesh.ep if cfg.n_experts else None


def token_spec(mesh: Mesh) -> Tuple:
    """The tokens' (B, S) spec: B over the batch axes."""
    return (batch_axes(mesh) or None, None)


def shard_leaf(x: torch.Tensor, spec: Tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of ``x`` by its ``spec`` (a mesh axis name or None
    a dim), as a new contiguous tensor on ``mesh.device``."""
    for dim, name in enumerate(spec):
        if name is not None:
            x = local_chunk(x, mesh.axis(name), dim)
    dev = mesh.device or x.device
    return torch.empty(x.shape, dtype=x.dtype, device=dev).copy_(x)


def shard_shape(shape, spec: Tuple, mesh: Mesh) -> Tuple[int, ...]:
    """The shape of :func:`shard_leaf`'s slice of a leaf of ``shape``."""
    return tuple(n if name is None else n // mesh.shape[name]
                 for n, name in zip(shape, spec))


def gather_leaf(x: torch.Tensor, spec: Tuple, mesh: Mesh) -> torch.Tensor:
    """The whole leaf back from every rank's :func:`shard_leaf`."""
    for dim, name in enumerate(spec):
        if name is not None:
            x = mesh_all_gather(x, mesh.axis(name), dim)
    return x


def shard_params(params: Params, cfg: ModelConfig, mesh: Mesh) -> Params:
    """This rank's slice of every leaf by :func:`param_specs`, as new
    contiguous tensors on ``mesh.device`` (the full tree may live anywhere
    and can be dropped after). A leaf's dim over an axis of size 1, or over
    none, is whole."""
    check_mesh_axes(mesh, cfg)
    return tree_map(lambda x, spec: shard_leaf(x, spec, mesh), params,
                    param_specs(cfg, mesh))


def gather_params(shards: Params, cfg: ModelConfig, mesh: Mesh) -> Params:
    """The full tree back from every rank's :func:`shard_params` (each rank
    gets it): for tests and checkpoints."""
    return tree_map(lambda x, spec: gather_leaf(x, spec, mesh), shards,
                    param_specs(cfg, mesh))


def _sequence_gathered(attn_fn: Callable, sp: Optional[Axis]) -> Callable:
    """``attn_fn`` over the whole sequence on every sp rank: q, k and v
    gathered along the sequence, attention, this rank's rows kept; the
    gradients of q, k and v reduce-scattered back. What GSPMD makes of an
    attention it cannot split (the reference's naive and flash under its sp
    sharding constraint)."""
    def fn(q, k, v):
        return local_chunk(attn_fn(*(gather(t, sp, 1) for t in (q, k, v))),
                           sp, 1)
    return fn


class TrainShardings:
    """What a train step on ``mesh`` needs, derived once from (mesh, cfg),
    as the reference's ``TrainShardings``: the axes (tp; sp; fsdp; ep; the
    batch axes, which split the global batch's rows; ``moe``, the MoE
    layers' :class:`ExpertAxes`, which route the global batch) and the
    attention,
    resolved for sp: ``ring`` is :func:`attention.make_ring_attention` and
    ``ringflash`` :func:`attention.make_ring_flash_attention` on the sp
    axis, ``naive`` and ``flash`` run over the gathered sequence
    (:func:`_sequence_gathered`); without sp every name resolves as on one
    card (ring and ringflash to naive)."""

    def __init__(self, mesh: Optional[Mesh], cfg: ModelConfig):
        check_mesh_axes(mesh, cfg)
        self.cfg = cfg
        self.mesh = mesh
        axis = mesh.axis if mesh is not None else (lambda _: None)
        self.tp, self.sp, self.fsdp = axis("tp"), axis("sp"), axis("fsdp")
        self.batch = axis(BATCH_AXES)
        self.ep = moe_act_spec(cfg, mesh) if mesh is not None else None
        self.moe = ExpertAxes(self.ep, self.batch, self.sp)
        if self.sp is None:
            self.attn_fn = _resolve_attn_fn(cfg)
        elif cfg.attn == "ring":
            self.attn_fn = attention.make_ring_attention(self.sp)
        elif cfg.attn == "ringflash":
            self.attn_fn = attention.make_ring_flash_attention(self.sp)
        else:
            self.attn_fn = _sequence_gathered(_resolve_attn_fn(cfg), self.sp)

    def local(self, tokens: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's rows of the global batch (the whole sequence: the
        loss takes the sp chunk)."""
        return local_chunk(tokens, self.batch, dim)

    def __call__(self, params: Params, tokens: torch.Tensor):
        """(loss, grads) of this rank's rows, as :func:`value_and_grad`."""
        return value_and_grad(params, tokens, self.cfg, self.attn_fn,
                              self.tp, self.sp, self.fsdp, self.moe)

    def mean(self, loss: torch.Tensor, grads: Params):
        """The global loss and f32 gradients (a tree) from this rank's:
        summed over sp, averaged over the batch axes. The loss and every
        leaf whole over fsdp go in one f32 all-reduce over the batch axes
        and sp; the fsdp-sharded leaves, which their reduce-scatter has
        summed over fsdp already, in one over the other axes, since summing
        them over fsdp again would count them fsdp times."""
        if self.mesh is None:
            return loss, grads
        n = self.batch.size if self.batch is not None else 1
        sharded = self.fsdp is not None and self.fsdp.size > 1
        over_fsdp = [False] + tree_leaves(tree_map(
            lambda _, spec: sharded and "fsdp" in spec, grads,
            param_specs(self.cfg, self.mesh)))
        leaves = [loss.reshape(1)] + tree_leaves(grads)
        out = list(leaves)
        for fsdp_leaf, axis in ((False, self.mesh.data),
                                (True, self.mesh.axis(DATA_AXES_BUT_FSDP))):
            idx = [i for i, o in enumerate(over_fsdp) if o == fsdp_leaf]
            if not idx or (n == 1 and (axis is None or axis.size == 1)):
                continue
            flat = all_reduce(torch.cat([leaves[i].float().reshape(-1)
                                         for i in idx]), axis) / n
            for i, t in zip(idx, torch.split(flat, [leaves[i].numel()
                                                    for i in idx])):
                out[i] = t.reshape(leaves[i].shape)
        it = iter(out[1:])
        return out[0][0], tree_map(lambda _: next(it), grads)


def _specs_or_none(mesh: Optional[Mesh], cfg: ModelConfig):
    return ((None, None) if mesh is None
            else (param_specs(cfg, mesh), token_spec(mesh)))


class _BoundPrograms:
    """The programs of a train step, built by ``build`` for the tensors of
    the call that first needs them and kept while later calls pass the same
    tensors (params and optimizer state updated in place, as the reference
    donates them) and a key (the tokens' shape and dtype) that has not
    changed. A call with other tensors, or another key, builds anew: the
    old programs, and on the card their graph and its pool, are dropped
    first, and the old tensors are never written again.

    The step keeps no tree alive. Its tensors are known by weak references,
    and the bodies read the tree of the call in progress from ``tree``
    (``params``, ``state``), which :meth:`bound` sets for the call and
    clears after it. So a tree the caller drops is freed at once, before a
    restore loads the next (the graph's pool goes at the next call). The
    bodies hold ``tree``, never this object, so no cycle keeps a dropped
    step's graph for the collector, which could free it in the middle of
    another capture.

    On the card the programs are captured: on one card each as one CUDA
    graph, over a mesh each as a chain of graphs broken at its collectives,
    the backward's and the remat recompute's included (``program``); on
    the CPU their bodies are called as they are. ``graphs = False``, set
    before the first call, calls the bodies on the card too: a private
    hook for comparing the two (``step._programs``)."""

    def __init__(self, build: Callable):
        self.build = build
        self.graphs = True
        self.tree = types.SimpleNamespace(params=None, state=None)
        self.programs = None
        self._refs: Tuple = ()
        self._key = None

    @contextlib.contextmanager
    def bound(self, params: Params, state, key, *args):
        """The programs for ``params`` and ``state`` (None for SGD), built
        by ``build(self.tree, *args, graphed=)`` if they are not those of
        the last call, with the tree set for the bodies while the call
        runs."""
        held = tree_leaves(params)
        if state is not None:
            held = held + tree_leaves(state.mu) + tree_leaves(state.nu)
        self.tree.params, self.tree.state = params, state
        try:
            if (self.programs is None or key != self._key
                    or len(held) != len(self._refs)
                    or any(r() is not t for r, t in zip(self._refs, held))):
                self.programs, self._refs = None, ()
                graphed = self.graphs and held[0].device.type == "cuda"
                self.programs = self.build(self.tree, *args, graphed=graphed)
                self._refs = tuple(weakref.ref(t) for t in held)
                self._key = key
            yield self.programs
        finally:
            self.tree.params = self.tree.state = None


def _tokens_buffer(tokens: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The static tokens a step program reads (the global batch), on the
    params' device."""
    return torch.zeros(tokens.shape, dtype=tokens.dtype, device=like.device)


def _sgd_program(b, ts: TrainShardings, tokens: torch.Tensor, lr: float, *,
                 graphed: bool) -> Program:
    """The SGD step as a program over the tree ``b`` (``b.params`` while a
    call runs, :class:`_BoundPrograms`): ``tokens`` in, the global loss out,
    ``b.params`` updated in place (``p -= lr·g``, the bits of
    ``sgd_train_step``'s new tree)."""
    buf = _tokens_buffer(tokens, tree_leaves(b.params)[0])

    def body():
        loss, grads = ts.mean(*ts(b.params, ts.local(buf)))
        phase = tracing.device_begin("train.optimizer", buf)
        with torch.no_grad():
            for p, g in zip(tree_leaves(b.params), tree_leaves(grads)):
                p.sub_(lr * g.to(p.dtype))
        tracing.device_end(phase)
        return loss

    return Program(body, {"tokens": buf}, graphed=graphed, advances=True)


def _adamw_program(b, ts: TrainShardings, tx,
                   tokens: torch.Tensor, *, graphed: bool):
    """Value and grad, then the optimizer's device part (``tx.apply_``),
    as a program: ``tokens`` in, the global loss out, ``b.params`` and
    ``b.state``'s moments updated in place. Returns (program, the
    bias-correction buffers it reads), which the host part
    (``tx.advance_``) fills before each call."""
    buf = _tokens_buffer(tokens, tree_leaves(b.params)[0])
    corr = tx.corrections(b.state)

    def body():
        loss, grads = ts.mean(*ts(b.params, ts.local(buf)))
        phase = tracing.device_begin("train.optimizer", buf)
        tx.apply_(tree_map(lambda p, g: g.to(p.dtype), b.params, grads),
                  b.state, b.params, corr)
        tracing.device_end(phase)
        return loss

    return (Program(body, {"tokens": buf}, graphed=graphed, advances=True),
            corr)


def _accum_programs(b, ts: TrainShardings, tx,
                    micro: torch.Tensor, slots: int, *, graphed: bool):
    """Gradient accumulation as two programs, the counterpart of the
    reference's ``lax.scan``. The micro-step (``tokens``, one global
    microbatch, and its ``index`` in) adds this rank's f32 gradients into a
    static accumulator and writes its loss at ``index`` of a static
    (``slots``,) buffer; it is called once a microbatch. The update (``n``,
    the stack's length, in) divides the sums by ``n``, averages them over
    the mesh (:meth:`TrainShardings.mean`), applies the optimizer's device
    part, zeroes the accumulator and the losses for the next stack and
    returns the mean loss. Returns (micro-step, update, bias-correction
    buffers)."""
    like = tree_leaves(b.params)[0]
    corr = tx.corrections(b.state)
    buf = _tokens_buffer(micro, like)
    index = torch.zeros((), dtype=torch.long, device=like.device)
    n = torch.ones((), dtype=torch.float32, device=like.device)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in tree_leaves(b.params)]
    losses = torch.zeros(slots, dtype=torch.float32, device=like.device)

    def micro_body():
        loss, grads = ts(b.params, ts.local(buf))
        with torch.no_grad():
            for a, g in zip(acc, tree_leaves(grads)):
                a.add_(g.float())
            losses.index_copy_(0, index.reshape(1), loss.reshape(1))

    def update_body():
        it = iter(acc)
        loss, grads = ts.mean(losses.sum() / n,
                              tree_map(lambda _: next(it) / n, b.params))
        phase = tracing.device_begin("train.optimizer", n)
        tx.apply_(tree_map(lambda p, g: g.to(p.dtype), b.params, grads),
                  b.state, b.params, corr)
        tracing.device_end(phase)
        with torch.no_grad():
            for a in acc:
                a.zero_()
            losses.zero_()
        return loss

    return (Program(micro_body, {"tokens": buf, "index": index},
                    graphed=graphed, advances=True),
            Program(update_body, {"n": n}, graphed=graphed, advances=True),
            corr)


def make_sharded_train_step(mesh: Optional[Mesh], cfg: ModelConfig,
                            lr: float = 1e-3):
    """SGD over ``mesh`` (axes in slice, dp, fsdp, sp, ep, tp):
    ``step(params, tokens) -> (params, loss)`` on this rank's shards
    (:func:`shard_params`) and the GLOBAL batch (B, S), whose rows the step
    splits over the batch axes (:meth:`TrainShardings.local`), and the
    gradients and the loss are averaged over the batch axes and summed over
    sp (:meth:`TrainShardings.mean`: the loss is the global mean). Returns
    (step, param_specs, token_spec) where the reference returns
    ``NamedSharding``s.

    The step is a program (:func:`_sgd_program`) that updates ``params`` IN
    PLACE and returns the same tree, as the reference's step donates them:
    on the card captured at its first call, as a CUDA graph on one card
    and as a chain of graphs broken at each collective over a mesh, and
    replayed after that; its body called as it is on the CPU. A call with
    other tensors builds it anew for them (:class:`_BoundPrograms`)."""
    ts = TrainShardings(mesh, cfg)
    programs = _BoundPrograms(
        lambda b, tokens, graphed: _sgd_program(b, ts, tokens, lr,
                                                graphed=graphed))

    count = itertools.count(1)

    def step(params, tokens):
        tracing.poll()
        sid = tracing.begin("train.step", next(count))
        try:
            with programs.bound(params, None, (tokens.shape, tokens.dtype),
                                tokens) as prog:
                return params, prog(tokens=tokens).clone()
        finally:
            tracing.end(sid)

    step._programs = programs
    return (step, *_specs_or_none(mesh, cfg))


def make_optax_train_step(mesh: Optional[Mesh], cfg: ModelConfig, tx):
    """The train step for an optimizer ``tx`` (``optim.adamw``), as the
    reference's: ``step(params, opt_state, tokens) -> (params, opt_state,
    loss)``, updating params and state in place. Returns (step, init_opt,
    param_specs, token_spec), both specs None without a mesh. On a mesh as
    :func:`make_sharded_train_step`; ``tx.init`` runs on the shards, so the
    optimizer state mirrors each (AdamW is elementwise). The step is a
    program (:func:`_adamw_program`), captured and rebound as
    :func:`make_sharded_train_step`'s, whose host part (``tx.advance_``:
    the count and the bias corrections) runs before every call. Each call
    of every train step is a ``train.step`` span, and the body's forward,
    backward and update the device-timed phases of :mod:`.tracing`."""
    ts = TrainShardings(mesh, cfg)
    programs = _BoundPrograms(
        lambda b, tokens, graphed: _adamw_program(b, ts, tx, tokens,
                                                  graphed=graphed))

    count = itertools.count(1)

    def step(params, opt_state, tokens):
        tracing.poll()
        sid = tracing.begin("train.step", next(count))
        try:
            with programs.bound(params, opt_state,
                                (tokens.shape, tokens.dtype),
                                tokens) as (prog, corr):
                tx.advance_(opt_state, corr)
                return params, opt_state, prog(tokens=tokens).clone()
        finally:
            tracing.end(sid)

    step._programs = programs
    return (step, tx.init, *_specs_or_none(mesh, cfg))


def make_accum_train_step(mesh: Optional[Mesh], cfg: ModelConfig, tx,
                          accum_steps: int):
    """Gradient accumulation: one optimizer update per stack of microbatches
    (accum, B, S), gradients summed in f32 and divided by the stack's own
    length (a shorter final stack still averages correctly), the loss the
    mean of the microbatches' losses. ``accum_steps`` is the reference's
    signature; as there, the stack sets the count. On a mesh each
    microbatch's B splits over the batch axes (the token spec is (None,
    batch, None)) and the sums are averaged over them once a step. Returns
    as :func:`make_optax_train_step`. The step is two programs
    (:func:`_accum_programs`), the micro-step called a microbatch and the
    update once a stack, captured and rebound as
    :func:`make_sharded_train_step`'s; their loss buffer holds
    ``accum_steps`` microbatches, and a longer stack builds them anew.
    Captured, the micro-step replays again before its last replay has run
    on the card, so of its device-timed phases only the last microbatch's
    are read; the others count as unread (:mod:`.tracing`)."""
    ts = TrainShardings(mesh, cfg)
    programs = _BoundPrograms(
        lambda b, micro, slots, graphed: _accum_programs(
            b, ts, tx, micro, slots, graphed=graphed))

    count = itertools.count(1)

    def step(params, opt_state, token_stack):
        tracing.poll()
        sid = tracing.begin("train.step", next(count))
        try:
            n_micro = token_stack.shape[0]
            slots = max(accum_steps, n_micro)
            micro = token_stack[0]
            with programs.bound(params, opt_state,
                                (micro.shape, micro.dtype, slots), micro,
                                slots) as (micro_step, update, corr):
                for i in range(n_micro):
                    micro_step(tokens=token_stack[i], index=i)
                tx.advance_(opt_state, corr)
                return params, opt_state, update(n=n_micro).clone()
        finally:
            tracing.end(sid)

    step._programs = programs

    specs, tokens = _specs_or_none(mesh, cfg)
    return (step, tx.init, specs,
            None if tokens is None else (None, *tokens))
