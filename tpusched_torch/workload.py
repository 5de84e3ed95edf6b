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
``make_accum_train_step`` around an optimizer from ``optim``; sharded steps
wait for the parallelism slice.

Every entry point runs on the CUDA card unless the caller passes
``device="cpu"``; with no card and no explicit device it raises.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import attention

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
    (continuous batching) as a rank-1 tensor that broadcasts over batch."""
    off = torch.as_tensor(pos, device=device)
    return off[None] if off.ndim == 0 else off


def _rotary(x: torch.Tensor, pos_offset=0) -> torch.Tensor:
    """Half-split rotary embedding over the head dim; ``pos_offset`` is a
    scalar or a (b,) vector of absolute start positions."""
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
         pos_offset=0):
    """Projections and rotary; K/V carry ``cfg.kv_heads`` heads (GQA)."""
    b, s, _ = h.shape
    hd = cfg.head_dim
    q = _rotary((h @ p["wq"]).reshape(b, s, cfg.n_heads, hd), pos_offset)
    k = _rotary((h @ p["wk"]).reshape(b, s, cfg.kv_heads, hd), pos_offset)
    v = (h @ p["wv"]).reshape(b, s, cfg.kv_heads, hd)
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


def _moe_mlp(h: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ModelConfig
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k MoE with capacity dispatch (training): positions in each expert
    from an f32 cumsum over the k-major slots, so every top-1 slot claims
    capacity before any top-2 slot; a slot past capacity is dropped (its
    token keeps the residual only). One-hot dispatch and combine einsums in
    f32, the experts as batched (E, C, d) x (E, d, f) products in
    ``cfg.dtype``. Returns (out, aux), aux the switch load-balance loss
    E·Σ f_e·P_e with f_e from the top-1 choices."""
    b, s, d = h.shape
    e, k = cfg.n_experts, cfg.moe_top_k
    n = b * s
    x = h.reshape(n, d)
    cap = moe_capacity(cfg, n)
    probs, gate, idx = _router_gates(x, p, cfg)

    flat = F.one_hot(idx.t().reshape(k * n), e).float()    # (k·n, E)
    slot_pos = ((torch.cumsum(flat, dim=0) - 1.0) * flat).sum(dim=-1)
    keep = slot_pos < cap
    gate_flat = gate.t().reshape(k * n) * keep
    # a dropped slot's capacity one-hot is a zero row (F.one_hot would raise)
    cap_onehot = (slot_pos[:, None] == torch.arange(
        cap, device=h.device)).float()
    dispatch = (flat * keep[:, None])[:, :, None] * cap_onehot[:, None, :]
    x_rep = x.repeat(k, 1)                                 # k-major copies
    expert_in = torch.einsum("tec,td->ecd", dispatch,
                             x_rep.float()).to(cfg.dtype)
    g = torch.einsum("ecd,edf->ecf", expert_in, p["w_gate"])
    u = torch.einsum("ecd,edf->ecf", expert_in, p["w_up"])
    out_e = torch.einsum("ecf,efd->ecd", F.silu(g) * u, p["w_down"])
    combine = dispatch * gate_flat[:, None, None]
    out = torch.einsum("ecd,tec->td", out_e.float(), combine)
    out = out.reshape(k, n, d).sum(dim=0).reshape(b, s, d).to(h.dtype)

    f_e = F.one_hot(idx[:, 0], e).float().mean(dim=0)
    aux = e * (f_e * probs.mean(dim=0)).sum()
    return out, aux


def _moe_mlp_dropless(h: torch.Tensor, p: Dict[str, torch.Tensor],
                      cfg: ModelConfig) -> Tuple[torch.Tensor, float]:
    """Inference MoE: every expert runs on every token and the top-k gates,
    scattered into an (n, E) f32 weight, combine them, so a token's output
    depends on that token alone (what a KV-cache decode of one token must
    reproduce from the prefill). Returns (out, 0.0)."""
    b, s, d = h.shape
    x = h.reshape(b * s, d)
    _, gate, idx = _router_gates(x, p, cfg)
    w = torch.zeros(b * s, cfg.n_experts, dtype=torch.float32,
                    device=h.device).scatter(1, idx, gate)
    xc = x.to(cfg.dtype)
    g = torch.einsum("nd,edf->enf", xc, p["w_gate"])
    u = torch.einsum("nd,edf->enf", xc, p["w_up"])
    oe = torch.einsum("enf,efd->end", F.silu(g) * u, p["w_down"])
    out = torch.einsum("end,ne->nd", oe.float(), w)
    return out.reshape(b, s, d).to(h.dtype), 0.0


def _mlp(h: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ModelConfig,
         dropless: bool = False):
    """SwiGLU MLP, dense or MoE by config. Returns (out, aux); aux is 0.0
    but for the MoE capacity path."""
    if cfg.n_experts:
        if dropless:
            return _moe_mlp_dropless(h, p, cfg)
        return _moe_mlp(h, p, cfg)
    return (F.silu(h @ p["w_gate"]) * (h @ p["w_up"])) @ p["w_down"], 0.0


def _finish_block(x: torch.Tensor, p: Dict[str, torch.Tensor],
                  o: torch.Tensor, cfg: ModelConfig, dropless: bool = False):
    """Residual and MLP tail, shared by the forward and the decode path;
    ``dropless`` selects the inference MoE routing. Returns (x, aux)."""
    b, s, d = x.shape
    x = x + o.reshape(b, s, d) @ p["wo"]
    out, aux = _mlp(_rmsnorm(x, p["ln_mlp"]), p, cfg, dropless)
    return x + out, aux


def _block(x: torch.Tensor, p: Dict[str, torch.Tensor], cfg: ModelConfig,
           attn_fn: Optional[Callable] = None, dropless: bool = False):
    h = _rmsnorm(x, p["ln_attn"])
    q, k, v = _qkv(h, p, cfg)
    if attn_fn is None:
        attn_fn = attention.naive_attention
    return _finish_block(x, p, attn_fn(q, k, v), cfg, dropless)


def _resolve_attn_fn(cfg: ModelConfig, attn_fn: Optional[Callable] = None):
    if attn_fn is not None:
        return attn_fn
    if cfg.attn == "flash":
        return attention.flash_attention_gqa
    return attention.naive_attention


def forward(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            attn_fn: Optional[Callable] = None, with_aux: bool = False,
            dropless: bool = False):
    """Logits (b, s, vocab) for tokens (b, s), and with ``with_aux`` also
    the MoE aux loss summed over layers (an f32 scalar, 0 for a dense
    model). ``dropless`` routes MoE layers as inference does. With
    ``cfg.remat`` and gradients on, each block is checkpointed: its
    activations are dropped after the forward and recomputed in the
    backward, as under the reference's ``jax.checkpoint`` (so flash
    attention's forward kernel runs twice per layer and step)."""
    attn_fn = _resolve_attn_fn(cfg, attn_fn)
    remat = cfg.remat and torch.is_grad_enabled()
    x = params["embed"][tokens]
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in params["layers"]:
        if remat:
            x, aux = checkpoint(_block, x, layer, cfg, attn_fn, dropless,
                                use_reentrant=False)
        else:
            x, aux = _block(x, layer, cfg, attn_fn, dropless)
        aux_total = aux_total + aux
    logits = _rmsnorm(x, params["ln_f"]) @ params["out"]
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
                   vocab_spec: Optional[Any] = None) -> torch.Tensor:
    """Token-mean NLL: f32 log-softmax, the target's entry, the mean."""
    if vocab_spec is not None:
        raise NotImplementedError(
            "the vocab-parallel loss needs a tp mesh: ROADMAP 'Parallelism'")
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets[..., None]).mean()


def loss_fn(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
            attn_fn: Optional[Callable] = None) -> torch.Tensor:
    """Next-token loss over the full sequence's logits plus
    ``cfg.moe_aux_weight`` times the MoE aux loss (0 for a dense model),
    through the compute-dtype cast (so master-dtype gradients come back)."""
    params = cast_params_for_compute(params, cfg)
    logits, aux = forward(params, tokens, cfg, attn_fn, with_aux=True)
    return (_cross_entropy(logits[:, :-1], tokens[:, 1:])
            + cfg.moe_aux_weight * aux)


def value_and_grad(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                   attn_fn: Optional[Callable] = None):
    """(loss, grads) of :func:`loss_fn`, grads in the parameter tree's
    structure and dtypes; ``params`` themselves are left untouched."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    it = iter(leaves)
    loss = loss_fn(tree_map(lambda _: next(it), params), tokens, cfg, attn_fn)
    grads = iter(torch.autograd.grad(loss, leaves))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def sgd_train_step(params: Params, tokens: torch.Tensor, cfg: ModelConfig,
                   lr: float = 1e-3, attn_fn: Optional[Callable] = None):
    """One plain SGD step: (new params, loss)."""
    loss, grads = value_and_grad(params, tokens, cfg, attn_fn)
    new = tree_map(lambda p, g: p - lr * g.to(p.dtype), params, grads)
    return new, loss


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharded train steps are not ported yet: ROADMAP 'Parallelism'")


def make_optax_train_step(mesh, cfg: ModelConfig, tx):
    """The train step for an optimizer ``tx`` (``optim.adamw``), as the
    reference's: ``step(params, opt_state, tokens) -> (params, opt_state,
    loss)``. Returns (step, init_opt, param_shardings, token_sharding);
    ``mesh`` must be None until the parallelism slice, and both shardings
    are then None. The step updates params and state in place."""
    _no_mesh(mesh)

    def step(params, opt_state, tokens):
        loss, grads = value_and_grad(params, tokens, cfg)
        tx.update_(grads, opt_state, params)
        return params, opt_state, loss

    return step, tx.init, None, None


def make_accum_train_step(mesh, cfg: ModelConfig, tx, accum_steps: int):
    """Gradient accumulation: one optimizer update per stack of microbatches
    (accum, B, S), gradients summed in f32 and divided by the stack's own
    length (a shorter final stack still averages correctly), the loss the
    mean over microbatches. ``accum_steps`` is kept for the reference's
    signature; as there, the stack sets the count. Returns as
    :func:`make_optax_train_step`."""
    _no_mesh(mesh)

    def step(params, opt_state, token_stack):
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in tree_leaves(params)]
        losses = []
        for tokens in token_stack:
            loss, grads = value_and_grad(params, tokens, cfg)
            for a, g in zip(acc, tree_leaves(grads)):
                a.add_(g.float())
            losses.append(loss)
        n_micro = token_stack.shape[0]
        it = iter(acc)
        grads = tree_map(lambda p: (next(it) / n_micro).to(p.dtype), params)
        tx.update_(grads, opt_state, params)
        return params, opt_state, torch.stack(losses).mean()

    return step, tx.init, None, None
