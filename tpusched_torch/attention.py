"""Causal multi-head attention over ``(batch, seq, heads, head_dim)``.

Counterpart of ``tpusched/jaxbridge/attention.py``:

- :func:`naive_attention` materializes softmax(QKᵀ/√d)V; the ground truth.
- :func:`flash_attention` is FlashAttention-2 as a ``torch.autograd.Function``.
  On CUDA tensors the forward launches the hand-written Hopper kernel
  ``csrc/flash_fwd.cu`` (the port of the TPU kernel ``_flash_kernel``) and
  the backward the two of ``csrc/flash_bwd.cu`` (``_flash_bwd_dkdv_kernel``
  and ``_flash_bwd_dq_kernel``), or they raise; on CPU tensors they run the
  kernels' plain versions, :func:`flash_attention_plain` and
  :func:`flash_backward_plain`. K2's work at bf16 d=128 follows a schedule
  built here, :func:`_dkdv_schedule`.

GQA everywhere: k/v may carry h/n_rep heads, and no path expands them.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import numpy as np
import torch

from . import _build

NEG_INF = float(np.finfo(np.float32).min)

# Launches of the flash forward kernel since the process started (or since
# a caller last set it to 0): proves a path went through the kernel.
FLASH_FWD_LAUNCHES = 0
# and of the backward kernels, K2 (dK, dV) and K3 (dQ)
FLASH_BWD_DKDV_LAUNCHES = 0
FLASH_BWD_DQ_LAUNCHES = 0

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_HEAD_DIMS = (32, 64, 128)


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """Materialized softmax(QKᵀ/√d)V: (b, s, h, d) -> (b, s, h, d). The GQA
    group axis is folded into the einsum, never materialized to h heads."""
    b, s_q, h, d = q.shape
    kv = k.shape[2]
    if kv != h:
        qg = q.reshape(b, s_q, kv, h // kv, d)
        logits = torch.einsum("bqgrd,bkgd->bgrqk", qg, k) / math.sqrt(d)
    else:
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    logits = logits.float()
    if causal:
        # masked in f32: NEG_INF (f32's min) does not fit bf16, where the
        # reference's cast rounds it to -inf; either way its weight is 0
        mask = torch.ones(s_q, k.shape[1], dtype=torch.bool,
                          device=q.device).tril()
        logits = torch.where(mask, logits, NEG_INF)
    attn = torch.softmax(logits, dim=-1).to(q.dtype)
    if kv != h:
        return torch.einsum("bgrqk,bkgd->bqgrd", attn, v).reshape(b, s_q, h, d)
    return torch.einsum("bhqk,bkhd->bqhd", attn, v)


def repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """GQA -> MHA expansion: (b, s, n_kv, d) -> (b, s, n_kv·n_rep, d)."""
    if n_rep == 1:
        return x
    b, s, n_kv, d = x.shape
    return x[:, :, :, None, :].expand(b, s, n_kv, n_rep, d).reshape(
        b, s, n_kv * n_rep, d)


def _flash_blocks(s: int, block_q: int, block_k: int):
    """The reference's block clamp: a sequence no longer than a block is one
    block; otherwise halve (512 -> 256 -> 128) until the block divides s.
    A non-divisor result is what makes the reference fall back to naive;
    the CUDA kernel masks its ragged last tile and needs no such rule."""
    def fit(b: int) -> int:
        if s <= b:
            return s
        while b >= 128 and s % b:
            b //= 2
        return b
    return fit(block_q), fit(block_k)


def _to_bh(x: torch.Tensor) -> torch.Tensor:
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d)


def _from_bh(x: torch.Tensor, b: int, h: int) -> torch.Tensor:
    bh, s, d = x.shape
    return x.reshape(b, h, s, d).transpose(1, 2)


def _check_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    h, kv = q.shape[2], k.shape[2]
    if h % kv or v.shape[2] != kv:
        raise ValueError(
            f"kv heads must divide q heads and match between k/v for GQA "
            f"(q {h}, k {kv}, v {v.shape[2]})")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True):
    """The kernel's plain version, in float32: returns (out (b, s, h, d) in
    q's dtype, lse (b·h, s, 1) f32), with lse = m + log l as the kernel
    defines it. Query head ``bh`` reads KV row ``bh // n_rep`` through a
    folded group axis."""
    _check_gqa(q, k, v)
    b, s, h, d = q.shape
    kv = k.shape[2]
    n_rep = h // kv
    qf = _to_bh(q.float()).reshape(b * kv, n_rep, s, d)
    kf, vf = _to_bh(k.float()), _to_bh(v.float())
    scores = torch.einsum("grqd,gkd->grqk", qf, kf) * (1.0 / math.sqrt(d))
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, -math.inf)
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(m == -math.inf, 0.0, m)
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, 1.0, l)
    out = torch.einsum("grqk,gkd->grqd", p, vf) / safe_l
    lse = (m + torch.log(safe_l)).reshape(b * h, s, 1)
    return _from_bh(out.reshape(b * h, s, d), b, h).to(q.dtype), lse


def _check_operands(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    **rows: torch.Tensor) -> None:
    """What the kernels take, checked before anything touches the card:
    k/v (b, s, kv, d) and every tensor in ``rows`` (b, s, h, d), all on
    q's device in q's dtype; a dtype and head dim the kernels are built
    for; contiguous head dims, and in bf16 16-byte aligned rows."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    named = {"k": k, "v": v, **rows}
    for name, t in named.items():
        want = (b, s, h, d) if name in rows else (b, s, kv, d)
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.shape != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{want}")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash kernel takes {list(_KERNEL_DTYPES)}, got "
                         f"{q.dtype}")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in "
                         f"{_KERNEL_HEAD_DIMS}, got {d}")
    for name, t in {"q": q, **named}.items():
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
        # the bf16 kernels stage rows with 16-byte vector loads or TMA
        if q.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(t.stride(i) % 8 for i in range(3))):
            raise ValueError(f"{name}: the bf16 kernel needs a 16-byte "
                             f"aligned start and row strides")
    if b * h > 65535:
        raise ValueError(f"batch·heads {b * h} exceeds the kernel's grid")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _strides(*tensors: torch.Tensor):
    """The (batch, seq, head) element strides of each tensor, in order."""
    return [t.stride(i) for t in tensors for i in range(3)]


def _flash_forward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool):
    global FLASH_FWD_LAUNCHES
    _check_operands(q, k, v)
    b, s, h, d = q.shape
    kv = k.shape[2]
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, s, 1), dtype=torch.float32, device=q.device)
    if s == 0:
        return out, lse
    lib = _build.load("flash_fwd")
    with torch.cuda.device(q.device):
        err = lib.tpusched_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, s, h, kv, d, *_strides(q, k, v),
            ctypes.c_float(1.0 / math.sqrt(d)), int(causal),
            _KERNEL_DTYPES[q.dtype], _stream(q.device))
    if err:
        raise RuntimeError(f"flash_fwd kernel launch failed: CUDA error "
                           f"{err}")
    FLASH_FWD_LAUNCHES += 1
    return out, lse


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True):
    """(out (b, s, h, d), lse (b·h, s, 1) f32). A CUDA tensor goes through
    the kernel or raises; a CPU tensor through the plain version."""
    _check_gqa(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _flash_forward_cuda(q, k, v, causal)


def flash_backward_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         out: torch.Tensor, lse: torch.Tensor,
                         do: torch.Tensor, causal: bool = True,
                         dd: Optional[torch.Tensor] = None):
    """The backward kernels' plain version, written out in float32 without
    autograd: P from the forward's lse (b·h, s, 1), then dV = Pᵀ dO,
    dP = dO Vᵀ, dS = P ∘ (dP − D) · scale, dK = dSᵀ Q and dQ = dS K, with
    D = Σ_d dO ∘ O unless the caller gives ``dd`` (b·h, s, 1). The GQA group
    is a folded axis, so dK and dV come out summed over it. Returns
    (dq, dk, dv) in the inputs' dtypes."""
    _check_gqa(q, k, v)
    b, s, h, d = q.shape
    kv = k.shape[2]
    n_rep = h // kv

    def grouped(x):          # (b, s, h, d) or (b·h, s, 1) -> (b·kv, n_rep, s, .)
        x = _to_bh(x.float()) if x.dim() == 4 else x.float()
        return x.reshape(b * kv, n_rep, s, x.shape[-1])

    qf, gf = grouped(q), grouped(do)
    kf, vf = _to_bh(k.float()), _to_bh(v.float())
    dd = (gf * grouped(out)).sum(dim=-1, keepdim=True) if dd is None \
        else grouped(dd)
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("grqd,gkd->grqk", qf, kf) * scale
    if causal:
        mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, -math.inf)
    p = torch.exp(scores - grouped(lse))
    dv = torch.einsum("grqk,grqd->gkd", p, gf)
    ds = p * (torch.einsum("grqd,gkd->grqk", gf, vf) - dd) * scale
    dk = torch.einsum("grqk,grqd->gkd", ds, qf)
    dq = torch.einsum("grqk,gkd->grqd", ds, kf).reshape(b * h, s, d)
    return (_from_bh(dq, b, h).to(q.dtype), _from_bh(dk, b, kv).to(k.dtype),
            _from_bh(dv, b, kv).to(v.dtype))


# K2's tile at bf16 d=128: a segment's keys and a step's query rows
# (hopper::BK and hopper::BQ in csrc/flash_bwd.cu)
DKDV_TILE = 64


def _dkdv_schedule(b: int, s: int, kv: int, causal: bool) -> np.ndarray:
    """K2's work at bf16 d=128, one row per CUDA block: two segments
    (b·kv, key tile, first q-tile, end q-tile), key tile -1 for none. A
    segment walks all h/kv query heads of its group over q-tiles
    [first, end), so its keys' dK and dV leave the block whole. Causal: key
    tile j sees q-tiles j.. (the reference's ``reachable`` at 64-row
    blocks), and block i pairs key tile i with key tile n−1−i, so every
    block walks n+1 q-tiles per head; a middle tile left alone goes last.
    Non-causal: one key tile per block, every q-tile. Returns int32
    (blocks, 2, 4)."""
    n = -(-s // DKDV_TILE)
    if causal:
        pairs = [(i, n - 1 - i) for i in range(n // 2)]
        pairs += [(n // 2, -1)] if n % 2 else []
    else:
        pairs = [(j, -1) for j in range(n)]
    none = (0, -1, 0, 0)
    rows = [[(bkv, i, i if causal else 0, n),
             (bkv, j, j if causal else 0, n) if j >= 0 else none]
            for i, j in pairs for bkv in range(b * kv)]
    return np.asarray(rows, dtype=np.int32).reshape(-1, 2, 4)


_DKDV_TABLES: dict = {}


def _dkdv_table(b: int, s: int, kv: int, causal: bool,
                device: torch.device) -> torch.Tensor:
    """:func:`_dkdv_schedule` on ``device``, made once per shape."""
    key = (b, s, kv, causal, device)
    table = _DKDV_TABLES.get(key)
    if table is None:
        table = torch.as_tensor(_dkdv_schedule(b, s, kv, causal),
                                device=device)
        _DKDV_TABLES[key] = table
    return table


def _launch_bwd(entry: str, q, k, v, do, lse, dd, outs, causal) -> None:
    """Launch one backward kernel, ``"dkdv"`` (K2, outs = (dk, dv)) or
    ``"dq"`` (K3, outs = (dq,)), on the current stream, on operands that
    :func:`_flash_backward_cuda` has checked, and count the launch."""
    global FLASH_BWD_DKDV_LAUNCHES, FLASH_BWD_DQ_LAUNCHES
    b, s, h, d = q.shape
    kv = k.shape[2]
    sched = ()
    if entry == "dkdv":
        sched = (None, 0)      # only the bf16 d=128 kernel reads a schedule
        if q.dtype == torch.bfloat16 and d == 128:
            table = _dkdv_table(b, s, kv, causal, q.device)
            sched = (table.data_ptr(), table.shape[0])
    lib = _build.load("flash_bwd")
    with torch.cuda.device(q.device):
        err = getattr(lib, f"tpusched_flash_bwd_{entry}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dd.data_ptr(), *(t.data_ptr() for t in outs),
            b, s, h, kv, d, *_strides(q, k, v, do),
            ctypes.c_float(1.0 / math.sqrt(d)), int(causal),
            _KERNEL_DTYPES[q.dtype], *sched, _stream(q.device))
    if err:
        raise RuntimeError(f"flash_bwd_{entry} kernel launch failed: CUDA "
                           f"error {err}")
    if entry == "dkdv":
        FLASH_BWD_DKDV_LAUNCHES += 1
    else:
        FLASH_BWD_DQ_LAUNCHES += 1


def _flash_backward_cuda(q, k, v, out, lse, do, causal, dd):
    do = do.contiguous()     # autograd may hand in any layout: a copy if so
    _check_operands(q, k, v, out=out, dO=do)
    b, s, h, d = q.shape
    kv = k.shape[2]
    for name, t in (("lse", lse), ("dd", dd)):
        if t is None:
            continue
        if t.device != q.device or t.dtype != torch.float32 or \
                t.shape != (b * h, s, 1):
            raise ValueError(f"{name} must be float32 (b·h, s, 1) = "
                             f"{(b * h, s, 1)} on {q.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if dd is None:
        dd = _to_bh((do.float() * out.float()).sum(dim=-1, keepdim=True))
    lse, dd = lse.contiguous(), dd.contiguous()
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, kv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, s, kv, d), dtype=v.dtype, device=q.device)
    if s:
        _launch_bwd("dkdv", q, k, v, do, lse, dd, (dk, dv), causal)
        _launch_bwd("dq", q, k, v, do, lse, dd, (dq,), causal)
    return dq, dk, dv


def _flash_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                    causal: bool = True, dd: Optional[torch.Tensor] = None):
    """(dq, dk, dv) of flash attention from the forward's out and lse and
    the output gradient ``do``. ``dd`` (b·h, s, 1) f32 replaces
    D = Σ_d dO ∘ O where the caller holds a global one. A CUDA tensor goes
    through K2 then K3 or raises; a CPU tensor through the plain version."""
    _check_gqa(q, k, v)
    if q.device.type == "cpu":
        return flash_backward_plain(q, k, v, out, lse, do, causal, dd)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _flash_backward_cuda(q, k, v, out, lse, do, causal, dd)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its own backward: K1 forward, K2 and K3
    backward on the card; the plain versions on the CPU. Saves q, k, v, out
    and lse, never the score matrix."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_forward(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_flash_backward(q, k, v, out, lse, do, ctx.causal), None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """FlashAttention-2, GQA-native, with gradients: the score matrix never
    reaches device memory in either direction and K/V stay
    kv_heads-sized."""
    return FlashAttention.apply(q, k, v, causal)


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Alias of :func:`flash_attention`, the name the model resolves."""
    return flash_attention(q, k, v, causal)
