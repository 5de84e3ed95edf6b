"""Causal multi-head attention over ``(batch, seq, heads, head_dim)``.

Counterpart of ``tpusched/jaxbridge/attention.py``:

- :func:`naive_attention` materializes softmax(QKᵀ/√d)V; the ground truth.
- :func:`flash_attention` is the FlashAttention-2 forward. On a CUDA tensor
  it launches the hand-written Hopper kernel ``csrc/flash_fwd.cu`` (the
  port of the TPU kernel ``_flash_kernel``) or raises; on a CPU tensor it
  runs the kernel's plain version, :func:`flash_attention_plain`.

GQA everywhere: k/v may carry h/n_rep heads, and no path expands them.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from . import _build

NEG_INF = float(np.finfo(np.float32).min)

# Launches of the flash forward kernel since the process started (or since
# a caller last set it to 0): proves a path went through the kernel.
FLASH_FWD_LAUNCHES = 0

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


def _flash_forward_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool):
    global FLASH_FWD_LAUNCHES
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError(
            "flash_attention on CUDA is forward-only: its backward kernels "
            "are still to be ported (ROADMAP, training slice); run under "
            "torch.no_grad() or use naive attention for gradients")
    b, s, h, d = q.shape
    kv = k.shape[2]
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.shape != (b, s, kv, d):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(b, s, kv, d)}")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash kernel takes {list(_KERNEL_DTYPES)}, got "
                         f"{q.dtype}")
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in "
                         f"{_KERNEL_HEAD_DIMS}, got {d}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
        # the bf16 kernel stages rows with 16-byte vector loads
        if q.dtype == torch.bfloat16 and (
                t.data_ptr() % 16 or any(t.stride(i) % 8 for i in range(3))):
            raise ValueError(f"{name}: the bf16 kernel needs a 16-byte "
                             f"aligned start and row strides")
    if b * h > 65535:
        raise ValueError(f"batch·heads {b * h} exceeds the kernel's grid")
    out = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, s, 1), dtype=torch.float32, device=q.device)
    if s == 0:
        return out, lse
    lib = _build.load("flash_fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.tpusched_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, s, h, kv, d,
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            ctypes.c_float(1.0 / math.sqrt(d)), int(causal),
            _KERNEL_DTYPES[q.dtype], ctypes.c_void_p(stream))
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """FlashAttention-2 forward, GQA-native: the score matrix never reaches
    device memory and K/V stay kv_heads-sized."""
    return flash_forward(q, k, v, causal)[0]


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True) -> torch.Tensor:
    """Alias of :func:`flash_attention`, the name the model resolves."""
    return flash_attention(q, k, v, causal)
