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
- :func:`ring_attention` and :func:`ring_flash_attention` are sequence
  parallelism over a mesh axis (``sp``): each rank holds one chunk of the
  sequence, and K/V ride the ring of ranks while the queries stay. The
  first is the blockwise online-softmax ring in f32; the second runs the
  flash kernels on every (resident Q, visiting K/V) chunk pair and merges
  the partials by their logsumexps (:func:`_combine_partials`), and its
  backward is a second ring.
- :func:`decode_attention` is one query token a slot against the serving
  arena up to each slot's cursor: on CUDA tensors the hand-written kernel
  ``csrc/decode_attn.cu`` (K4, which replaces no Pallas kernel), on CPU
  tensors its plain version :func:`decode_attention_plain`.
  :func:`decode_kernel_takes` is the shape test by which the decode step
  routes to it.

GQA everywhere: k/v may carry h/n_rep heads, and no path expands them.
"""
from __future__ import annotations

import ctypes
import math
from typing import Callable, Optional

import numpy as np
import torch

from . import _build
from .mesh import Axis, ring_shift, shift

NEG_INF = float(np.finfo(np.float32).min)

# Launches of the flash forward kernel since the process started (or since
# a caller last set it to 0): proves a path went through the kernel.
FLASH_FWD_LAUNCHES = 0
# and of the backward kernels, K2 (dK, dV) and K3 (dQ)
FLASH_BWD_DKDV_LAUNCHES = 0
FLASH_BWD_DQ_LAUNCHES = 0
# and of K4's two kernels (the split and the combine), two a call
DECODE_ATTN_LAUNCHES = 0

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


# -- single-token attention over the serving arena (K4) ---------------------

_DECODE_DTYPES = {torch.bfloat16: 1, torch.float16: 2}
_DECODE_HEAD_DIMS = (128,)
# K4 streams a block's rows in steps of 64 (csrc/decode_attn.cu: STEP)
DECODE_STEP = 64
# blocks the grid should hold when every slot is full: eight waves of the
# H100's 132 SMs at K4's two blocks an SM
_DECODE_MIN_BLOCKS = 8 * 2 * 132


def decode_kernel_takes(device: torch.device, s_q: int, dtype: torch.dtype,
                        head_dim: int) -> bool:
    """Whether cached attention of ``s_q`` query rows over a cache of
    ``dtype`` and ``head_dim`` on ``device`` goes through K4: one query
    token, on the card, in bf16 or fp16, at a head dim the kernel is built
    for. Everything else keeps the einsum."""
    return (device.type == "cuda" and s_q == 1 and dtype in _DECODE_DTYPES
            and head_dim in _DECODE_HEAD_DIMS)


def decode_chunk(b: int, max_seq: int, kv: int, n_rep: int) -> int:
    """Rows of one slot a K4 block reads: 512 for a GQA group of up to 4
    (a chunk's f32 partials, 2·n_rep·hd·4 bytes written and read back, are
    then at most 1/64 of its chunk·hd·4 bytes of K and V), doubled per
    doubling of the group beyond 4; halved, down to one 64-row step, while
    a full arena would give the grid fewer than ``_DECODE_MIN_BLOCKS``
    blocks (a short arena or few slots or heads, as at tp 4 or in
    ``generate``)."""
    chunk = 512
    while chunk < 128 * n_rep:
        chunk *= 2
    groups = -(-n_rep // 16)
    while chunk > DECODE_STEP and (b * kv * groups * -(-max_seq // chunk)
                                   < _DECODE_MIN_BLOCKS):
        chunk //= 2
    return chunk


def _pos_vector(pos, b: int, device: torch.device) -> torch.Tensor:
    """The cursor as int64 (1,) or (b,) on ``device``; an int is filled in
    on the device, so a CUDA graph can record it."""
    if not isinstance(pos, torch.Tensor):
        pos = torch.full((), int(pos), dtype=torch.long, device=device)
    pos = pos.reshape(-1)
    if pos.numel() not in (1, b):
        raise ValueError(f"pos must be 0-d or ({b},), got {pos.numel()} "
                         f"cursors")
    if pos.device != device:
        raise ValueError(f"pos is on {pos.device}, q on {device}")
    return pos.long().contiguous()


def _check_decode_query(q: torch.Tensor, ck: torch.Tensor,
                        n_rep: int) -> None:
    if q.shape[1] != 1 or q.shape[2] != ck.shape[2] * n_rep:
        raise ValueError(f"decode attention takes one query token of "
                         f"kv·n_rep = {ck.shape[2] * n_rep} heads, got q "
                         f"{tuple(q.shape)}")


def decode_attention_plain(q: torch.Tensor, ck: torch.Tensor,
                           cv: torch.Tensor, pos, n_rep: int,
                           chunk: Optional[int] = None) -> torch.Tensor:
    """K4's plain version, its chunked arithmetic in float32: q (b, 1, h,
    hd) against ck, cv (b, max_seq, kv, hd), slot i attending rows 0 ..
    min(pos[i], max_seq − 1) (a negative cursor attends row 0). Each chunk
    of ``chunk`` rows (default :func:`decode_chunk`'s) gives a partial (o
    normalised, lse), P rounded to q's dtype before the product with V as
    the kernel rounds it; chunks past the cursor give nothing; the
    partials merge by their lse. Returns (b, 1, h, hd) in q's dtype."""
    _check_decode_query(q, ck, n_rep)
    b, _, h, hd = q.shape
    max_seq, kv = ck.shape[1], ck.shape[2]
    chunk = chunk or decode_chunk(b, max_seq, kv, n_rep)
    live = _pos_vector(pos, b, q.device).clamp(0, max_seq - 1) + 1
    qf = q.float().reshape(b, kv, n_rep, hd) * (1.0 / math.sqrt(hd))
    outs, lses = [], []
    for r0 in range(0, max_seq, chunk):
        rows = torch.arange(r0, min(r0 + chunk, max_seq), device=q.device)
        k, v = ck[:, r0:r0 + chunk].float(), cv[:, r0:r0 + chunk].float()
        s = torch.einsum("bgrd,bkgd->bgrk", qf, k)
        s = s.masked_fill((rows >= live[:, None])[:, None, None, :],
                          -math.inf)
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(m == -math.inf, 0.0, m)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bgrk,bkgd->bgrd", p.to(q.dtype).float(), v)
        outs.append(pv / torch.where(l == 0.0, 1.0, l))
        lses.append(torch.where(l == 0.0, -math.inf, m + torch.log(l)))
    o, lse = torch.stack(outs), torch.stack(lses)
    w = torch.exp(lse - lse.amax(dim=0))       # a chunk past the cursor: 0
    out = (w * o).sum(dim=0) / w.sum(dim=0)
    return out.reshape(b, 1, h, hd).to(q.dtype)


def _decode_attention_cuda(q: torch.Tensor, ck: torch.Tensor,
                           cv: torch.Tensor, pos, n_rep: int) -> torch.Tensor:
    global DECODE_ATTN_LAUNCHES
    _check_decode_query(q, ck, n_rep)
    b, _, h, hd = q.shape
    max_seq, kv = ck.shape[1], ck.shape[2]
    for name, t in (("ck", ck), ("cv", cv)):
        if t.shape != (b, max_seq, kv, hd):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(b, max_seq, kv, hd)}")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}, q is "
                             f"{q.dtype} on {q.device}")
        # 16-byte cp.async copies of every row
        if t.stride(3) != 1 or t.data_ptr() % 16 or any(
                t.stride(i) % 8 for i in range(3)):
            raise ValueError(f"{name}: K4 reads 16-byte aligned rows with "
                             f"a contiguous head dim")
    if q.dtype not in _DECODE_DTYPES:
        raise ValueError(f"decode kernel takes {list(_DECODE_DTYPES)}, got "
                         f"{q.dtype}")
    if hd not in _DECODE_HEAD_DIMS:
        raise ValueError(f"decode kernel takes head_dim in "
                         f"{_DECODE_HEAD_DIMS}, got {hd}")
    if q.stride(3) != 1 or q.data_ptr() % 4 or q.stride(0) % 2 or \
            q.stride(2) % 2:
        raise ValueError("q: K4 reads 4-byte aligned pairs along a "
                         "contiguous head dim")
    pos = _pos_vector(pos, b, q.device)
    chunk = decode_chunk(b, max_seq, kv, n_rep)
    n_chunks = -(-max_seq // chunk)
    out = torch.empty((b, 1, h, hd), dtype=q.dtype, device=q.device)
    o_part = torch.empty((b, n_chunks, h, hd), dtype=torch.float32,
                         device=q.device)
    lse_part = torch.empty((b, n_chunks, h), dtype=torch.float32,
                           device=q.device)
    lib = _build.load("decode_attn")
    with torch.cuda.device(q.device):
        err = lib.tpusched_decode_attn(
            q.data_ptr(), ck.data_ptr(), cv.data_ptr(), pos.data_ptr(),
            out.data_ptr(), o_part.data_ptr(), lse_part.data_ptr(),
            b, max_seq, h, kv, hd, chunk, int(pos.numel() > 1),
            q.stride(0), q.stride(2), *_strides(ck, cv),
            ctypes.c_float(1.0 / math.sqrt(hd)), _DECODE_DTYPES[q.dtype],
            _stream(q.device))
    if err:
        raise RuntimeError(f"decode_attn kernel launch failed: CUDA error "
                           f"{err}")
    DECODE_ATTN_LAUNCHES += 2
    return out


def decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     pos, n_rep: int) -> torch.Tensor:
    """One query token a slot, q (b, 1, kv·n_rep, hd), against the arena
    entry ck, cv (b, max_seq, kv, hd) read in place through its strides,
    slot i attending rows 0 .. min(pos[i], max_seq − 1); ``pos`` is 0-d or
    (b,) int64 on the device (or an int), read there, never on the host.
    Scale 1/√hd, softmax in f32, (b, 1, h, hd) in q's dtype. A CUDA tensor
    goes through K4 (``csrc/decode_attn.cu``) or raises; a CPU tensor
    through the plain version."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, ck, cv, pos, n_rep)
    if q.device.type != "cuda":
        raise ValueError(f"decode attention runs on cuda or cpu, not "
                         f"{q.device}")
    return _decode_attention_cuda(q, ck, cv, pos, n_rep)


# -- ring attention (sequence parallelism over the sp mesh axis) ------------------


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis: Optional[Axis], causal: bool = True) -> torch.Tensor:
    """Blockwise attention with K/V going round the ring of ``axis``: the
    operands are this rank's chunks (b, s_loc, h, d), rank i holding the
    sequence's chunk i. Each of the n steps attends the resident Q chunk
    to the K/V chunk held, then hands that chunk on to index + 1 (the last
    step's hop, whose chunk no step reads, is left out). Online softmax in
    f32 makes the result exact; under ``causal`` a future chunk's logits
    are masked to the finite ``NEG_INF``, so every exp() argument stays
    finite and an all-masked row keeps l = 1. GQA is folded into the
    einsums: K/V ride the ring kv_heads-sized. Gradients flow through
    autograd, the hops' included (:func:`mesh.ring_shift`). Each hop is one
    call of the mesh's hook, so a captured train step breaks its chain
    there (``program``)."""
    n, my = (axis.size, axis.index) if axis is not None else (1, 0)
    b, s_loc, h, d = q.shape
    kv = k.shape[2]
    scale = 1.0 / math.sqrt(d)
    q32 = q.float().reshape(b, s_loc, kv, h // kv, d)
    # step 0 attends the diagonal chunk, where every causal row has an
    # unmasked key: the running max is finite from the first step on
    m = torch.full((b, kv, h // kv, s_loc, 1), NEG_INF, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(q32)
    rows = torch.arange(s_loc, device=q.device)
    k_cur, v_cur = k, v
    for t in range(n):
        src = (my - t) % n                   # the global chunk now held
        s = torch.einsum("bqgrd,bkgd->bgrqk", q32, k_cur.float()) * scale
        if causal:
            visible = (my * s_loc + rows[:, None]) >= (src * s_loc
                                                       + rows[None, :])
            s = torch.where(visible, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)             # masked: exp(NEG_INF − m) = 0
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        pv = torch.einsum("bgrqk,bkgd->bqgrd", p, v_cur.float())
        acc = acc * alpha.permute(0, 3, 1, 2, 4) + pv
        m = m_new
        if t < n - 1:
            k_cur, v_cur = ring_shift(k_cur, axis), ring_shift(v_cur, axis)
    l = torch.where(l == 0.0, 1.0, l).permute(0, 3, 1, 2, 4)
    return (acc / l).reshape(b, s_loc, h, d).to(q.dtype)


def _combine_partials(o_acc: torch.Tensor, lse_acc: torch.Tensor,
                      o_t: torch.Tensor, lse_t: torch.Tensor):
    """Two normalized attention partials merged by their logsumexps: o
    (b·h, s, d) f32, lse (b·h, s, 1) f32."""
    lse_new = torch.logaddexp(lse_acc, lse_t)
    return (o_acc * torch.exp(lse_acc - lse_new)
            + o_t * torch.exp(lse_t - lse_new)), lse_new


def _excluded(src: int, my: int, causal: bool) -> bool:
    """Whether the pair (resident chunk ``my``, visiting chunk ``src``)
    lies wholly in the causal future, so that no kernel may run on it: a
    masked key whose logit exceeds the row's global lse would give
    exp(s − lse) = inf there, and 0·inf poisons the accumulators."""
    return causal and src > my


def _ring_flash_forward(q, k, v, axis: Optional[Axis], causal: bool):
    """(out (b, s, h, d) in q's dtype, lse (b·h, s, 1) f32) of the ring:
    K1 on the diagonal pair (causal or not), then n − 1 hops of K/V, K1
    non-causal on each visiting chunk not excluded, the partials combined
    in f32 from K1's out in q's dtype. Every rank makes every hop."""
    n, my = (axis.size, axis.index) if axis is not None else (1, 0)
    b, _, h, _ = q.shape
    out, lse = flash_forward(q, k, v, causal)
    o_acc = _to_bh(out).float()
    k_cur, v_cur = k, v
    for t in range(1, n):
        k_cur, v_cur = shift((k_cur, v_cur), axis)
        if _excluded((my - t) % n, my, causal):
            continue
        o_t, lse_t = flash_forward(q, k_cur, v_cur, False)
        o_acc, lse = _combine_partials(o_acc, lse, _to_bh(o_t).float(), lse_t)
    return _from_bh(o_acc.to(q.dtype), b, h), lse


class RingFlashAttention(torch.autograd.Function):
    """Ring-flash attention with its own backward, the reference's second
    ring: D = Σ dO∘O once for every pair; dQ accumulates in place in f32;
    dK and dV accumulate in f32 buffers that travel with their chunk and
    come home on one last hop. Each pair not excluded runs K2 then K3 with
    the ring's global out and lse (on the CPU, their plain version)."""

    @staticmethod
    def forward(ctx, q, k, v, axis, causal):
        out, lse = _ring_flash_forward(q, k, v, axis, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.axis, ctx.causal = axis, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        axis, causal = ctx.axis, ctx.causal
        n, my = (axis.size, axis.index) if axis is not None else (1, 0)
        do = do.contiguous()
        dd = _to_bh((do.float() * out.float()).sum(dim=-1, keepdim=True))
        dq, dk, dv = _flash_backward(q, k, v, out, lse, do, causal, dd)
        dq, dk, dv = dq.float(), dk.float(), dv.float()
        k_cur, v_cur = k, v
        for t in range(1, n):
            # the chunk and its gradient buffers hop together
            k_cur, v_cur, dk, dv = shift((k_cur, v_cur, dk, dv), axis)
            if _excluded((my - t) % n, my, causal):
                continue
            dq_t, dk_t, dv_t = _flash_backward(q, k_cur, v_cur, out, lse, do,
                                               False, dd)
            dq.add_(dq_t.float())
            dk.add_(dk_t.float())
            dv.add_(dv_t.float())
        dk, dv = shift((dk, dv), axis)       # the last hop brings them home
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def ring_flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         axis: Optional[Axis],
                         causal: bool = True) -> torch.Tensor:
    """Ring attention whose work on each chunk pair is the flash kernels
    (K1 forward, K2 and K3 backward), with gradients. A CUDA tensor goes
    through the kernels or raises: the reference's fallback to the naive
    ring, for shapes its Pallas kernels cannot tile, has no counterpart,
    since the CUDA kernels take ragged lengths."""
    _check_gqa(q, k, v)
    return RingFlashAttention.apply(q, k, v, axis, causal)


def make_ring_attention(axis: Optional[Axis],
                        causal: bool = True) -> Callable:
    """:func:`ring_attention` bound to the sp axis, as the model calls an
    attention function: ``fn(q, k, v)``."""
    return lambda q, k, v: ring_attention(q, k, v, axis, causal)


def make_ring_flash_attention(axis: Optional[Axis],
                              causal: bool = True) -> Callable:
    """:func:`ring_flash_attention` bound to the sp axis."""
    return lambda q, k, v: ring_flash_attention(q, k, v, axis, causal)
