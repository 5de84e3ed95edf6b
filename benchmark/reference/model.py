"""The plain reference: the decoder of a configuration file, one sequence
at a time, in float32, written from the published description of its
architecture: ``reference/<model_type>.py`` (the file's ``model_type``)
gives the layer, ``block(x, layer, i, conf, quant, route)`` for layer
``i``, and ``head``, the final norm and the output head. What the
architectures share is here: the products with the fp8 control, RMSNorm
(x / sqrt(mean(x^2) + eps) * w), rotary embedding on the two halves of each
head (angle position / theta^(2i / head_dim)), causal grouped-query
attention (each key/value head serves heads / kv_heads query heads), and
the embedding lookup and the layers one at a time (``logits``).

- Weights are the tensors the benchmark made (matrices (in, out)), cast to
  float32 a layer (an expert) at a time, so the reference fits beside them.
- ``quant="fp8"`` is the control: every matrix product's two operands
  rounded to float8 e4m3 (the weight with one scale a matrix, the
  activations one scale a row) before a float32 product; attention stays
  float32. In training the gradients pass the rounding unchanged (the
  products of the backward take the rounded operands of the forward).
- ``route``, for a look at routing only (``benchmark.calibrate``; the
  check never passes it): a callable given each MoE layer's index and its
  router probabilities, which returns the top k experts of every token.
"""
from __future__ import annotations

import importlib
import math
from typing import Optional

import torch

FP8_MAX = 448.0
_BLOCK = 512


def fake_fp8(x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a scale (one, or one a row along
    ``dim``), as float32; a gradient passes through unchanged."""
    with torch.no_grad():
        amax = x.abs().amax() if dim is None else x.abs().amax(
            dim=dim, keepdim=True)
        scale = torch.clamp(amax, min=1e-12) / FP8_MAX
        q = (x / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def mm(a: torch.Tensor, w: torch.Tensor, quant: Optional[str]):
    w = w.float()
    if quant == "fp8":
        return fake_fp8(a, -1) @ fake_fp8(w, None)
    return a @ w


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (n, heads, head_dim) at positions 0..n-1."""
    n, _, hd = x.shape
    half = hd // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float64,
                                       device=x.device) / half)
    ang = (torch.arange(n, dtype=torch.float64, device=x.device)[:, None]
           * inv)[:, None, :]
    cos, sin = ang.cos().float(), ang.sin().float()
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v) -> torch.Tensor:
    """Causal GQA, float32: q (n, h, hd), k and v (n, kv, hd); queries in
    blocks so the scores fit."""
    n, h, hd = q.shape
    rep = h // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    out = torch.empty_like(q)
    keys = torch.arange(n, device=q.device)
    for lo in range(0, n, _BLOCK):
        hi = min(n, lo + _BLOCK)
        s = torch.einsum("qhd,khd->hqk", q[lo:hi], k[:hi]) / math.sqrt(hd)
        mask = keys[:hi][None, :] <= torch.arange(lo, hi,
                                                  device=q.device)[:, None]
        s = s.masked_fill(~mask[None], float("-inf"))
        out[lo:hi] = torch.einsum("hqk,khd->qhd", torch.softmax(s, -1),
                                  v[:hi])
    return out


def arch(conf: dict):
    """The reference of the file's architecture,
    ``reference/<model_type>.py``."""
    return importlib.import_module(
        f"benchmark.reference.{conf['model_type']}")


@torch.no_grad()
def logits(weights: dict, conf: dict, tokens: torch.Tensor,
           rows: torch.Tensor, quant: Optional[str] = None,
           route=None) -> torch.Tensor:
    """float32 logits (len(rows), vocab) of the sequence ``tokens`` (n,)
    at positions ``rows``: the distribution of the token after each."""
    a = arch(conf)
    x = weights["embed"][tokens].float()
    for i, layer in enumerate(weights["layers"]):
        x = a.block(x, layer, i, conf, quant, route)
    return a.head(x[rows], weights["ln_f"], weights["out"], conf, quant)
