"""The plain reference: the decoder of a configuration file, one sequence
at a time, in float32, written from the published description (Mistral,
Mixtral) with the file's ``rms_norm_eps`` and ``rope_theta``.

- Embedding lookup; per layer RMSNorm (x / sqrt(mean(x^2) + eps) * w),
  query/key/value projections, rotary embedding on the two halves of each
  head (angle position / theta^(2i / head_dim)), causal grouped-query
  attention (each key/value head serves heads / kv_heads query heads),
  the output projection and the residual; RMSNorm and the SwiGLU MLP
  (silu(h Wg) * (h Wu)) Wd, or for a mixture of experts the router's
  softmax over all experts, its top k renormalized to sum to one, and the
  k experts' SwiGLU outputs weighted by them; the residual; the final norm
  and the output head.
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

import math
from typing import Optional

import torch

FP8_MAX = 448.0
_BLOCK = 512


def _fake_fp8(x: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under a scale (one, or one a row along
    ``dim``), as float32; a gradient passes through unchanged."""
    with torch.no_grad():
        amax = x.abs().amax() if dim is None else x.abs().amax(
            dim=dim, keepdim=True)
        scale = torch.clamp(amax, min=1e-12) / FP8_MAX
        q = (x / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def _mm(a: torch.Tensor, w: torch.Tensor, quant: Optional[str]):
    w = w.float()
    if quant == "fp8":
        return _fake_fp8(a, -1) @ _fake_fp8(w, None)
    return a @ w


def _rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def _rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
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


def _attention(q, k, v) -> torch.Tensor:
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


def _mlp(h, layer, conf, quant, route=None):
    if not conf.get("num_local_experts", 0):
        return _mm(torch.nn.functional.silu(_mm(h, layer["w_gate"], quant))
                   * _mm(h, layer["w_up"], quant), layer["w_down"], quant)
    k = conf["num_experts_per_tok"]
    probs = torch.softmax(_mm(h, layer["router"], quant), dim=-1)
    idx = probs.topk(k, dim=-1).indices if route is None else route(probs)
    top = probs.gather(-1, idx)
    gates = top / top.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(conf["num_local_experts"]):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        x = h[rows]
        y = _mm(torch.nn.functional.silu(_mm(x, layer["w_gate"][e], quant))
                * _mm(x, layer["w_up"][e], quant), layer["w_down"][e], quant)
        out.index_add_(0, rows, y * gates[rows, slot][:, None])
    return out


def block(x: torch.Tensor, layer: dict, conf: dict,
          quant: Optional[str] = None, route=None) -> torch.Tensor:
    """One decoder layer over one sequence's hidden states x (n, d)."""
    eps, theta = conf["rms_norm_eps"], conf["rope_theta"]
    h_n, kv_n = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = conf["hidden_size"] // h_n
    n = x.shape[0]
    h = _rmsnorm(x, layer["ln_attn"], eps)
    q = _rotary(_mm(h, layer["wq"], quant).view(n, h_n, hd), theta)
    k = _rotary(_mm(h, layer["wk"], quant).view(n, kv_n, hd), theta)
    v = _mm(h, layer["wv"], quant).view(n, kv_n, hd)
    x = x + _mm(_attention(q, k, v).reshape(n, -1), layer["wo"], quant)
    return x + _mlp(_rmsnorm(x, layer["ln_mlp"], eps), layer, conf, quant,
                    route)


def head(x: torch.Tensor, ln_f: torch.Tensor, out: torch.Tensor, conf: dict,
         quant: Optional[str] = None) -> torch.Tensor:
    """The final norm and the output head: logits of hidden states x."""
    return _mm(_rmsnorm(x, ln_f, conf["rms_norm_eps"]), out, quant)


@torch.no_grad()
def logits(weights: dict, conf: dict, tokens: torch.Tensor,
           rows: torch.Tensor, quant: Optional[str] = None,
           route=None) -> torch.Tensor:
    """float32 logits (len(rows), vocab) of the sequence ``tokens`` (n,)
    at positions ``rows``: the distribution of the token after each."""
    x = weights["embed"][tokens].float()
    for i, layer in enumerate(weights["layers"]):
        x = block(x, layer, conf, quant,
                  None if route is None else (lambda pr, i=i: route(i, pr)))
    return head(x[rows], weights["ln_f"], weights["out"], conf, quant)
