"""Mixtral's layer in the plain reference (``model_type`` "mixtral"):
Mistral's attention half, then RMSNorm and the mixture of experts: the
router's softmax over all experts, its top k renormalized to sum to one,
and the k experts' SwiGLU outputs weighted by them; the residual. The
head is Mistral's."""
from __future__ import annotations

from typing import Optional

import torch

from .mistral import attend, head, swiglu  # noqa: F401  (head: Mistral's)
from .model import mm, rmsnorm


def moe(h: torch.Tensor, layer: dict, i: int, conf: dict,
        quant: Optional[str], route=None) -> torch.Tensor:
    k = conf["num_experts_per_tok"]
    probs = torch.softmax(mm(h, layer["router"], quant), dim=-1)
    idx = probs.topk(k, dim=-1).indices if route is None else route(i, probs)
    top = probs.gather(-1, idx)
    gates = top / top.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(conf["num_local_experts"]):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        if rows.numel() == 0:
            continue
        y = swiglu(h[rows], layer["w_gate"][e], layer["w_up"][e],
                   layer["w_down"][e], quant)
        out.index_add_(0, rows, y * gates[rows, slot][:, None])
    return out


def block(x: torch.Tensor, layer: dict, i: int, conf: dict,
          quant: Optional[str] = None, route=None) -> torch.Tensor:
    """Layer ``i`` over one sequence's hidden states x (n, d)."""
    x = attend(x, layer, conf, quant)
    h = rmsnorm(x, layer["ln_mlp"], conf["rms_norm_eps"])
    return x + moe(h, layer, i, conf, quant, route)
