"""Mistral's layer in the plain reference (``model_type`` "mistral"):
RMSNorm, query/key/value projections, rotary embedding at the file's
``rope_theta``, causal grouped-query attention, the output projection and
the residual; RMSNorm and the SwiGLU MLP (silu(h Wg) * (h Wu)) Wd; the
residual. The head: the final RMSNorm and the output projection."""
from __future__ import annotations

from typing import Optional

import torch

from .model import attention, mm, rmsnorm, rotary


def attend(x: torch.Tensor, layer: dict, conf: dict,
           quant: Optional[str]) -> torch.Tensor:
    """The attention half of a layer with its residual, over one
    sequence's hidden states x (n, d)."""
    h_n, kv_n = conf["num_attention_heads"], conf["num_key_value_heads"]
    hd = conf["hidden_size"] // h_n
    theta = conf["rope_theta"]
    n = x.shape[0]
    h = rmsnorm(x, layer["ln_attn"], conf["rms_norm_eps"])
    q = rotary(mm(h, layer["wq"], quant).view(n, h_n, hd), theta)
    k = rotary(mm(h, layer["wk"], quant).view(n, kv_n, hd), theta)
    v = mm(h, layer["wv"], quant).view(n, kv_n, hd)
    return x + mm(attention(q, k, v).reshape(n, -1), layer["wo"], quant)


def swiglu(h: torch.Tensor, w_gate, w_up, w_down,
           quant: Optional[str]) -> torch.Tensor:
    return mm(torch.nn.functional.silu(mm(h, w_gate, quant))
              * mm(h, w_up, quant), w_down, quant)


def block(x: torch.Tensor, layer: dict, i: int, conf: dict,
          quant: Optional[str] = None, route=None) -> torch.Tensor:
    """Layer ``i`` over one sequence's hidden states x (n, d)."""
    x = attend(x, layer, conf, quant)
    h = rmsnorm(x, layer["ln_mlp"], conf["rms_norm_eps"])
    return x + swiglu(h, layer["w_gate"], layer["w_up"], layer["w_down"],
                      quant)


def head(x: torch.Tensor, ln_f: torch.Tensor, out: torch.Tensor, conf: dict,
         quant: Optional[str] = None) -> torch.Tensor:
    """The final norm and the output head: logits of hidden states x."""
    return mm(rmsnorm(x, ln_f, conf["rms_norm_eps"]), out, quant)
