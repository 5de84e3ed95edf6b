"""The plain reference of the train cell: the next-token loss of the
decoder, its gradient, and AdamW, in float32, followed for the first
steps of a run layer by layer so that it fits beside nothing else.

- The loss: the mean over every row's S - 1 positions of the negative log
  softmax of the next token (no auxiliary term: the model is dense).
- The gradient: the forward keeps each layer's input; the backward
  recomputes one layer at a time from it (the architecture's ``block``
  under autograd) and hands the layer's gradients to the caller before
  the next, so that only one layer's float32 weights and gradients live
  at a time.
- AdamW as published (Loshchilov and Hutter) with optax's defaults
  (b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4, bias-corrected moments,
  the decay added to the update before the learning rate): after step 1
  the update is g1 / (|g1| + eps) + wd p0; after step 2 the moments of g1
  and g2. The weights are stored in the configuration's dtype: a step's
  float32 result is rounded to it, as a bf16 weight holds it.
- Weights are the benchmark's tensors (the run's seed made them again),
  cast to float32 where they are used.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from . import model

B1, B2, EPS, WD = 0.9, 0.999, 1e-8, 1e-4
TOP = ("embed", "out", "ln_f")


def loss_and_grads(top: Dict[str, torch.Tensor], layer_weights: Callable,
                   n_layers: int, tokens: torch.Tensor, conf: dict,
                   take: Callable, quant: Optional[str] = None) -> float:
    """The loss at the weights ``top`` (float32 ``embed``, ``out``,
    ``ln_f``) and ``layer_weights(i)`` (float32 leaves of layer i); every
    leaf's gradient goes to ``take(path, grad)`` (path ("layers", i,
    name) or (name,)), the layers' from the last to the first."""
    b, s = tokens.shape
    arch = model.arch(conf)
    xs: List[torch.Tensor] = []
    with torch.no_grad():
        x = top["embed"][tokens]
        for i in range(n_layers):
            xs.append(x)
            w = layer_weights(i)
            x = torch.stack([arch.block(x[r], w, i, conf, quant)
                             for r in range(b)])
    x = x.detach().requires_grad_(True)
    ln_f = top["ln_f"].detach().requires_grad_(True)
    out = top["out"].detach().requires_grad_(True)
    logits = arch.head(x[:, :-1], ln_f, out, conf, quant)
    nll = -torch.log_softmax(logits, -1).gather(
        -1, tokens[:, 1:, None])[..., 0]
    loss = nll.sum() / (b * (s - 1))
    loss.backward()
    take(("ln_f",), ln_f.grad)
    take(("out",), out.grad)
    gx = x.grad
    del logits, nll
    for i in reversed(range(n_layers)):
        w = {k: v.detach().requires_grad_(True)
             for k, v in layer_weights(i).items()}
        xin = xs[i].detach().requires_grad_(True)
        y = torch.stack([arch.block(xin[r], w, i, conf, quant)
                         for r in range(b)])
        y.backward(gx)
        for k, v in w.items():
            take(("layers", i, k), v.grad)
        gx = xin.grad
        xs[i] = None
        del y, w, xin
    g_embed = torch.zeros_like(top["embed"]).index_add_(
        0, tokens.reshape(-1), gx.reshape(-1, gx.shape[-1]))
    take(("embed",), g_embed)
    return float(loss.detach())


def _leaf(tree, path):
    return tree[path[0]] if len(path) == 1 else tree["layers"][path[1]][
        path[2]]


def follow_two_steps(weights: dict, conf: dict, batches: List[torch.Tensor],
                     lr: float, store: torch.dtype,
                     quant: Optional[str] = None) -> dict:
    """Two AdamW steps from ``weights`` (the run's initial weights) on
    ``batches[0]`` and ``batches[1]``: each step's loss, the first
    gradient's norm a leaf, and the norm a leaf of the weights' change
    after the two steps. The weights are kept in ``store``, the dtype the
    configuration states for them: each step's result is rounded to it
    (what a step computes stays float32). Keeps g1 (float32) and, a layer
    at a time, the rest."""
    n_layers = conf["num_hidden_layers"]
    g1: Dict[tuple, torch.Tensor] = {}
    g1_norm: Dict[tuple, float] = {}

    def p0(path):
        return _leaf(weights, path).float()

    def first(path, g):
        g1[path] = g.detach()
        g1_norm[path] = float(g.detach().double().norm())

    loss1 = loss_and_grads({k: p0((k,)) for k in TOP},
                           lambda i: {k: p0(("layers", i, k))
                                      for k in weights["layers"][i]},
                           n_layers, batches[0], conf, first, quant)

    def delta1(path):
        g, p = g1[path], p0(path)
        return -lr * (g / (g.abs() + EPS) + WD * p)

    def rounded(x):
        return x.to(store).float()

    def p1(path):
        return rounded(p0(path) + delta1(path))

    change: Dict[tuple, float] = {}

    def second(path, g2):
        g = g1[path]
        m = (B1 * (1 - B1) * g + (1 - B1) * g2) / (1 - B1 ** 2)
        v = (B2 * (1 - B2) * g * g + (1 - B2) * g2 * g2) / (1 - B2 ** 2)
        d2 = -lr * (m / (v.sqrt() + EPS) + WD * p1(path))
        w1 = p1(path)
        change[path] = float((rounded(w1 + d2) - p0(path)).double().norm())
        del g1[path]

    loss2 = loss_and_grads({k: p1((k,)) for k in TOP},
                           lambda i: {k: p1(("layers", i, k))
                                      for k in weights["layers"][i]},
                           n_layers, batches[1], conf, second, quant)
    return {"losses": [loss1, loss2], "grad_norms": g1_norm,
            "change_norms": change}


def worst_leaf_gap(prog: Dict[tuple, float], ref: Dict[tuple, float],
                   keep=None) -> float:
    """max over leaves of |prog - ref| / max(ref, the median leaf's ref),
    over the leaves ``keep`` names (all when None)."""
    paths = [p for p in ref if keep is None or p in keep]
    vals = sorted(ref[p] for p in paths)
    median = vals[len(vals) // 2]
    return max(abs(prog[p] - ref[p]) / max(ref[p], median, 1e-30)
               for p in paths)
