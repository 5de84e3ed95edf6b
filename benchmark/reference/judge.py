"""Judging served tokens against the plain reference.

A served token is right to the degree that the reference ranks it first:
for each served token, the gap by which the reference's logit of it lies
below the reference's best logit at that position (0 when the reference
agrees). A run is judged by the widest gap over a sample of its finished
requests. The control reads the same gap for the token that the fp8
reference ranks first, at each position of the same prompts and tokens.
"""
from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from . import model


def _exact_matmuls() -> None:
    """float32 products in float32: TF32 is a lower precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _sequence(prompt: np.ndarray, served: np.ndarray, device):
    tokens = torch.as_tensor(np.concatenate([prompt, served[:-1]]),
                             dtype=torch.long, device=device)
    rows = torch.arange(len(prompt) - 1, len(prompt) - 1 + len(served),
                        device=device)
    return tokens, rows


def gaps(weights: dict, conf: dict,
         items: Iterable[Tuple[np.ndarray, np.ndarray]], device,
         control: Optional[str] = None, routes=None) -> np.ndarray:
    """Every judged token's gap over ``items``, (prompt, served tokens)
    pairs: of the served token, or with ``control`` (``"fp8"``) of the
    token that the control reference ranks first at the same position.
    ``routes`` (a look at routing only): for each item, a callable that
    gives the reference's MoE layers their experts (``model.logits``)."""
    _exact_matmuls()
    out = []
    for j, (prompt, served) in enumerate(items):
        tokens, rows = _sequence(prompt, served, device)
        lg = model.logits(weights, conf, tokens, rows,
                          route=None if routes is None else routes[j])
        if control is None:
            pick = torch.as_tensor(served, dtype=torch.long, device=device)
        else:
            pick = model.logits(weights, conf, tokens, rows,
                                quant=control).argmax(-1)
        out.append((lg.amax(-1) - lg.gather(1, pick[:, None])[:, 0]).cpu())
    return torch.cat(out).double().numpy() if out else np.zeros(0)

