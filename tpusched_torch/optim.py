"""AdamW as ``optax.adamw(lr, mu_dtype=...)`` computes it (optax 0.2.6).

The reference trains with optax, which the card's machine does not have, so
the port keeps its own copy of the part it uses: ``scale_by_adam`` →
``add_decayed_weights`` → ``scale_by_learning_rate`` → ``apply_updates``,
with optax's defaults, pinned below as ``B1``, ``B2``, ``EPS`` and
``WEIGHT_DECAY`` (the reference never sets them), and its dtypes:

- mu is kept in ``mu_dtype`` (the parameter's dtype when None) and nu in the
  parameter's dtype;
- ``(1 − b1)·g`` is formed in the gradient's dtype and ``b1·mu`` in mu's,
  the sum in the wider of the two; likewise for nu with ``g²``;
- every constant is first rounded to the dtype of the tensor it meets, as
  JAX rounds a Python scalar to the array's dtype: with bf16 state b2 = 0.999
  becomes exactly 1.0, so a bf16 nu accumulates without decay, and the port
  keeps that;
- bias correction ``1 − b**t`` is computed in f32, rounded to each moment's
  dtype, and divides the moment in that dtype;
- the update ``mu_hat / (sqrt(nu_hat) + eps) + wd·p``, times ``−lr``, is f32
  whenever mu is, and is rounded once into the parameter's dtype when it is
  added.

``torch.optim.AdamW`` differs in all of this (both moments in the param
dtype, decay by multiplication, weight decay 1e-2), so it is not used.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch

from .workload import Params, tree_leaves, tree_map

# optax.adamw's defaults; the reference passes only lr and mu_dtype.
B1 = 0.9
B2 = 0.999
EPS = 1e-8
WEIGHT_DECAY = 1e-4


@dataclasses.dataclass
class AdamWState:
    count: int                 # steps taken; optax's ``count``
    mu: Params
    nu: Params


@functools.lru_cache(maxsize=None)
def _as(x: float, dtype: torch.dtype) -> float:
    """``x`` rounded to ``dtype``, as a Python float."""
    return float(torch.tensor(x, dtype=dtype))


def _bias_correction(decay: float, count: int, dtype: torch.dtype) -> float:
    """``1 − decay**count`` in f32, rounded to ``dtype``, as a Python float
    (so dividing a tensor by it stays in the tensor's dtype)."""
    b = torch.tensor(decay, dtype=torch.float32)
    return _as(float(1 - b ** count), dtype)


@dataclasses.dataclass(frozen=True)
class AdamW:
    """The counterpart of ``optax.adamw`` (no ``eps_root``, ``mask`` or
    Nesterov: the reference uses none of them). ``init(params)`` makes the
    state on the params' devices; ``update_(grads, state, params)`` takes
    one step IN PLACE, under ``torch.no_grad()``: it overwrites the
    parameter tensors, ``state.mu`` and ``state.nu``, and advances
    ``state.count``. (optax returns new trees; in place the step needs no
    second copy of params and state.)"""
    lr: float
    mu_dtype: Optional[torch.dtype] = None

    def init(self, params: Params) -> AdamWState:
        return AdamWState(
            count=0,
            mu=tree_map(lambda p: torch.zeros_like(
                p, dtype=self.mu_dtype or p.dtype), params),
            nu=tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update_(self, grads: Params, state: AdamWState,
                params: Params) -> AdamWState:
        state.count += 1
        t = state.count
        for g, mu, nu, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                                tree_leaves(state.nu), tree_leaves(params)):
            mu_new = (_as(1 - B1, g.dtype) * g
                      + _as(B1, mu.dtype) * mu)
            nu_new = (_as(1 - B2, g.dtype) * g.square()
                      + _as(B2, nu.dtype) * nu)
            mu_hat = mu_new / _bias_correction(B1, t, mu_new.dtype)
            nu_hat = nu_new / _bias_correction(B2, t, nu_new.dtype)
            u = mu_hat / (nu_hat.sqrt() + _as(EPS, nu_hat.dtype))
            u = u + _as(WEIGHT_DECAY, p.dtype) * p
            u = _as(-self.lr, u.dtype) * u
            p.copy_(p + u)
            mu.copy_(mu_new)
            nu.copy_(nu_new)
        return state


adamw = AdamW                  # optax's name, as the reference calls it
