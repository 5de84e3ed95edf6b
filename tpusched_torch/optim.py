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

A step has a host part and a device part. The host part
(:meth:`AdamW.advance_`) counts the step and writes the two bias
corrections into 0-d buffers on the device, one per moment dtype
(:meth:`AdamW.corrections`, made once); the device part
(:meth:`AdamW.apply_`) reads them there. A train step captured as a CUDA
graph replays the device part with the step's own corrections, never the
first step's, and ``update_`` runs both parts, so eager and captured steps
compute the same bits.

``torch.optim.AdamW`` differs in all of this (both moments in the param
dtype, decay by multiplication, weight decay 1e-2), so it is not used.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

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


Corrections = Dict[Tuple[float, torch.dtype], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamW:
    """The counterpart of ``optax.adamw`` (no ``eps_root``, ``mask`` or
    Nesterov: the reference uses none of them). ``init(params)`` makes the
    state on the params' devices; ``update_(grads, state, params)`` takes
    one step IN PLACE, under ``torch.no_grad()``: it overwrites the
    parameter tensors, ``state.mu`` and ``state.nu``, and advances
    ``state.count``. (optax returns new trees; in place the step needs no
    second copy of params and state.) ``update_`` is ``advance_`` (host)
    then ``apply_`` (device) over ``corrections(state)``."""
    lr: float
    mu_dtype: Optional[torch.dtype] = None

    def init(self, params: Params) -> AdamWState:
        return AdamWState(
            count=0,
            mu=tree_map(lambda p: torch.zeros_like(
                p, dtype=self.mu_dtype or p.dtype), params),
            nu=tree_map(torch.zeros_like, params))

    def corrections(self, state: AdamWState) -> Corrections:
        """The 0-d buffers the device part reads the bias corrections
        from, keyed (B1, dtype of mu's update) and (B2, dtype of nu's),
        made here on the state's device and never inside a step. The
        gradients come in the parameters' dtype, which is nu's: mu's update
        is in the wider of it and mu's, nu's in nu's. Every other constant
        of the device part is rounded here too (``_as`` keeps it), so the
        step itself makes no tensor."""
        out: Corrections = {}
        for mu, nu in zip(tree_leaves(state.mu), tree_leaves(state.nu)):
            m = torch.promote_types(mu.dtype, nu.dtype)
            u = torch.promote_types(m, nu.dtype)
            for x, dtype in ((1 - B1, nu.dtype), (B1, mu.dtype),
                             (1 - B2, nu.dtype), (B2, nu.dtype),
                             (EPS, nu.dtype), (WEIGHT_DECAY, nu.dtype),
                             (-self.lr, u)):
                _as(x, dtype)
            for key in ((B1, m), (B2, nu.dtype)):
                if key not in out:
                    out[key] = torch.zeros((), dtype=key[1],
                                           device=nu.device)
        return out

    @staticmethod
    def advance_(state: AdamWState, corr: Corrections) -> None:
        """The host part: count the step and write its corrections
        ``1 − b**t`` into ``corr``."""
        state.count += 1
        for (decay, dtype), buf in corr.items():
            buf.fill_(_bias_correction(decay, state.count, dtype))

    @torch.no_grad()
    def apply_(self, grads: Params, state: AdamWState, params: Params,
               corr: Corrections) -> None:
        """The device part: the step of the count ``advance_`` set, its
        corrections read from ``corr``. Makes no tensor of a host value."""
        for g, mu, nu, p in zip(tree_leaves(grads), tree_leaves(state.mu),
                                tree_leaves(state.nu), tree_leaves(params)):
            mu_new = (_as(1 - B1, g.dtype) * g
                      + _as(B1, mu.dtype) * mu)
            nu_new = (_as(1 - B2, g.dtype) * g.square()
                      + _as(B2, nu.dtype) * nu)
            mu_hat = mu_new / corr[B1, mu_new.dtype]
            nu_hat = nu_new / corr[B2, nu_new.dtype]
            u = mu_hat / (nu_hat.sqrt() + _as(EPS, nu_hat.dtype))
            u = u + _as(WEIGHT_DECAY, p.dtype) * p
            u = _as(-self.lr, u.dtype) * u
            p.copy_(p + u)
            mu.copy_(mu_new)
            nu.copy_(nu_new)

    @torch.no_grad()
    def update_(self, grads: Params, state: AdamWState,
                params: Params) -> AdamWState:
        corr = self.corrections(state)
        self.advance_(state, corr)
        self.apply_(grads, state, params, corr)
        return state


adamw = AdamW                  # optax's name, as the reference calls it
