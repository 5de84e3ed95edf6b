"""Weights carried across from the JAX reference as numpy arrays.

The caller converts the JAX parameter tree with
``jax.tree.map(np.asarray, params)``; this module never imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .workload import (ModelConfig, Params, param_dtype, param_shapes,
                       resolve_device)


def _tensor(a, want_shape, dtype: torch.dtype, where: str,
            device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if tuple(a.shape) != tuple(want_shape):
        raise ValueError(f"{where}: shape {tuple(a.shape)}, config says "
                         f"{tuple(want_shape)}")
    # arrays out of JAX are read-only, and torch.from_numpy has no bfloat16
    # (ml_dtypes' type, told by name so ml_dtypes need not be imported):
    # copy, routing bfloat16 through float32, which holds it exactly
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    if t.dtype != dtype:
        raise ValueError(f"{where}: dtype {t.dtype}, config says {dtype}")
    return t.to(device)


def params_from_numpy(tree: Params, cfg: ModelConfig, device=None) -> Params:
    """The port's parameter dict from the reference's tree of numpy arrays,
    with every shape and dtype checked against ``cfg`` (the MoE router as
    float32, every other leaf as ``cfg.master_dtype``)."""
    device = resolve_device(device)
    shapes = param_shapes(cfg)
    if len(tree["layers"]) != cfg.n_layers:
        raise ValueError(f"{len(tree['layers'])} layers, config says "
                         f"{cfg.n_layers}")
    out: Params = {name: _tensor(tree[name], shapes[name],
                                 param_dtype(cfg, name), name, device)
                   for name in ("embed", "out", "ln_f")}
    out["layers"] = []
    for i, (layer, want) in enumerate(zip(tree["layers"], shapes["layers"])):
        if set(layer) != set(want):
            raise ValueError(f"layers[{i}]: keys {sorted(layer)}, config "
                             f"says {sorted(want)}")
        out["layers"].append({
            name: _tensor(layer[name], want[name], param_dtype(cfg, name),
                          f"layers[{i}].{name}", device)
            for name in want})
    return out
