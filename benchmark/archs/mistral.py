"""Mistral (``model_type`` "mistral"; Mistral-7B-v0.1's ``config.json``):
identical decoder layers, each RMSNorm, grouped-query attention (head_dim
= hidden / heads, half-split rotary), RMSNorm and a SwiGLU MLP; the
embedding and the output head untied.

The port (``tpusched_torch.workload``) fixes RMSNorm's epsilon at 1e-6, the
rotary base at 1e4, the activation at silu and head_dim at hidden / heads:
a file that states others cannot run on it and is refused. The helpers
here (the decoder's leaf order, the attention's sizes) serve the
architectures that share this attention."""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from benchmark import flops, model

PORT_RMS_NORM_EPS = 1e-6
PORT_ROPE_THETA = 10000.0


def head_dim(conf: dict) -> int:
    return conf["hidden_size"] // conf["num_attention_heads"]


def port_kwargs(conf: dict) -> dict:
    """The ``ModelConfig`` arguments of the attention, the norms and a
    dense MLP, after the refusals."""
    if conf["rms_norm_eps"] != PORT_RMS_NORM_EPS:
        raise ValueError(f"the port's RMSNorm epsilon is {PORT_RMS_NORM_EPS}")
    if conf["rope_theta"] != PORT_ROPE_THETA:
        raise ValueError(f"the port's rotary base is {PORT_ROPE_THETA}")
    if conf["hidden_act"] != "silu":
        raise ValueError("the port's MLP is SwiGLU")
    if conf.get("head_dim", head_dim(conf)) != head_dim(conf):
        raise ValueError("the port's head_dim is hidden_size / heads")
    return dict(vocab=conf["vocab_size"], d_model=conf["hidden_size"],
                n_layers=conf["num_hidden_layers"],
                n_heads=conf["num_attention_heads"],
                n_kv_heads=conf["num_key_value_heads"],
                d_ff=conf["intermediate_size"], dtype=model.dtype_of(conf),
                attn=conf.get("port", {}).get("attn", "naive"))


def port_config(conf: dict, **overrides):
    from tpusched_torch.workload import ModelConfig
    return ModelConfig(**dict(port_kwargs(conf), **overrides))


Shaped = Dict[str, Tuple[tuple, torch.dtype]]


def decoder_leaves(conf: dict, layer: Callable[[int], Shaped]
                   ) -> List[model.Leaf]:
    """The leaves of an untied decoder in the benchmark's order: the
    embedding, the output head, the final norm, then each layer's leaves
    by name. ``layer(i)`` gives layer i's {name: (shape, dtype)}; a name
    that starts ``ln_`` is a norm, every other leaf a matrix scaled by its
    second-to-last axis (an expert's by its own fan-in)."""
    d, v, dt = conf["hidden_size"], conf["vocab_size"], model.dtype_of(conf)
    out = [model.Leaf(("embed",), (v, d), dt, -2),
           model.Leaf(("out",), (d, v), dt, -2),
           model.Leaf(("ln_f",), (d,), dt, None)]
    for i in range(conf["num_hidden_layers"]):
        for name, (shape, t) in sorted(layer(i).items()):
            out.append(model.Leaf(("layers", i, name), shape, t,
                                  None if name.startswith("ln_") else -2))
    return out


def attention_leaves(conf: dict) -> Shaped:
    """A layer's attention matrices and both of its norms."""
    d, dt = conf["hidden_size"], model.dtype_of(conf)
    d_kv = head_dim(conf) * conf["num_key_value_heads"]
    return {"wq": ((d, d), dt), "wk": ((d, d_kv), dt), "wv": ((d, d_kv), dt),
            "wo": ((d, d), dt), "ln_attn": ((d,), dt), "ln_mlp": ((d,), dt)}


def leaves(conf: dict) -> List[model.Leaf]:
    d, f, dt = conf["hidden_size"], conf["intermediate_size"], \
        model.dtype_of(conf)
    mlp = {"w_gate": ((d, f), dt), "w_up": ((d, f), dt),
           "w_down": ((f, d), dt)}
    return decoder_leaves(conf, lambda i: dict(attention_leaves(conf), **mlp))


def layer_counts(conf: dict, mlp_matrix: int, mlp_bytes: int,
                 expert_bytes: int = 0, experts: int = 0) -> flops.Layer:
    """A layer of this attention and its norms, with an MLP that a token
    multiplies through ``mlp_matrix`` entries of and whose weights a
    decode tick reads ``mlp_bytes`` of whatever it routes (and
    ``expert_bytes`` for each of the ``experts`` it routes to)."""
    d, h, kv = (conf["hidden_size"], conf["num_attention_heads"],
                conf["num_key_value_heads"])
    hd, item = head_dim(conf), flops.item_bytes(conf["torch_dtype"])
    attn = 2 * d * d + 2 * d * hd * kv
    return flops.Layer(matrix=attn + mlp_matrix, pair_flops=4 * h * hd,
                       window=None, fixed_bytes=(attn + 2 * d) * item
                       + mlp_bytes, expert_bytes=expert_bytes,
                       experts=experts, kv_row_bytes=2 * kv * hd * item,
                       attn=(h, kv, hd))


def decoder_counts(conf: dict, layer: Callable[[int], flops.Layer]
                   ) -> flops.Counts:
    """An untied decoder's counts, ``layer(i)`` giving layer i's."""
    d, v = conf["hidden_size"], conf["vocab_size"]
    item = flops.item_bytes(conf["torch_dtype"])
    return flops.Counts(
        layers=tuple(layer(i) for i in range(conf["num_hidden_layers"])),
        head=d * v, static_bytes=(d * v + d) * item, embed_row_bytes=d * item,
        item=item)


def counts(conf: dict) -> flops.Counts:
    mlp = 3 * conf["hidden_size"] * conf["intermediate_size"]
    item = flops.item_bytes(conf["torch_dtype"])
    return decoder_counts(conf, lambda i: layer_counts(conf, mlp, mlp * item))


def experts_per_token(conf: dict) -> int:
    return 0
