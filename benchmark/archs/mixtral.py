"""Mixtral (``model_type`` "mixtral"; Mixtral-8x7B-v0.1's ``config.json``):
Mistral's layers with the MLP replaced by a mixture of
``num_local_experts`` SwiGLU experts, a softmax router choosing
``num_experts_per_tok`` a token, their gates renormalized to sum to one.

The port holds the router in float32 and runs the layer dropless at
inference; it shares Mistral's refusals (``mistral.port_kwargs``)."""
from __future__ import annotations

from typing import List

import torch

from benchmark import flops, model
from benchmark.archs import mistral


def port_config(conf: dict, **overrides):
    from tpusched_torch.workload import ModelConfig
    kw = dict(mistral.port_kwargs(conf), n_experts=conf["num_local_experts"],
              moe_top_k=conf["num_experts_per_tok"])
    kw.update(overrides)
    return ModelConfig(**kw)


def leaves(conf: dict) -> List[model.Leaf]:
    d, f, e = (conf["hidden_size"], conf["intermediate_size"],
               conf["num_local_experts"])
    dt = model.dtype_of(conf)
    moe = {"router": ((d, e), torch.float32), "w_gate": ((e, d, f), dt),
           "w_up": ((e, d, f), dt), "w_down": ((e, f, d), dt)}
    return mistral.decoder_leaves(
        conf, lambda i: dict(mistral.attention_leaves(conf), **moe))


def counts(conf: dict) -> flops.Counts:
    """A token multiplies through the router and its top-k experts; a
    decode tick reads the float32 router and each expert routed to."""
    d, e = conf["hidden_size"], conf["num_local_experts"]
    expert = 3 * d * conf["intermediate_size"]
    item = flops.item_bytes(conf["torch_dtype"])
    return mistral.decoder_counts(conf, lambda i: mistral.layer_counts(
        conf, d * e + experts_per_token(conf) * expert, d * e * 4,
        expert * item, e))


def experts_per_token(conf: dict) -> int:
    return conf["num_experts_per_tok"]
