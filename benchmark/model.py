"""A configuration file (``configs/<name>.json``, the published
``config.json`` keys as they are run) as the port's ``ModelConfig``, and the
weights the benchmark makes for it from the run's seed.

The weights are the benchmark's, not the program's: both the port and the
plain reference take the same tensors. They are drawn on the device into
one flat buffer a dtype, ``CHUNK`` normals a call, each chunk from a
generator seeded by (seed, chunk) so that a leaf can be made again alone,
and laid out as views in the port's parameter tree
(``embed``/``out``/``ln_f``/``layers[i]``, matrices stored (in, out)).
"""
from __future__ import annotations

import json
import math
import pathlib
from typing import Dict, List, Tuple

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
# what the port fixes and a configuration file must state as it is run
PORT_RMS_NORM_EPS = 1e-6
PORT_ROPE_THETA = 10000.0
CHUNK = 1 << 24
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def load_config(name: str) -> dict:
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


def dtype_of(conf: dict) -> torch.dtype:
    return _DTYPES[conf["torch_dtype"]]


def port_config(conf: dict, **overrides):
    """The ``tpusched_torch.workload.ModelConfig`` a configuration file
    describes. The port fixes RMSNorm's epsilon and the rotary base: a file
    that states others cannot run on it and is refused."""
    from tpusched_torch.workload import ModelConfig
    if conf["rms_norm_eps"] != PORT_RMS_NORM_EPS:
        raise ValueError(f"the port's RMSNorm epsilon is {PORT_RMS_NORM_EPS}")
    if conf["rope_theta"] != PORT_ROPE_THETA:
        raise ValueError(f"the port's rotary base is {PORT_ROPE_THETA}")
    if conf["hidden_act"] != "silu":
        raise ValueError("the port's MLP is SwiGLU")
    kw = dict(vocab=conf["vocab_size"], d_model=conf["hidden_size"],
              n_layers=conf["num_hidden_layers"],
              n_heads=conf["num_attention_heads"],
              n_kv_heads=conf["num_key_value_heads"],
              d_ff=conf["intermediate_size"], dtype=dtype_of(conf),
              n_experts=conf.get("num_local_experts", 0),
              moe_top_k=conf.get("num_experts_per_tok", 2),
              attn=conf.get("port", {}).get("attn", "naive"))
    kw.update(overrides)
    return ModelConfig(**kw)


def shapes(conf: dict) -> Dict[str, object]:
    """Every leaf's shape in the port's tree, from the file alone."""
    d, f, v = conf["hidden_size"], conf["intermediate_size"], conf["vocab_size"]
    hd = d // conf["num_attention_heads"]
    d_kv = hd * conf["num_key_value_heads"]
    e = conf.get("num_local_experts", 0)
    layer = {"wq": (d, d), "wk": (d, d_kv), "wv": (d, d_kv), "wo": (d, d),
             "ln_attn": (d,), "ln_mlp": (d,)}
    if e:
        layer.update(router=(d, e), w_gate=(e, d, f), w_up=(e, d, f),
                     w_down=(e, f, d))
    else:
        layer.update(w_gate=(d, f), w_up=(d, f), w_down=(f, d))
    return {"embed": (v, d), "out": (d, v), "ln_f": (d,),
            "layers": [dict(layer) for _ in range(conf["num_hidden_layers"])]}


def _leaves(tree) -> List[Tuple[tuple, str, tuple]]:
    """(path, leaf name, shape) in a fixed order."""
    out = [(("embed",), "embed", tree["embed"]), (("out",), "out", tree["out"]),
           (("ln_f",), "ln_f", tree["ln_f"])]
    for i, layer in enumerate(tree["layers"]):
        out += [(("layers", i, k), k, s) for k, s in sorted(layer.items())]
    return out


def _layout(conf: dict):
    """Each leaf's (path, name, shape, dtype, offset in its dtype's flat
    buffer), and each dtype's buffer length."""
    dt = dtype_of(conf)
    sizes: Dict[torch.dtype, int] = {}
    out = []
    for path, name, shape in _leaves(shapes(conf)):
        t = torch.float32 if name == "router" else dt
        out.append((path, name, shape, t, sizes.get(t, 0)))
        sizes[t] = sizes.get(t, 0) + math.prod(shape)
    return out, sizes


def _fill_chunk(flat: torch.Tensor, seed: int, c: int) -> None:
    """Chunk ``c`` of a dtype's flat buffer (``flat`` holds just that
    chunk): normals from a generator of its own, so that any chunk can be
    made again alone."""
    state = np.random.SeedSequence(
        [int(seed) % (1 << 64), flat.element_size(), c]).generate_state(
            1, dtype=np.uint64)
    gen = torch.Generator(device=flat.device)
    gen.manual_seed(int(state[0]) % (1 << 63))
    flat.normal_(generator=gen)


def _shape_leaf(leaf: torch.Tensor, name: str, shape: tuple) -> None:
    if name.startswith("ln_"):
        leaf.mul_(0.05).add_(1.0)
    else:
        leaf.mul_(1.0 / math.sqrt(shape[-2]))


def make_weights(conf: dict, seed: int, device) -> dict:
    """The weights of a run: a pure function of (file, seed). Matrices
    normal / sqrt(fan_in), fan-in the second-to-last axis (an expert's by
    its own), in the file's dtype; the MoE router in float32 (the port
    holds it so); norms 1 + 0.05 normal, so that a norm weight left out
    shows. Each dtype's leaves are views into one buffer, filled chunk by
    chunk (``CHUNK`` normals a call)."""
    device = torch.device(device)
    layout, sizes = _layout(conf)
    bufs = {t: torch.empty(n, dtype=t, device=device)
            for t, n in sizes.items()}
    for buf in bufs.values():
        for c, lo in enumerate(range(0, buf.numel(), CHUNK)):
            _fill_chunk(buf[lo:lo + CHUNK], seed, c)
    tree: dict = {"layers": [{} for _ in range(conf["num_hidden_layers"])]}
    with torch.no_grad():
        for path, name, shape, t, off in layout:
            leaf = bufs[t][off:off + math.prod(shape)].view(shape)
            _shape_leaf(leaf, name, shape)
            if path[0] == "layers":
                tree["layers"][path[1]][path[2]] = leaf
            else:
                tree[path[0]] = leaf
    return tree


@torch.no_grad()
def initial_leaf(conf: dict, seed: int, path: tuple, device) -> torch.Tensor:
    """One leaf of ``make_weights(conf, seed, device)``, made again alone
    from the chunks that hold it."""
    layout, sizes = _layout(conf)
    _, name, shape, t, off = next(x for x in layout if x[0] == path)
    n = math.prod(shape)
    first, last = off // CHUNK, (off + n - 1) // CHUNK
    end = min(sizes[t], (last + 1) * CHUNK)
    span = torch.empty(end - first * CHUNK, dtype=t, device=device)
    for c in range(first, last + 1):
        lo = (c - first) * CHUNK
        _fill_chunk(span[lo:lo + CHUNK], seed, c)
    leaf = span[off - first * CHUNK:off - first * CHUNK + n].view(shape)
    _shape_leaf(leaf, name, shape)
    return leaf.clone()

