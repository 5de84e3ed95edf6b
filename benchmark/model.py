"""A configuration file (``configs/<name>.json``, the published
``config.json`` keys as they are run), its architecture, and the weights
the benchmark makes for it from the run's seed.

The architecture is the file's ``model_type``: ``archs/<model_type>.py``
gives the port's ``ModelConfig`` (``port_config``), every leaf of the
weights (``leaves``) and the arithmetic's sizes (``counts``), and
``reference/<model_type>.py`` the plain reference's layer. A new
architecture joins as those two files.

The weights are the benchmark's, not the program's: both the port and the
plain reference take the same tensors. They are drawn on the device into
one flat buffer a dtype, ``CHUNK`` normals a call, each chunk from a
generator seeded by (seed, chunk) so that a leaf can be made again alone,
and laid out as views in the port's parameter tree
(``embed``/``out``/``ln_f``/``layers[i]``, matrices stored (in, out)), in
the order ``leaves`` gives.
"""
from __future__ import annotations

import importlib
import json
import math
import pathlib
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
CHUNK = 1 << 24
_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


class Leaf(NamedTuple):
    """One leaf of the weights: its path in the tree (``("embed",)`` or
    ``("layers", i, name)``), shape and dtype, and how it is made:
    ``fan_in`` is the axis whose length scales a matrix (normal /
    sqrt(shape[fan_in])), None for a norm (1 + 0.05 normal)."""
    path: tuple
    shape: tuple
    dtype: torch.dtype
    fan_in: Optional[int]


def load_config(name: str) -> dict:
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


def dtype_of(conf: dict) -> torch.dtype:
    return _DTYPES[conf["torch_dtype"]]


def arch(conf: dict):
    """The module of the file's architecture, ``archs/<model_type>.py``."""
    return importlib.import_module(f"benchmark.archs.{conf['model_type']}")


def _layout(conf: dict):
    """Each leaf with its offset in its dtype's flat buffer, and each
    dtype's buffer length."""
    sizes: Dict[torch.dtype, int] = {}
    out = []
    for leaf in arch(conf).leaves(conf):
        out.append((leaf, sizes.get(leaf.dtype, 0)))
        sizes[leaf.dtype] = sizes.get(leaf.dtype, 0) + math.prod(leaf.shape)
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


def _shape_leaf(t: torch.Tensor, leaf: Leaf) -> None:
    if leaf.fan_in is None:
        t.mul_(0.05).add_(1.0)
    else:
        t.mul_(1.0 / math.sqrt(leaf.shape[leaf.fan_in]))


def make_weights(conf: dict, seed: int, device) -> dict:
    """The weights of a run: a pure function of (file, seed), each leaf
    made as its architecture's ``leaves`` says, in the dtype it gives.
    Each dtype's leaves are views into one buffer, filled chunk by chunk
    (``CHUNK`` normals a call)."""
    device = torch.device(device)
    layout, sizes = _layout(conf)
    bufs = {t: torch.empty(n, dtype=t, device=device)
            for t, n in sizes.items()}
    for buf in bufs.values():
        for c, lo in enumerate(range(0, buf.numel(), CHUNK)):
            _fill_chunk(buf[lo:lo + CHUNK], seed, c)
    tree: dict = {"layers": [{} for _ in range(conf["num_hidden_layers"])]}
    with torch.no_grad():
        for leaf, off in layout:
            t = bufs[leaf.dtype][off:off + math.prod(leaf.shape)].view(
                leaf.shape)
            _shape_leaf(t, leaf)
            if leaf.path[0] == "layers":
                tree["layers"][leaf.path[1]][leaf.path[2]] = t
            else:
                tree[leaf.path[0]] = t
    return tree


@torch.no_grad()
def initial_leaf(conf: dict, seed: int, path: tuple, device) -> torch.Tensor:
    """One leaf of ``make_weights(conf, seed, device)``, made again alone
    from the chunks that hold it."""
    layout, sizes = _layout(conf)
    leaf, off = next(x for x in layout if x[0].path == path)
    t = leaf.dtype
    n = math.prod(leaf.shape)
    first, last = off // CHUNK, (off + n - 1) // CHUNK
    end = min(sizes[t], (last + 1) * CHUNK)
    span = torch.empty(end - first * CHUNK, dtype=t, device=device)
    for c in range(first, last + 1):
        lo = (c - first) * CHUNK
        _fill_chunk(span[lo:lo + CHUNK], seed, c)
    out = span[off - first * CHUNK:off - first * CHUNK + n].view(leaf.shape)
    _shape_leaf(out, leaf)
    return out.clone()
