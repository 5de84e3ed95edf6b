"""The benchmark's own arithmetic: the card's peaks, and the operations and
bytes the model NEEDS for a prefill, a decode tick and a flash-attention
call, at these inputs, whatever today's code executes. The sizes come
from the configuration's architecture (``archs/<model_type>.py``, whose
``counts`` gives a :class:`Counts`: one :class:`Layer` a decoder layer);
the sums below run over its layers, which may differ from one another.

- A prefill of a prompt of ``n`` true tokens: 2 x the layer matrices a
  token uses x n (an MoE layer's router and its top-k experts only), causal
  attention at n (the n (n + 1) / 2 query-key pairs, fewer under a
  layer's window, each 2 x head_dim
  operations for the scores and 2 x head_dim for the values, every head),
  and the output head for the last row only, the one whose logits give the
  next token. Padding to a prompt bucket is not counted.
- A decode tick: for every decoding slot, 2 x the layer matrices and the
  output head, and attention over the slot's live rows (its position + 1,
  at most the layer's window).
- The bytes of a decode tick (after ``tpusched_torch.measure.
  decode_bytes_per_token``, copied and changed): every attention matrix and
  the output head once, the embedding rows the batch gathers, the MLP
  weights once (an MoE layer's router and only the experts some slot
  routes to), and each decoding slot's live K/V rows, read once, at its own
  length. Dead arena rows are not counted.
- A flash-attention call of shape (b, s, h, kv, hd), causal: operations
  over the s (s + 1) / 2 pairs (K1: 2 products; K2, dK/dV: 4, the scores
  recomputed; K3, dQ: 3), bytes each input read once and each output
  written once.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Optional, Sequence, Tuple

# NVIDIA H100 SXM (the name torch gives it: "NVIDIA H100 80GB HBM3"), the
# data sheet's dense bf16 rate and HBM bandwidth, at its 700 W limit
PEAKS = {"H100 80GB HBM3": (989e12, 3.35e12), "H100 SXM": (989e12, 3.35e12)}


def peaks(device_name: str):
    """(FLOP/s, bytes/s) of the named card, or None for a card not in the
    table: a share of a peak is then not reported."""
    for key, val in PEAKS.items():
        if key in device_name:
            return val
    return None


@dataclass(frozen=True)
class Layer:
    """What the arithmetic needs of one decoder layer (an architecture's
    ``counts`` gives one a layer, ``archs/<model_type>.py``).

    - ``matrix``: the matrix entries one token multiplies through (an MoE
      layer's router and its routed experts only);
    - ``pair_flops``: scores and values of one query-key pair, every head;
    - ``window``: the keys a query attends at most (None: every earlier
      one);
    - ``fixed_bytes``, ``expert_bytes``, ``experts``: the bytes of the
      layer's weights that a decode tick reads whatever it routes, and of
      each of its ``experts`` (0 for a dense layer);
    - ``kv_row_bytes``: the K/V bytes of one cached row;
    - ``attn``: (heads, kv_heads, head_dim) of its flash-attention calls,
      None for a layer that makes none."""
    matrix: int
    pair_flops: int
    window: Optional[int]
    fixed_bytes: int
    expert_bytes: int
    experts: int
    kv_row_bytes: int
    attn: Optional[Tuple[int, int, int]]


@dataclass(frozen=True)
class Counts:
    """A model's layers, in order, and what lies outside them: ``head``,
    the output head's entries one token multiplies through;
    ``static_bytes``, the bytes a decode tick reads outside the layers
    (output head, final norm); ``embed_row_bytes``, one gathered
    embedding row; ``item``, the bytes of one activation element."""
    layers: Tuple[Layer, ...]
    head: int
    static_bytes: int
    embed_row_bytes: int
    item: int

    @property
    def flash_layers(self) -> Tuple[Layer, ...]:
        """The layers that call flash attention, in order: a prefill or a
        forward makes one call of each."""
        return tuple(x for x in self.layers if x.attn is not None)

    def flash_call(self, kernel: str, layer: Layer, b: int, s: int):
        """(operations, bytes) of one ``kernel`` call of ``layer`` at batch
        ``b`` and length ``s``."""
        return flash_call(kernel, b, s, *layer.attn, self.item, layer.window)


def item_bytes(torch_dtype: str) -> int:
    return 2 if torch_dtype in ("bfloat16", "float16") else 4


def causal_pairs(n: int, window: Optional[int] = None) -> int:
    """Query-key pairs of a causal pass over n tokens, each query
    attending at most ``window`` keys."""
    if window is None or window >= n:
        return n * (n + 1) // 2
    return window * (window + 1) // 2 + (n - window) * window


def attended(pos: int, window: Optional[int]) -> int:
    """Rows one decoding token at position ``pos`` attends."""
    return pos + 1 if window is None else min(pos + 1, window)


def prefill_flops(c: Counts, n: int) -> int:
    return (sum(2 * x.matrix * n + x.pair_flops * causal_pairs(n, x.window)
                for x in c.layers)
            + 2 * c.head)


def decode_flops(c: Counts, contexts: Iterable[int]) -> int:
    """``contexts``: each decoding slot's position (the rows before its
    token), so it attends position + 1 rows."""
    ctx = list(contexts)
    return (len(ctx) * (sum(2 * x.matrix for x in c.layers) + 2 * c.head)
            + sum(x.pair_flops * sum(attended(p, x.window) for p in ctx)
                  for x in c.layers))


def train_step_flops(c: Counts, batch: int, seq: int) -> int:
    """Forward and backward (3 x the forward), the remat recompute not
    counted; the loss reads every position's logits."""
    fwd = (sum(2 * x.matrix * seq + x.pair_flops * causal_pairs(seq, x.window)
               for x in c.layers)
           + 2 * c.head * seq)
    return 3 * batch * fwd


def decode_bytes(c: Counts, contexts: Sequence[int],
                 experts_routed: Optional[Sequence[int]] = None) -> int:
    """HBM bytes a decode tick needs. ``experts_routed``: for each layer,
    how many distinct experts its tokens route to (all of them when not
    given; a dense layer's entry is not read)."""
    total = c.static_bytes + len(contexts) * c.embed_row_bytes
    for i, x in enumerate(c.layers):
        routed = x.experts if experts_routed is None else experts_routed[i]
        total += x.fixed_bytes + routed * x.expert_bytes
        total += x.kv_row_bytes * sum(attended(p, x.window) for p in contexts)
    return total


def _flash_bytes(b: int, s: int, h: int, kv: int, hd: int, item: int,
                 reads_q: int, reads_kv: int, writes_q: int, writes_kv: int,
                 lse: int) -> int:
    return (item * (b * s * h * hd * (reads_q + writes_q)
                    + b * s * kv * hd * (reads_kv + writes_kv))
            + 4 * b * h * s * lse)


def flash_call(kernel: str, b: int, s: int, h: int, kv: int, hd: int,
               item: int = 2, window: Optional[int] = None):
    """(operations, bytes) of one causal call, each query attending at
    most ``window`` keys. K1 reads q, k, v and writes o and lse; K2 (dK,
    dV) reads q, k, v, dO, lse and D and writes dK and dV; K3 (dQ) reads
    the same and writes dQ."""
    pairs = b * causal_pairs(s, window) * h * hd
    if kernel == "K1":
        return 4 * pairs, _flash_bytes(b, s, h, kv, hd, item, 1, 2, 1, 0, 1)
    if kernel == "K2":
        return 8 * pairs, _flash_bytes(b, s, h, kv, hd, item, 2, 2, 0, 2, 2)
    if kernel == "K3":
        return 6 * pairs, _flash_bytes(b, s, h, kv, hd, item, 2, 2, 1, 0, 2)
    raise ValueError(kernel)


def bound_s(ops: float, nbytes: float, peak) -> float:
    """The least time the card could take: the larger of the two bounds."""
    flops, bw = peak
    return max(ops / flops, nbytes / bw)
