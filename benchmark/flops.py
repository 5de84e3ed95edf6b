"""The benchmark's own arithmetic: the card's peaks, and the operations and
bytes the model NEEDS for a prefill, a decode tick and a flash-attention
call, at these inputs, whatever today's code executes.

- A prefill of a prompt of ``n`` true tokens: 2 x the layer matrices a
  token uses x n (an MoE layer's router and its top-k experts only), causal
  attention at n (the n (n + 1) / 2 query-key pairs, each 2 x head_dim
  operations for the scores and 2 x head_dim for the values, every head),
  and the output head for the last row only, the one whose logits give the
  next token. Padding to a prompt bucket is not counted.
- A decode tick: for every decoding slot, 2 x the layer matrices and the
  output head, and attention over the slot's live rows (its position + 1).
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

from typing import Iterable, Optional, Sequence

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


class Shapes:
    """The sizes the arithmetic needs, from a configuration file."""

    def __init__(self, conf: dict):
        self.d = conf["hidden_size"]
        self.f = conf["intermediate_size"]
        self.v = conf["vocab_size"]
        self.layers = conf["num_hidden_layers"]
        self.h = conf["num_attention_heads"]
        self.kv = conf["num_key_value_heads"]
        self.hd = self.d // self.h
        self.e = conf.get("num_local_experts", 0)
        self.k = conf.get("num_experts_per_tok", 2) if self.e else 0
        self.item = 2 if conf["torch_dtype"] in ("bfloat16", "float16") else 4

    @property
    def attn_params(self) -> int:
        return 2 * self.d * self.d + 2 * self.d * self.hd * self.kv

    @property
    def expert_params(self) -> int:
        return 3 * self.d * self.f

    @property
    def layer_params_per_token(self) -> int:
        """The matrix entries one token multiplies through in a layer."""
        if self.e:
            return (self.attn_params + self.d * self.e
                    + self.k * self.expert_params)
        return self.attn_params + self.expert_params

    def attn_pair_flops(self) -> int:
        """Scores and values for one query-key pair, all heads, one layer."""
        return 4 * self.h * self.hd


def causal_pairs(n: int) -> int:
    return n * (n + 1) // 2


def prefill_flops(sh: Shapes, n: int) -> int:
    return (sh.layers * (2 * sh.layer_params_per_token * n
                         + sh.attn_pair_flops() * causal_pairs(n))
            + 2 * sh.d * sh.v)


def decode_flops(sh: Shapes, contexts: Iterable[int]) -> int:
    """``contexts``: each decoding slot's position (the rows before its
    token), so it attends position + 1 rows."""
    ctx = list(contexts)
    return (len(ctx) * (sh.layers * 2 * sh.layer_params_per_token
                        + 2 * sh.d * sh.v)
            + sh.layers * sh.attn_pair_flops() * sum(c + 1 for c in ctx))


def train_step_flops(sh: Shapes, batch: int, seq: int) -> int:
    """Forward and backward (3 x the forward), the remat recompute not
    counted; the loss reads every position's logits."""
    fwd = (sh.layers * (2 * sh.layer_params_per_token * seq
                        + sh.attn_pair_flops() * causal_pairs(seq))
           + 2 * sh.d * sh.v * seq)
    return 3 * batch * fwd


def decode_bytes(sh: Shapes, contexts: Sequence[int],
                 experts_routed: Optional[Sequence[int]] = None) -> int:
    """HBM bytes a decode tick needs. ``experts_routed``: for an MoE
    model, how many distinct experts each layer's tokens route to (all of
    them when not given)."""
    b = len(contexts)
    weights = sh.layers * (sh.attn_params + 2 * sh.d) + sh.d * sh.v + sh.d
    if sh.e:
        routed = (list(experts_routed) if experts_routed is not None
                  else [sh.e] * sh.layers)
        weights += sum(routed) * sh.expert_params
        extra = sh.layers * sh.d * sh.e * 4            # f32 router
    else:
        weights += sh.layers * sh.expert_params
        extra = 0
    embed_rows = b * sh.d
    kv_rows = sum(c + 1 for c in contexts)
    kv = kv_rows * sh.layers * 2 * sh.kv * sh.hd
    return (weights + embed_rows + kv) * sh.item + extra


def _flash_bytes(b: int, s: int, h: int, kv: int, hd: int, item: int,
                 reads_q: int, reads_kv: int, writes_q: int, writes_kv: int,
                 lse: int) -> int:
    return (item * (b * s * h * hd * (reads_q + writes_q)
                    + b * s * kv * hd * (reads_kv + writes_kv))
            + 4 * b * h * s * lse)


def flash_call(kernel: str, b: int, s: int, h: int, kv: int, hd: int,
               item: int = 2):
    """(operations, bytes) of one causal call. K1 reads q, k, v and writes
    o and lse; K2 (dK, dV) reads q, k, v, dO, lse and D and writes dK and
    dV; K3 (dQ) reads the same and writes dQ."""
    pairs = b * causal_pairs(s) * h * hd
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
