"""Continuous-batching serving engine over the KV-cache decode path.

Counterpart of ``tpusched/jaxbridge/serve.py`` (its single-card path). A
fixed arena of ``slots`` sequences, (slots, max_seq) rows per layer, exact
or int8, decodes in lock-step; requests join and leave slots mid-flight. A joining request's prompt is padded to the
smallest prompt bucket that fits and prefilled alone through the configured
attention (the flash kernel for ``attn="flash"``); its K/V rows are written
into its slot in place, so resident slots are untouched and continuous
batching gives each request exactly the tokens it would get alone. With
``chunk_prefill=C`` the prompt instead streams in C rows per tick through
the decode step's cached attention, so a long prompt stalls resident slots
for one chunk a tick rather than a whole prefill; a chunked engine also
serves registered shared prefixes (``register_prefix``), whose K/V are
computed once and copied into each tenant's leading rows.

With ``draft_params``/``draft_cfg`` the engine decodes speculatively: a
draft arena mirrors every admission, each tick the draft proposes
``spec_k`` tokens per slot and the target verifies every slot's proposals
in one span, and acceptance is per slot on the host; greedy output equals
the plain engine's. ``request_keyed=True`` draws each token with its
request's key and absolute row (``decode.keyed_draw``, on the device, in
the decode tick), so a sampled request's tokens do not depend on its
neighbours; sampled speculation needs it.

With ``mesh`` the engine serves SPMD: every rank of the mesh builds the
same engine from the full weights (or its shards, as
``checkpoint.load_for_serving(mesh=)`` reads them), keeps its shard of
them by ``workload.param_specs`` and runs the same ``submit``/``tick``
sequence. tp splits the model and the arena (kv_heads/tp a rank), ep an
MoE layer's experts (E/ep a rank), fsdp every matrix's non-tp dim: the
engine gathers a layer's weights where it uses them (``decode``'s
``fsdp=``), an exact gather, so the ranks compute one card's logits, and
the arena is whole over fsdp. Every other axis (slice, dp, sp, pp) is a
replica: its ranks run the same program on the same inputs. Each host
decision (a sampled token, a speculative round's proposals and outcome)
is rank 0's of the model group (ep × tp), broadcast; fsdp and the
replica axes compute identical logits with identically seeded
generators, so their ranks decide alike with no broadcast.

Each step of the engine is a program, the counterpart of the reference's
jitted builders (``_build_decode_tick``, ``_build_prefill_slot`` a
prompt bucket, ``_build_prefill_chunk``, ``_build_prefix_kv`` a prefix
length and ``_build_prefix_insert`` a registered prefix,
``_build_draft_tick`` and ``_build_verify_span``, and the sampled round's
draft ingest, one-token draft step and verify span): a body over static
buffers with the arena written in place (:mod:`.program`). On the card
every engine captures each, at ``warmup()`` or at first use, and replays
it on every tick, admission, chunk, registration and round; the cursors
it takes stay on the card through the step. Over a mesh a program is a
chain of CUDA graphs broken at each collective its body makes (tp's and
ep's sums and gathers, fsdp's weight gathers), each collective run
between two replays on the tensor the capture recorded; the host
decisions still pass through ``_agree``, outside every program. A sampled
round is three programs, not one: its draws are made on the host in
float64 (``decode.keyed_categorical``), so the draft step is replayed
k - 1 times with a draw between replays. On the CPU the bodies run as
they are.

Pad keys land at positions >= the prompt's true length, which the causal
cursor masks until the decode step overwrites them. Idle slots decode
garbage at their stale cursor; the host discards it.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .decode import (KVCache, _adjusted_span_program, _keyed_proposals,
                     _score, adjusted_logits, as_int64, cache_update,
                     decode_step, draft_rollout, fold_in, init_kv_cache,
                     keyed_categorical, keyed_draw, prefill,
                     probs_from_adjusted, sample_token, score_span)
from . import tracing
from .mesh import MODEL_AXES, broadcast
from .program import Program
from .spec_decode import accept_span, round_uniforms
from .workload import (ModelConfig, Params, cast_params_for_compute,
                       check_mesh_axes, param_shapes, param_specs,
                       resolve_device, shard_leaf, shard_shape, tree_leaves,
                       tree_map)


@dataclasses.dataclass
class Request:
    """One generation request: at most ``max_new_tokens`` tokens, ended
    early by ``eos_token`` when set. With ``prefix_id`` (chunked engines
    only) ``prompt`` is the suffix after a prefix registered through
    ``ServeEngine.register_prefix``."""
    rid: int
    prompt: np.ndarray                  # (true_len,) int32
    max_new_tokens: int
    eos_token: Optional[int] = None
    prefix_id: Optional[str] = None


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: np.ndarray                  # generated tokens (<= max_new_tokens)
    prompt_len: int
    admitted_tick: int
    finished_tick: int


def _build_prefill_slot(params: Params, cache: KVCache, cfg: ModelConfig,
                        bucket: int, axes, program) -> Program:
    """The slot prefill of one prompt bucket: the padded prompt (bucket,),
    ``slot`` and ``true_len`` (device scalars) in; the next-token logits
    (vocab,) of the last real prompt position out, picked on the device.
    The prompt's K/V go into the slot's arena rows through a device index
    (int8 scale planes included); attention is the configured one, so the
    flash kernel runs inside the program."""
    device = cache[0]["k"].device
    prompt = torch.zeros(bucket, dtype=torch.long, device=device)
    slot = torch.zeros((), dtype=torch.long, device=device)
    true_len = torch.ones((), dtype=torch.long, device=device)

    def body():
        logits, _ = prefill(params, cache, prompt[None], cfg, *axes,
                            slot=slot)
        return logits[0].index_select(0, (true_len - 1).reshape(1))[0]

    return program(body, {"prompt": prompt, "slot": slot,
                          "true_len": true_len})


def _build_prefill_chunk(params: Params, cache: KVCache, cfg: ModelConfig,
                         chunk: int, axes, program) -> Program:
    """One chunk of one slot's prefill: ``chunk`` (chunk,) tokens, and
    ``slot``, ``off`` and ``last_row`` (device scalars) in; the logits
    (vocab,) of chunk row ``last_row``, clipped to [0, chunk - 1], out (the
    first token's on a prompt's last chunk, where it is true_len - 1 -
    off). The chunk's K/V go into the slot's rows [off, off + chunk) and
    its queries attend the slot's whole row space through the decode
    step's position mask (``decode._score``), so one program serves
    every chunk of every prompt length and prefix offset. No kernel runs,
    as no Pallas call runs in the reference's chunk program."""
    device = cache[0]["k"].device
    tokens = torch.zeros(chunk, dtype=torch.long, device=device)
    slot = torch.zeros((), dtype=torch.long, device=device)
    off = torch.zeros((), dtype=torch.long, device=device)
    last_row = torch.zeros((), dtype=torch.long, device=device)

    def body():
        logits = _score(params, cache, tokens[None], off, cfg, *axes,
                        slot=slot)
        return logits[0].index_select(
            0, last_row.clamp(0, chunk - 1).reshape(1))[0]

    return program(body, {"chunk": tokens, "slot": slot, "off": off,
                          "last_row": last_row})


def _build_prefix_kv(params: Params, cfg: ModelConfig, length: int, device,
                     axes, program) -> Program:
    """A shared prefix's K/V, one program a prefix length: ``tokens``
    (length,) in; every layer's K and V stacked, (layers, 2, 1, length,
    kv_heads, head_dim), out, through the configured attention (the flash
    kernel for attn="flash") at rotary positions 0..length-1, since a
    prefix always takes a slot's leading rows. The next registration of
    the same length overwrites the output: a registration keeps a copy."""
    tokens = torch.zeros(length, dtype=torch.long, device=device)
    kv = init_kv_cache(cfg, 1, length, device, axes[0])

    def body():
        prefill(params, kv, tokens[None], cfg, *axes)
        return torch.stack([torch.stack([c["k"], c["v"]]) for c in kv])

    return program(body, {"tokens": tokens})


def _build_prefix_insert(cache: KVCache, kv: KVCache, program) -> Program:
    """A registered prefix's K/V ``kv`` copied into rows [0, length) of the
    arena's batch row ``slot`` (a device scalar, the input): one graph
    launch for the 2 x layers writes. Exact arenas only, as chunking
    requires."""
    slot = torch.zeros((), dtype=torch.long, device=cache[0]["k"].device)

    def body():
        for c, entry in zip(cache, kv):
            cache_update(c, entry["k"], entry["v"], 0, slot)

    return program(body, {"slot": slot})


def _build_decode_tick(params: Params, cache: KVCache, cfg: ModelConfig,
                       slots: int, axes, program,
                       keyed: Optional[Tuple[float, int, float]] = None
                       ) -> Program:
    """One lock-step decode over the arena, ``decode.decode_step`` itself:
    ``tokens`` (slots,) and ``pos`` (slots,) in, logits (slots, vocab) out.
    Idle slots decode garbage at their stale cursor, as in the
    reference. With ``keyed`` (temperature, top_k, top_p) the tick also
    draws each slot's token on the device, the reference's
    ``_keyed_sample``: ``keys`` (slots,) int64 in (each tenant's key as
    ``decode.as_int64`` gives it), the token that will occupy row pos + 1
    drawn with (key, pos + 1) by ``decode.keyed_draw``, tokens (slots,)
    out."""
    device = cache[0]["k"].device
    tokens = torch.zeros(slots, dtype=torch.long, device=device)
    pos = torch.zeros(slots, dtype=torch.long, device=device)
    keys = torch.zeros(slots, dtype=torch.long, device=device)

    def body():
        logits = decode_step(params, cache, tokens, pos, cfg, *axes)[0]
        if keyed is None:
            return logits
        return keyed_draw(adjusted_logits(logits, *keyed), keys, pos + 1)

    inputs = {"tokens": tokens, "pos": pos}
    if keyed is not None:
        inputs["keys"] = keys
    return program(body, inputs)


def _build_draft_tick(params: Params, cache: KVCache, cfg: ModelConfig,
                      slots: int, k: int, axes, program) -> Program:
    """A greedy round's draft phase, ``decode.draft_rollout`` over the
    draft arena: ``feed2`` (slots, 2), each slot's tokens at rows pos - 1
    and pos, and ``pos`` (slots,) in; proposals (slots, k) out. All k
    draft steps are one program. ``pos`` starts at 1, the least cursor a
    round sends."""
    device = cache[0]["k"].device
    feed2 = torch.zeros((slots, 2), dtype=torch.long, device=device)
    pos = torch.ones(slots, dtype=torch.long, device=device)

    def body():
        return draft_rollout(params, cache, feed2, pos - 1, cfg, k, *axes)[0]

    return program(body, {"feed2": feed2, "pos": pos})


def _build_verify_span(params: Params, cache: KVCache, cfg: ModelConfig,
                       slots: int, k: int, axes, program) -> Program:
    """A greedy round's verification, ``decode.score_span`` over the
    target arena: ``scored`` (slots, k + 1), each slot's next token and
    proposals, and ``pos`` (slots,) in; the target's argmax (slots, k + 1)
    out."""
    device = cache[0]["k"].device
    scored = torch.zeros((slots, k + 1), dtype=torch.long, device=device)
    pos = torch.ones(slots, dtype=torch.long, device=device)

    def body():
        logits, _ = score_span(params, cache, scored, pos, cfg, *axes)
        return torch.argmax(logits, dim=-1)

    return program(body, {"scored": scored, "pos": pos})


def _own_shards(params: Params, cfg: ModelConfig, mesh) -> Params:
    """This rank's shards: ``params`` as given (moved to the mesh's device)
    when every leaf already has its shard's shape, as
    ``checkpoint.load_for_serving(mesh=)`` returns them, else each leaf of
    the full tree cut by ``param_specs`` (``workload.shard_leaf``, as
    ``shard_params`` cuts; a pp axis, which no spec names, leaves it
    whole). A leaf over an axis of size 1 has the same shape either way,
    and both readings give the same shards."""
    specs = param_specs(cfg, mesh)
    shapes = tree_leaves(tree_map(
        lambda x, whole, spec: tuple(x.shape) == shard_shape(whole, spec,
                                                             mesh),
        params, param_shapes(cfg), specs))
    if not all(shapes):
        return tree_map(lambda x, spec: shard_leaf(x, spec, mesh), params,
                        specs)
    return tree_map(lambda x: x.to(mesh.device or x.device), params)


class ServeEngine:
    """Continuous-batching engine: submit() requests, tick() until done.

    Greedy by default (temperature 0); temperature/top_k/top_p sample from
    one generator shared by the engine, seeded with ``seed``, or, with
    ``request_keyed``, with each request's key ``fold_in(seed, rid)`` (the
    int ``seed`` stands for the reference's ``PRNGKey(seed)``). With
    ``draft_params``/``draft_cfg`` every tick is a speculative round of
    ``spec_k`` proposals. Runs on the CUDA card unless ``device="cpu"``;
    ``params`` and ``draft_params`` must already be there. With ``mesh``
    (axes in slice, dp, fsdp, sp, pp, ep and tp; see the module docstring)
    it runs on ``mesh.device`` and takes the full weights from anywhere.

    Every step is a program (see the module docstring): captured on the
    card, as one CUDA graph or, over a mesh, a chain of them broken at
    each collective; run as it is on the CPU."""

    def __init__(self, params: Params, cfg: ModelConfig, *,
                 slots: int = 8, max_seq: int = 1024,
                 prompt_bucket: "int | Tuple[int, ...]" = 128,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int = 0,
                 request_keyed: bool = False, mesh=None,
                 chunk_prefill: Optional[int] = None,
                 draft_params: Optional[Params] = None,
                 draft_cfg: Optional[ModelConfig] = None,
                 spec_k: int = 4, device=None):
        if mesh is not None:
            check_mesh_axes(mesh, cfg, serving=True)
            if (device is not None and mesh.device is not None
                    and resolve_device(device) != mesh.device):
                raise ValueError(f"the mesh runs on {mesh.device}, not "
                                 f"{device}")
            device = mesh.device if mesh.device is not None else device
        self.device = resolve_device(device)
        for what, tree in (("params", params), ("draft_params", draft_params)):
            if (mesh is None and tree is not None
                    and tree["embed"].device != self.device):
                raise ValueError(f"{what} are on {tree['embed'].device}, "
                                 f"the engine runs on {self.device}")
        buckets = ((prompt_bucket,) if isinstance(prompt_bucket, int)
                   else tuple(sorted(set(prompt_bucket))))
        if not buckets or buckets[-1] >= max_seq:
            raise ValueError("prompt buckets must be non-empty and leave "
                             "generation room under max_seq")
        if cfg.kv_cache_dtype is not None and chunk_prefill is not None:
            # a chunk's queries would attend earlier chunks through the
            # dequantized cache where monolithic prefill and solo generate
            # attend fresh values: the tokens could differ
            raise ValueError(
                "int8 KV arena composes with monolithic admission only: "
                "chunked prefill would attend dequantized history where "
                "monolithic attends fresh values, breaking result parity "
                "(kv_cache_dtype=None for chunk_prefill/prefix caching)")
        # every token draws (fold_in(seed, rid), its row): a request's
        # sampled stream equals decode.sample_position_keyed run alone with
        # that key, whatever its neighbours. Needs distinct in-flight rids
        self.request_keyed = bool(request_keyed)
        if self.request_keyed and temperature == 0.0:
            raise ValueError("request_keyed sampling needs temperature > 0 "
                             "(greedy consumes no randomness)")
        self._tp = mesh.tp if mesh is not None else None
        self._ep = mesh.ep if mesh is not None else None
        self._fsdp = mesh.fsdp if mesh is not None else None
        self._model = mesh.axis(MODEL_AXES) if mesh is not None else None
        tp = self._tp.size if self._tp is not None else 1
        if mesh is not None:
            if cfg.kv_heads % tp:
                raise ValueError(
                    f"kv_heads {cfg.kv_heads} not divisible by tp {tp}")
            if cfg.vocab_parallel_loss:
                raise ValueError("serving samples over full logits; use a "
                                 "cfg with vocab_parallel_loss=False")
        if draft_params is None and draft_cfg is not None:
            raise ValueError("draft_cfg without draft_params: the engine "
                             "would silently run plain, not speculative")
        if draft_params is not None:
            if draft_cfg is None:
                raise ValueError("draft_params requires draft_cfg")
            if draft_cfg.vocab != cfg.vocab:
                raise ValueError("draft and target must share a vocabulary")
            if temperature != 0.0 and not self.request_keyed:
                raise ValueError(
                    "sampled speculative serving requires "
                    "request_keyed=True: the accept/residual randomness "
                    "must be position-stable per request or the "
                    "distribution-preservation law cannot hold "
                    "(temperature=0 runs greedy verification)")
            if chunk_prefill is not None:
                raise ValueError("speculative serving composes with "
                                 "monolithic admission only (no "
                                 "chunk_prefill) in this version; a "
                                 "tensor-parallel mesh is supported")
            if spec_k < 1:
                raise ValueError("spec_k must be >= 1")
            # a verify span writes spec_k + 1 rows past the last accepted
            # one, and warmup submits each bucket full length (the smallest
            # with 2 new tokens, the rest with 1): refuse a geometry in
            # which those could never be admitted
            if (buckets[0] + spec_k + 3 > max_seq
                    or buckets[-1] + spec_k + 2 > max_seq):
                raise ValueError(
                    f"speculative geometry: prompt buckets {buckets} with "
                    f"spec_k {spec_k} leave no room under max_seq "
                    f"{max_seq} (need smallest bucket + spec_k + 3 and "
                    f"largest bucket + spec_k + 2 within the arena); "
                    f"warmup and full-bucket requests could never be "
                    f"admitted")
            if draft_cfg.kv_cache_dtype is not None:
                raise ValueError("draft cache must be exact")
            if mesh is not None and draft_cfg.kv_heads % tp:
                raise ValueError(
                    f"draft kv_heads {draft_cfg.kv_heads} not "
                    f"divisible by tp {tp}")
        if chunk_prefill is not None:
            if chunk_prefill < 1:
                raise ValueError("chunk_prefill must be >= 1")
            # every chunk writes a full chunk_prefill-row extent; the
            # longest prompt's last chunk must still fit the arena
            worst = -(-buckets[-1] // chunk_prefill) * chunk_prefill
            if worst > max_seq:
                raise ValueError(
                    f"chunk_prefill={chunk_prefill}: a {buckets[-1]}-token "
                    f"prompt's chunk-aligned writes span {worst} rows > "
                    f"max_seq {max_seq}")
        if mesh is not None:
            params = _own_shards(params, cfg, mesh)
            if draft_params is not None:
                draft_params = _own_shards(draft_params, draft_cfg, mesh)
        self.params = params
        self.cfg = cfg
        # the programs take weights in the compute dtype, cast once here: a
        # cast inside a captured step would copy every weight each replay
        self._weights = cast_params_for_compute(params, cfg)
        self._draft_weights = (cast_params_for_compute(draft_params,
                                                       draft_cfg)
                               if draft_params is not None else None)
        # graphs on the card, over a mesh too (chains broken at each
        # collective), bodies on the CPU; chip_smoke.py sets it False on a
        # card engine to drain through the bodies
        self._graphs = self.device.type == "cuda"
        self._programs: Dict[tuple, Program] = {}
        self._pool = None
        self.slots = slots
        self.max_seq = max_seq
        self.prompt_buckets = buckets
        self.prompt_bucket = buckets[-1]   # largest (admission bound)
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.chunk_prefill = chunk_prefill
        # registered shared prefixes: id -> {"len", "kv", "insert"}, the
        # insert program built at the entry's first admission
        self._prefixes: Dict[str, dict] = {}
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self._key = int(seed)
        # each slot's tenant key; an idle slot's placeholder draws are
        # discarded
        self.slot_key = [fold_in(self._key, (1 << 31) + s)
                         for s in range(slots)]
        self.cache = init_kv_cache(cfg, slots, max_seq, self.device, self._tp)
        self.draft_params = draft_params
        self.draft_cfg = draft_cfg
        self.spec_k = spec_k
        self.spec_stats = {"rounds": 0, "drafted": 0, "accepted": 0}
        if draft_params is not None:
            self.draft_cache = init_kv_cache(draft_cfg, slots, max_seq,
                                             self.device, self._tp)
        # host-side slot state
        self.pos = np.zeros(slots, dtype=np.int64)       # next write position
        self.next_tok = np.zeros(slots, dtype=np.int64)  # last sampled token
        self.prev_tok = np.zeros(slots, dtype=np.int64)  # token at pos-1 (fed)
        self.req: List[Optional[Request]] = [None] * slots
        # the prompt row a chunk-prefilling slot streams in next; None once
        # its prompt is resident (always None under monolithic admission)
        self.prefill_off: List[Optional[int]] = [None] * slots
        self.slot_prefix = np.zeros(slots, dtype=np.int64)  # tenant prefix len
        self.generated: List[List[int]] = [[] for _ in range(slots)]
        self.admitted_at = np.zeros(slots, dtype=np.int64)
        # (request, its prefix entry, when it was queued on the host clock)
        self.queue: List[Tuple[Request, Optional[dict], int]] = []
        self.completions: List[Completion] = []
        self.tick_count = 0
        self.decode_tokens = 0          # real (non-idle) tokens decoded
        # monolithic slot prefills run (each through the configured
        # attention), warmup included; chunked admission runs none. The
        # draft arena's: one per admission that did not finish at once
        self.prefills = 0
        self.draft_prefills = 0

    # -- submission -----------------------------------------------------------

    @torch.no_grad()
    def register_prefix(self, prefix_id: str, tokens: np.ndarray) -> None:
        """Compute a shared prefix's K/V once (a system prompt): requests
        submitted with this ``prefix_id`` get the rows copied into their
        slot and prefill only their suffix. Chunked engines only: the
        suffix streams in from the prefix boundary."""
        if self.chunk_prefill is None:
            raise ValueError("prefix caching requires chunk_prefill")
        p = int(len(tokens))
        # the least admissible request is a 1-token suffix (one chunk extent
        # past the prefix) that generates 1 token
        if p < 1 or p + max(self.chunk_prefill, 2) > self.max_seq:
            raise ValueError("prefix must leave room for a chunk-aligned "
                             "suffix and generation under max_seq")
        # one program a prefix length, as the reference compiles one; its
        # output is the program's, so the entry keeps its own copy. Exact:
        # the engine refuses int8 with chunking
        kv = self._program(("prefix", p))(
            tokens=np.asarray(tokens, dtype=np.int64)).clone()
        self._prefixes[prefix_id] = {
            "len": p, "kv": [{"k": x[0], "v": x[1]} for x in kv],
            "insert": None}

    def submit(self, req: Request) -> None:
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (prefill always "
                             "samples the first token)")
        if self.request_keyed:
            # the rid IS the request's randomness: two in flight would
            # emit fully correlated streams
            in_flight = ({r.rid for r, *_ in self.queue}
                         | {r.rid for r in self.req if r is not None})
            if req.rid in in_flight:
                raise ValueError(
                    f"request_keyed sampling requires distinct rids; "
                    f"{req.rid} is already in flight (its stream would be "
                    f"identical)")
        if self.draft_params is not None:
            if len(req.prompt) < 1:
                raise ValueError("speculative serving needs a non-empty "
                                 "prompt (the catch-up feed anchors on its "
                                 "last token)")
            if (len(req.prompt) + req.max_new_tokens + self.spec_k + 1
                    > self.max_seq):
                # the last round's verify span writes up to spec_k+1 rows
                # past the last accepted row: without this headroom the
                # write would run off the arena
                raise ValueError(
                    "prompt + max_new_tokens + spec_k + 1 exceeds max_seq "
                    "(speculative rounds overshoot by up to spec_k+1 rows)")
        prefix_len, entry = 0, None
        if req.prefix_id is not None:
            if self.chunk_prefill is None:
                raise ValueError("prefix_id requires a chunked engine")
            entry = self._prefixes.get(req.prefix_id)
            if entry is None:
                raise ValueError(f"unknown prefix_id {req.prefix_id!r}")
            if len(req.prompt) < 1:
                raise ValueError("prefix requests need a non-empty suffix "
                                 "(first-token logits come from its last "
                                 "real row)")
            prefix_len = entry["len"]
        if len(req.prompt) < 1:
            raise ValueError("prompt must hold at least one token")
        if len(req.prompt) > self.prompt_bucket:
            raise ValueError(
                f"prompt len {len(req.prompt)} > bucket {self.prompt_bucket}")
        if prefix_len + len(req.prompt) + req.max_new_tokens > self.max_seq:
            # keeps every in-place cache write inside the arena
            raise ValueError("prompt + max_new_tokens exceeds max_seq")
        if self.chunk_prefill is not None:
            # the suffix's last chunk writes a full chunk extent
            C = self.chunk_prefill
            span = prefix_len + -(-len(req.prompt) // C) * C
            if span > self.max_seq:
                raise ValueError(
                    f"chunk-aligned prompt span {span} exceeds max_seq "
                    f"{self.max_seq}")
        # the resolved prefix entry rides with the request: registering the
        # id again later leaves a queued request as it was validated
        self.queue.append((req, entry, tracing.now()))

    @torch.no_grad()
    def warmup(self) -> None:
        """Requests through the real path, then every program the engine
        runs captured (the counterpart of the reference's compile), then
        the metric counters reset: monolithic, one full-length request per
        bucket (the first generates 2 tokens so the decode tick runs too);
        chunked, one full-bucket request that generates 2. ``prefills`` is
        not reset: it counts every prefill the engine ran."""
        if self.chunk_prefill is not None:
            # one chunk program serves every bucket and chunk offset
            warm = [(self.prompt_bucket, 2)]
        else:
            warm = [(bucket, 2 if i == 0 else 1)
                    for i, bucket in enumerate(self.prompt_buckets)]
        for bucket, new_tokens in warm:
            self.submit(Request(rid=-1,
                                prompt=np.zeros(bucket, dtype=np.int32),
                                max_new_tokens=min(new_tokens,
                                                   self.max_seq - bucket)))
            self.run_until_drained()
        # the reference compiles every program here: capture the ones the
        # requests left out (a bucket's draft prefill, the round's programs
        # of a draft engine); the arena is idle, so their warm-up writes are
        # never read
        for key in self._program_keys():
            self._program(key).capture()
        self.completions.clear()
        self.tick_count = 0
        self.decode_tokens = 0
        self.spec_stats = {"rounds": 0, "drafted": 0, "accepted": 0}

    # -- programs -------------------------------------------------------------

    def _program_keys(self) -> List[tuple]:
        """Every program this engine's configuration runs but the prefix
        programs, which take a registered prefix's length or its K/V."""
        keys: List[tuple] = []
        if self.chunk_prefill is None:
            keys += [("prefill", b, False) for b in self.prompt_buckets]
        else:
            keys.append(("chunk",))
        if self.draft_params is None:
            return keys + [("decode",)]
        keys += [("prefill", b, True) for b in self.prompt_buckets]
        if self.temperature == 0.0:
            keys += [("draft",), ("verify",)]
        else:
            keys += [("draft_ingest",), ("draft_step",), ("verify_sampled",)]
        return keys

    def _new_program(self, body, inputs) -> Program:
        """A program of this engine: on the card all of them share one
        graph memory pool."""
        if self._graphs and self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return Program(body, inputs, graphed=self._graphs, pool=self._pool)

    def _program(self, key: tuple) -> Program:
        """The program ``key`` (``_program_keys``, or ("prefix", length)),
        built at first use."""
        prog = self._programs.get(key)
        if prog is not None:
            return prog
        program = self._new_program
        axes = (self._tp, self._ep, self._fsdp)
        sampling = (self.temperature, self.top_k, self.top_p)
        if key[0] == "prefill":
            _, bucket, draft = key
            prog = _build_prefill_slot(
                self._draft_weights if draft else self._weights,
                self.draft_cache if draft else self.cache,
                self.draft_cfg if draft else self.cfg, bucket, axes, program)
        elif key[0] == "chunk":
            prog = _build_prefill_chunk(self._weights, self.cache, self.cfg,
                                        self.chunk_prefill, axes, program)
        elif key[0] == "prefix":
            prog = _build_prefix_kv(self._weights, self.cfg, key[1],
                                    self.device, axes, program)
        elif key[0] == "decode":
            prog = _build_decode_tick(self._weights, self.cache, self.cfg,
                                      self.slots, axes, program,
                                      sampling if self.request_keyed
                                      else None)
        elif key[0] == "draft":
            prog = _build_draft_tick(self._draft_weights, self.draft_cache,
                                     self.draft_cfg, self.slots, self.spec_k,
                                     axes, program)
        elif key[0] == "verify":
            prog = _build_verify_span(self._weights, self.cache, self.cfg,
                                      self.slots, self.spec_k, axes, program)
        elif key[0] in ("draft_ingest", "draft_step"):
            # the ingest: each slot's uniform 2-row feed from row pos - 1;
            # the step: one proposal at its row
            width = 2 if key[0] == "draft_ingest" else 1
            prog = _adjusted_span_program(
                self._draft_weights, self.draft_cache, self.draft_cfg,
                (self.slots, width), sampling, program, axes)
        else:
            prog = _adjusted_span_program(
                self._weights, self.cache, self.cfg,
                (self.slots, self.spec_k + 1), sampling, program, axes,
                last=False)
        self._programs[key] = prog
        return prog

    def _prefix_insert(self, entry: dict) -> Program:
        """A registered prefix's insert program, which belongs to its entry
        (a queued request keeps the entry it was submitted with), built at
        the entry's first admission and captured there with that
        admission's slot as its input: the capture's warm-up then writes
        the rows the replay writes, in a slot no tenant reads."""
        if entry["insert"] is None:
            entry["insert"] = _build_prefix_insert(self.cache, entry["kv"],
                                                   self._new_program)
        return entry["insert"]

    # -- engine loop ----------------------------------------------------------

    def _admit(self) -> None:
        for slot in range(self.slots):
            if self.req[slot] is not None or not self.queue:
                continue
            req, prefix, queued_at = self.queue.pop(0)
            tracing.record("serve.queued", queued_at, tracing.now(), req.rid)
            self.req[slot] = req
            self.admitted_at[slot] = self.tick_count
            if self.chunk_prefill is not None:
                # claim the slot; tick() streams the prompt in. The decode
                # step still runs this slot meanwhile: its cursor is parked
                # at the prompt's end, the one row every chunk's mask hides
                # and the first real decode step overwrites
                p = 0
                if prefix is not None:
                    p = prefix["len"]
                    self._prefix_insert(prefix)(slot=slot)
                self.slot_prefix[slot] = p
                self.prefill_off[slot] = p
                self.pos[slot] = p + len(req.prompt)
                continue
            true_len = len(req.prompt)
            bucket = next(b for b in self.prompt_buckets if b >= true_len)
            padded = np.zeros(bucket, dtype=np.int64)
            padded[:true_len] = req.prompt
            sid = tracing.begin("serve.admit", req.rid, slot, bucket,
                                true_len)
            first_logits = self._program(("prefill", bucket, False))(
                prompt=padded, slot=slot, true_len=true_len)
            self.prefills += 1
            tok = self._first_token(req.rid, first_logits, true_len, slot)
            tracing.end(sid)
            self.slot_prefix[slot] = 0
            self.pos[slot] = true_len
            self.prev_tok[slot] = int(req.prompt[-1])
            self.next_tok[slot] = tok
            self.generated[slot] = [tok]
            self._maybe_finish(slot)
            if self.draft_params is not None and self.req[slot] is not None:
                # the draft arena mirrors the admission only after the
                # finish check: a request done at admission never reaches a
                # speculative round
                self._program(("prefill", bucket, True))(
                    prompt=padded, slot=slot, true_len=true_len)
                self.draft_prefills += 1

    def _advance_prefills(self) -> None:
        """One chunk per prefilling slot. The final chunk's last real row
        gives the first sampled token and turns the slot to decoding."""
        C = self.chunk_prefill
        program = self._program(("chunk",))
        for slot in range(self.slots):
            off = self.prefill_off[slot]
            if off is None:
                continue
            req = self.req[slot]
            p = int(self.slot_prefix[slot])        # the suffix starts at row p
            true_len = p + len(req.prompt)
            n = min(C, true_len - off)
            chunk = np.zeros(C, dtype=np.int64)
            chunk[:n] = req.prompt[off - p:off - p + n]
            # rows [off, off+C) of the slot; the logits of the prompt's
            # last row, read before the next chunk's replay overwrites them
            next_logits = program(chunk=chunk, slot=slot, off=off,
                                  last_row=true_len - 1 - off)
            off += n
            if off < true_len:
                self.prefill_off[slot] = off
                continue
            self.prefill_off[slot] = None          # the prompt is resident
            tok = self._first_token(req.rid, next_logits, true_len, slot)
            self.next_tok[slot] = tok
            self.generated[slot] = [tok]
            self._maybe_finish(slot)

    def _agree(self, x):
        """Under ep or tp, the model group's rank 0's ``x`` on every rank: a
        device tensor is broadcast in place, a host array comes back as
        int64. Every host decision of a tick passes through here, so the
        ranks' engines never diverge."""
        if self._model is None or self._model.size == 1:
            return x
        if isinstance(x, torch.Tensor):
            return broadcast(x, self._model)
        t = torch.as_tensor(np.asarray(x, dtype=np.int64), device=self.device)
        return broadcast(t, self._model).cpu().numpy()

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        return self._agree(sample_token(logits, self.generator,
                                        self.temperature, self.top_k,
                                        self.top_p)).cpu().numpy()

    def _first_token(self, rid: int, logits_row: torch.Tensor, row: int,
                     slot: int) -> int:
        """A slot's first generated token, which occupies absolute ``row``,
        drawn inside a ``serve.sample`` span. A request-keyed draw binds the
        tenant's key to the slot here."""
        sid = tracing.begin("serve.sample")
        if self.request_keyed:
            self.slot_key[slot] = fold_in(self._key, rid)
            keys, rows = (torch.full((1,), x, dtype=torch.long,
                                     device=self.device)
                          for x in (as_int64(self.slot_key[slot]), row))
            tok = int(self._agree(keyed_draw(adjusted_logits(
                logits_row[None, :], self.temperature, self.top_k,
                self.top_p), keys, rows))[0])
        else:
            tok = int(self._sample(logits_row[None, :])[0])
        tracing.end(sid)
        return tok

    def _maybe_finish(self, slot: int) -> None:
        req = self.req[slot]
        gen = self.generated[slot]
        done = len(gen) >= req.max_new_tokens or (
            req.eos_token is not None and gen and gen[-1] == req.eos_token)
        if not done:
            return
        self.completions.append(Completion(
            rid=req.rid, tokens=np.asarray(gen, dtype=np.int32),
            prompt_len=int(self.slot_prefix[slot]) + len(req.prompt),
            admitted_tick=int(self.admitted_at[slot]),
            finished_tick=self.tick_count))
        self.req[slot] = None
        self.generated[slot] = []

    def _round_positions(self) -> np.ndarray:
        """The cursors a speculative round sends to the device, on the
        host. A never-used slot sits at pos 0, and its draft feed would land
        on row -1, which advanced indexing takes as the arena's LAST row
        (the reference clamps); so the device sees max(pos, 1), and
        ``self.pos`` is unchanged. Every row a round writes (pos - 1 ..
        pos + spec_k) is checked on the host to lie in the arena before
        anything is copied to the device."""
        pos = np.maximum(self.pos, 1)
        if (pos + self.spec_k + 1 > self.max_seq).any():
            raise RuntimeError(f"speculative round would write past the "
                               f"arena: cursors {pos.tolist()}, spec_k "
                               f"{self.spec_k}, max_seq {self.max_seq}")
        return pos

    def _count_round(self) -> None:
        # before the slots are booked, so a completion's finished_tick is
        # this tick, as in the plain tick
        self.tick_count += 1
        self.spec_stats["rounds"] += 1

    def _emit(self, s: int, span, n_ok: int, emitted: List[int]) -> None:
        """Book one slot's round: append its emitted tokens up to its end,
        and otherwise move its cursors through the accepted rows only; the
        emitted correction (or bonus) is the next unfed token. Leftover
        span rows are garbage that the next write overwrites before any
        query attends it."""
        self.spec_stats["drafted"] += self.spec_k
        self.spec_stats["accepted"] += n_ok
        req = self.req[s]
        for tok in emitted:
            self.generated[s].append(tok)
            self.decode_tokens += 1
            if (len(self.generated[s]) >= req.max_new_tokens
                    or (req.eos_token is not None and tok == req.eos_token)):
                self._maybe_finish(s)
                return
        self.prev_tok[s] = (int(span[n_ok - 1]) if n_ok >= 1
                            else int(self.next_tok[s]))
        self.next_tok[s] = emitted[-1]
        self.pos[s] += n_ok + 1

    def _tick_speculative(self, active: List[int]) -> None:
        """One greedy speculative round over the whole arena: the draft
        ingests each slot's uniform 2-row feed (prev_tok, next_tok) at
        pos - 1 (re-feeding an ingested token rewrites identical K/V) and
        proposes spec_k tokens; the target scores next_tok and the
        proposals, spec_k + 1 rows, in one span; each slot keeps its
        proposals while they equal the target's argmax. Two reads to the
        host: the proposals and the target's argmax. The draft's k steps are
        one program and the span another (``_build_draft_tick``,
        ``_build_verify_span``)."""
        k = self.spec_k
        pos = self._round_positions()
        proposals = self._agree(self._program(("draft",))(
            feed2=np.stack([self.prev_tok, self.next_tok], axis=1),
            pos=pos)).cpu().numpy()                          # (slots, k)
        scored = np.concatenate([self.next_tok[:, None], proposals], axis=1)
        t_arg = self._agree(self._program(("verify",))(
            scored=scored, pos=pos)).cpu().numpy()
        self._count_round()
        for s in active:
            span = proposals[s]
            n_ok = 0
            while n_ok < k and int(span[n_ok]) == int(t_arg[s, n_ok]):
                n_ok += 1
            self._emit(s, span, n_ok,
                       [int(t) for t in span[:n_ok]] + [int(t_arg[s, n_ok])])

    def _tick_speculative_sampled(self, active: List[int]) -> None:
        """The sampled sibling (request-keyed only): the draft samples each
        slot's proposals with its key and rows; the target's span returns
        adjusted logits, whose float64 distributions the host divides by
        the draft's in ``spec_decode.accept_span``, with the round's
        acceptance and residual uniforms and the bonus at row pos + k + 1
        drawn from the slot's key. Each request's tokens equal solo
        ``spec_decode.speculative_sample`` with its key. Three programs: the
        draft ingests each slot's 2-row feed at pos - 1, its one-token step
        is replayed k - 1 times with the host's draws between, and the
        verify span returns the adjusted logits; k + 1 reads to the host,
        one a draw and one for the span."""
        k = self.spec_k
        pos = self._round_positions()
        step = self._program(("draft_step",))
        proposals, p_mat = _keyed_proposals(
            self._program(("draft_ingest",))(
                tokens=np.stack([self.prev_tok, self.next_tok], axis=1),
                pos=pos - 1),
            lambda tok, i: step(tokens=tok[:, None], pos=pos + 1 + i),
            self.slot_key, pos + 1, k)
        proposals = self._agree(proposals)
        scored = np.concatenate([self.next_tok[:, None], proposals], axis=1)
        adj = self._program(("verify_sampled",))(
            tokens=scored, pos=pos).cpu().numpy()          # (slots, k+1, V)
        self._count_round()
        # per slot: n_ok, then the emitted tokens (-1 past their end)
        outcome = np.full((self.slots, k + 2), -1, dtype=np.int64)
        for s in active:
            key, span = self.slot_key[s], proposals[s]
            n_ok, rejection = accept_span(
                span, p_mat[s], probs_from_adjusted(adj[s, :k]),
                *round_uniforms(key, int(pos[s]), k))
            if rejection is None:
                emitted = [int(t) for t in span] + [keyed_categorical(
                    adj[s, k], key, int(pos[s]) + k + 1)]
            else:
                emitted = [int(t) for t in span[:n_ok]] + [rejection]
            outcome[s, 0] = n_ok
            outcome[s, 1:1 + len(emitted)] = emitted
        outcome = self._agree(outcome)
        for s in active:
            emitted = [int(t) for t in outcome[s, 1:] if t >= 0]
            self._emit(s, proposals[s], int(outcome[s, 0]), emitted)

    @torch.no_grad()
    def tick(self) -> int:
        """Admit waiting requests into free slots, advance each chunked
        prefill by one chunk, then one decode step over the arena, or, with
        a draft, one speculative round (which emits 1 to spec_k + 1 tokens
        a slot). Returns the number of active (decoding) slots, 0 for an
        idle tick. The whole tick is a ``serve.tick`` span; each admission,
        the decode program's stage and replay, the tokens' read-back and
        draw, and the booking are spans inside it."""
        sid = tracing.begin("serve.tick", self.tick_count)
        try:
            active = self._tick()
            tracing.note(sid, 1, active)
        finally:
            tracing.end(sid)
        return active

    def _tick(self) -> int:
        self._admit()
        if self.chunk_prefill is not None:
            self._advance_prefills()
        active = [s for s in range(self.slots)
                  if self.req[s] is not None and self.prefill_off[s] is None]
        if not active:
            self.tick_count += 1
            return 0
        if self.draft_params is not None:
            if self.temperature != 0.0:
                self._tick_speculative_sampled(active)
            else:
                self._tick_speculative(active)
            return len(active)
        # one lock-step decode over the whole arena, idle slots included
        if self.request_keyed:
            # the tick draws on the device: the token drawn now occupies
            # row pos + 1 of its slot, the row the solo position-keyed
            # sampler keys; an idle slot's draw is discarded
            out = self._program(("decode",))(
                tokens=self.next_tok, pos=self.pos,
                keys=[as_int64(k) for k in self.slot_key])
            sid = tracing.begin("serve.sample")
            toks = self._agree(out).cpu().numpy()
        else:
            logits = self._program(("decode",))(tokens=self.next_tok,
                                                pos=self.pos)
            sid = tracing.begin("serve.sample")
            toks = self._sample(logits)
        tracing.end(sid)
        self.tick_count += 1
        sid = tracing.begin("serve.book")
        done = len(self.completions)
        for s in active:
            self.pos[s] += 1
            self.next_tok[s] = toks[s]
            self.generated[s].append(int(toks[s]))
            self.decode_tokens += 1
            self._maybe_finish(s)
        tracing.note(sid, 0, len(self.completions) - done)
        tracing.end(sid)
        return len(active)

    def run_until_drained(self, max_ticks: int = 100_000,
                          on_tick: Optional[Callable[[], None]] = None
                          ) -> List[Completion]:
        """Tick until every submitted request completed. Returns completions
        in finish order; ``on_tick`` runs after every tick."""
        while self.queue or any(r is not None for r in self.req):
            self.tick()
            if on_tick is not None:
                on_tick()
            if self.tick_count >= max_ticks:
                raise RuntimeError("serve engine did not drain (cap hit)")
        return self.completions


def _tick_sync(eng: ServeEngine) -> Callable[[], None]:
    """What ends a measured tick: ``torch.cuda.synchronize()`` on the card,
    so each tick pays for its own work (a tick in which every slot is
    chunk-prefilling samples nothing and would not wait otherwise)."""
    return (torch.cuda.synchronize if eng.device.type == "cuda"
            else (lambda: None))


def measure_serving(cfg: ModelConfig, params: Params, requests: List[Request],
                    *, slots: int = 8, max_seq: int = 1024,
                    prompt_bucket: "int | Tuple[int, ...]" = 128,
                    chunk_prefill: Optional[int] = None,
                    draft_params: Optional[Params] = None,
                    draft_cfg: Optional[ModelConfig] = None,
                    spec_k: int = 4, reporter=None,
                    device=None) -> Dict[str, float]:
    """Serve ``requests`` on a warmed engine: tokens/s, occupancy (real
    tokens per slot-tick), ticks, the largest gap between ticks (the
    head-of-line stall an admission inflicts on residents: a whole prompt's
    prefill under monolithic admission, one chunk and the decode step under
    ``chunk_prefill``), and the monolithic slot prefills the engine ran,
    warmup included. With a draft, every tick is a speculative round and
    the result adds ``spec_rounds``, ``spec_drafted``, ``spec_accepted``
    and the draft arena's ``draft_prefills``. On the card every tick ends
    in ``torch.cuda.synchronize()``. ``reporter`` (a
    ``measure.GoodputReporter``) gets the measured window as one report at
    per-tick scale: step ``ticks``, tick time and tokens both per tick, so
    its throughput is the window's tokens/s."""
    eng = ServeEngine(params, cfg, slots=slots, max_seq=max_seq,
                      prompt_bucket=prompt_bucket,
                      chunk_prefill=chunk_prefill, draft_params=draft_params,
                      draft_cfg=draft_cfg, spec_k=spec_k, device=device)
    sync = _tick_sync(eng)
    eng.warmup()
    for r in requests:
        eng.submit(r)
    sync()
    t0 = time.perf_counter()
    state = {"last": t0, "max_gap": 0.0}

    def stamp():
        sync()
        now = time.perf_counter()
        state["max_gap"] = max(state["max_gap"], now - state["last"])
        state["last"] = now

    completions = eng.run_until_drained(on_tick=stamp)
    elapsed = time.perf_counter() - t0
    total_tokens = sum(len(c.tokens) for c in completions)
    ticks = max(1, eng.tick_count)
    out = {
        "tokens": float(total_tokens),
        "elapsed_s": elapsed,
        "tokens_per_s": total_tokens / max(elapsed, 1e-9),
        "occupancy": eng.decode_tokens / (ticks * slots),
        "ticks": float(ticks),
        "max_tick_gap_s": state["max_gap"],
        "prefills": float(eng.prefills),
    }
    if draft_params is not None:
        out.update({f"spec_{k}": float(v) for k, v in eng.spec_stats.items()})
        out["draft_prefills"] = float(eng.draft_prefills)
    if reporter is not None:
        # per-tick scale: the window's tokens against one tick's time would
        # inflate the rate by the tick count
        reporter.observe_step(ticks, elapsed / ticks,
                              items=float(total_tokens) / ticks)
        reporter.flush()
    return out


def _pctl(xs: List[float], q: float) -> float:
    ys = sorted(xs)
    return ys[min(len(ys) - 1, int(round(q * (len(ys) - 1))))] if ys else 0.0


def measure_serving_slo(cfg: ModelConfig, params: Params,
                        requests: List[Request],
                        arrival_ticks: List[int], *,
                        slots: int = 8, max_seq: int = 1024,
                        prompt_bucket: "int | Tuple[int, ...]" = 128,
                        chunk_prefill: Optional[int] = None,
                        prefix_tokens: Optional[np.ndarray] = None,
                        ttft_slo_ticks: Optional[int] = None,
                        reporter=None, device=None) -> Dict[str, float]:
    """Serving statistics under arrivals by tick: each request is submitted
    at the first tick >= its ``arrival_ticks`` entry, and its time to first
    token (TTFT) runs from its submission to the tick that gave it a token.

    Ticks (``ttft_ticks_p50``/``_p99``, ``ticks``, ``tokens_per_tick`` and,
    with ``ttft_slo_ticks``, ``slo_attainment`` and
    ``goodput_tokens_per_tick``) depend only on the geometry when no
    request has an EOS token; seconds (``ttft_s_*``, ``per_token_s``,
    ``tokens_per_s``, ``goodput_tokens_per_s``) are wall time, each tick
    ending in ``torch.cuda.synchronize()`` on the card. ``prefix_tokens``
    registers a shared prefix (chunked engines only) that every request's
    prompt follows. Goodput counts the tokens of requests whose tick TTFT
    is within ``ttft_slo_ticks``. ``reporter`` gets the window as
    :func:`measure_serving` reports it, then ``ttft_s_p50`` as its TTFT."""
    eng = ServeEngine(params, cfg, slots=slots, max_seq=max_seq,
                      prompt_bucket=prompt_bucket,
                      chunk_prefill=chunk_prefill, device=device)
    sync = _tick_sync(eng)
    eng.warmup()
    prefix_id = None
    if prefix_tokens is not None:
        prefix_id = "slo-shared-prefix"
        eng.register_prefix(prefix_id, prefix_tokens)
    order = sorted(zip(arrival_ticks, range(len(requests))))
    pending = collections.deque((t, requests[i]) for t, i in order)
    submit_tick: Dict[int, int] = {}
    submit_wall: Dict[int, float] = {}
    first_tick: Dict[int, int] = {}
    first_wall: Dict[int, float] = {}
    sync()
    t0 = time.perf_counter()
    while pending or eng.queue or any(r is not None for r in eng.req):
        while pending and pending[0][0] <= eng.tick_count:
            _, req = pending.popleft()
            if prefix_id is not None:
                req = dataclasses.replace(req, prefix_id=prefix_id)
            eng.submit(req)
            submit_tick[req.rid] = eng.tick_count
            submit_wall[req.rid] = time.perf_counter()
        eng.tick()
        sync()
        now = time.perf_counter()
        for s in range(eng.slots):
            req = eng.req[s]
            if (req is not None and req.rid not in first_tick
                    and eng.generated[s]):
                first_tick[req.rid] = eng.tick_count
                first_wall[req.rid] = now
        for c in eng.completions:
            # a request that finishes in its admission tick has left its
            # slot before the scan above
            if c.rid not in first_tick:
                first_tick[c.rid] = eng.tick_count
                first_wall[c.rid] = now
        if eng.tick_count > 100_000:
            raise RuntimeError("serving SLO harness did not drain")
    elapsed = time.perf_counter() - t0
    completions = eng.completions
    total_tokens = sum(len(c.tokens) for c in completions)
    ttft_ticks = [first_tick[r.rid] - submit_tick[r.rid] for r in requests]
    ttft_s = [first_wall[r.rid] - submit_wall[r.rid] for r in requests]
    out = {
        "ttft_ticks_p50": _pctl(ttft_ticks, 0.50),
        "ttft_ticks_p99": _pctl(ttft_ticks, 0.99),
        "ttft_s_p50": _pctl(ttft_s, 0.50),
        "ttft_s_p99": _pctl(ttft_s, 0.99),
        "per_token_s": elapsed / max(total_tokens, 1),
        "tokens_per_s": total_tokens / max(elapsed, 1e-9),
        "tokens": float(total_tokens),
        "ticks": float(eng.tick_count),
        "tokens_per_tick": total_tokens / max(eng.tick_count, 1),
        "elapsed_s": elapsed,
    }
    if ttft_slo_ticks is not None:
        ok = {r.rid for r, t in zip(requests, ttft_ticks)
              if t <= ttft_slo_ticks}
        ok_tokens = sum(len(c.tokens) for c in completions if c.rid in ok)
        out["slo_attainment"] = len(ok) / max(len(requests), 1)
        out["goodput_tokens_per_s"] = ok_tokens / max(elapsed, 1e-9)
        out["goodput_tokens_per_tick"] = ok_tokens / max(eng.tick_count, 1)
    if reporter is not None:
        ticks = max(eng.tick_count, 1)
        reporter.observe_step(eng.tick_count, elapsed / ticks,
                              items=float(total_tokens) / ticks)
        reporter.observe_ttft(out["ttft_s_p50"])
        reporter.flush()
    return out
