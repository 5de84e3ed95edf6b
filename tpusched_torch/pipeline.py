"""Pipeline parallelism: the GPipe schedule over the ``pp`` mesh axis.

Counterpart of ``tpusched/jaxbridge/pipeline.py``. The layers are stacked
(one (L, …) leaf per layer parameter, :func:`stack_layers`) and the stacked
leaves' leading axis is split over pp: stage s holds layers
[s·L/pp, (s+1)·L/pp). ``embed``, ``out`` and ``ln_f`` are whole over pp.
Other axes of a pipeline mesh: dp splits the batch (the only axis that
does, as in the reference), ep the experts and tp the model inside a
stage, fsdp every matrix's non-tp dim as in the flat steps; slice and sp
are replicas, their ranks running the same rows as their peers.

The step is GPipe with explicit hand-offs: stage s runs its layers forward
on each microbatch and sends the activation to stage s + 1 (:func:`mesh.
send`; the next stage receives it as a leaf that requires grad); the last
stage takes the loss over every microbatch's output at once; the backward
then runs the microbatches in reverse, each stage sending its input's
gradient to stage s − 1. The reference runs every stage on every tick of a
``lax.scan`` and masks the bubbles with ``jnp.where``; here a bubble
computes nothing, so a stage's kernel launches are its layers times the
microbatches, not times the ticks.

The reference's semantics are kept, each pinned by a test:

- no remat inside a stage, whatever ``cfg.remat`` says;
- microbatch i is rows [i·mb, (i+1)·mb) of the global batch, which dp then
  splits, and an MoE layer ranks that global microbatch's tokens for
  capacity (the dp gather of :class:`workload.ExpertAxes`); a microbatch
  whose mb rows do not split over dp runs whole on every dp rank, the
  same global computation;
- the loss is the mean NLL over the whole global batch (plain
  log-softmax, whatever ``vocab_parallel_loss`` says) plus
  ``moe_aux_weight`` times the LAST stage's aux summed over microbatches;
  the other stages' aux gets no gradient;
- the gradients of ``embed``, ``out`` and ``ln_f`` are summed over pp, so
  every stage applies the same update; every gradient is averaged over dp;
- the returned loss is the last stage's on every rank.

The step is a program (:mod:`.program`) over the static global batch and
the stage's shards, which it updates in place: on the card captured at
its first call as a chain of CUDA graphs broken at each hand-off (a send,
a receive, a send's wait) and collective, whose breaks run between the
replays in the order the schedule posts them; on the CPU its body runs as
it is. It is rebound for other tensors as the flat steps are
(``workload._BoundPrograms``).

Under fsdp a stage gathers each of its layers' leaves, and ``embed`` and
``out``, once a step, before the first microbatch: a microbatch's backward
holds the weights its forward used, so a gather a use would hold n_micro
copies. The fsdp ranks run the same rows, so each one's gradient of a
gathered weight is already the full gradient: the gather's backward takes
this rank's chunk of it with no sum over fsdp (``mesh.gather(...,
reduce=False)``), where the flat steps' reduce-scatter sums the partial
gradients of rows that fsdp splits.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .mesh import Mesh, broadcast, gather_last, local_chunk, recv, send
from .mesh import all_reduce
from .program import Program
from .workload import (ExpertAxes, ModelConfig, Params, _block,
                       _BoundPrograms, _gather_fsdp, _nll, _resolve_attn_fn,
                       _rmsnorm, _tokens_buffer, cast_params_for_compute,
                       embed, gather_leaf, init_params, moe_act_spec,
                       param_specs, shard_leaf, tree_leaves, tree_map,
                       unembed)

# (stacked layers, embed, out, ln_f)
PipelineParams = Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor,
                       torch.Tensor]

PIPELINE_AXES = ("pp", "slice", "dp", "fsdp", "sp", "ep", "tp")


def stack_layers(params: Params) -> Dict[str, torch.Tensor]:
    """The list of layer dicts as one dict of (L, …) stacked leaves."""
    layers = params["layers"]
    return {k: torch.stack([layer[k] for layer in layers])
            for k in layers[0]}


def init_pipeline_params(cfg: ModelConfig, generator: torch.Generator,
                         device=None) -> PipelineParams:
    """(stacked layers, embed, out, ln_f) from ``workload.init_params``."""
    params = init_params(cfg, generator, device)
    return (stack_layers(params), params["embed"], params["out"],
            params["ln_f"])


def pipeline_param_specs(cfg: ModelConfig, mesh: Mesh) -> Tuple:
    """The specs of (stacked layers, embed, out, ln_f), as the reference's
    ``pipeline_param_shardings``: a stacked leaf takes ("pp", *its layer's
    spec); ``embed``, ``out`` and ``ln_f`` their ``param_specs``, whole
    over pp."""
    specs = param_specs(cfg, mesh)
    stacked = {k: ("pp", *spec) for k, spec in specs["layers"][0].items()}
    return stacked, specs["embed"], specs["out"], specs["ln_f"]


def shard_pipeline_params(params: PipelineParams, cfg: ModelConfig,
                          mesh: Mesh) -> PipelineParams:
    """This rank's slice of (stacked layers, embed, out, ln_f): its stage's
    layers and its fsdp, ep and tp shards, as ``workload.shard_params``
    cuts."""
    check_pipeline_mesh(mesh, cfg)
    return tuple(tree_map(lambda x, spec: shard_leaf(x, spec, mesh), params,
                          pipeline_param_specs(cfg, mesh)))


def gather_pipeline_params(shards: PipelineParams, cfg: ModelConfig,
                           mesh: Mesh) -> PipelineParams:
    """The whole (stacked layers, embed, out, ln_f) back from every rank's
    shards (each rank gets it): for tests and checkpoints."""
    return tuple(tree_map(lambda x, spec: gather_leaf(x, spec, mesh), shards,
                          pipeline_param_specs(cfg, mesh)))


def check_pipeline_mesh(mesh: Mesh, cfg: ModelConfig) -> None:
    """Raise (ValueError) unless ``mesh`` has a pp axis whose stages split
    the layers evenly, its other axes are among :data:`PIPELINE_AXES`, and
    ep divides the experts."""
    if mesh is None or "pp" not in mesh.shape:
        raise ValueError("a pipeline mesh needs a 'pp' axis")
    for a in mesh.axis_names:
        if a not in PIPELINE_AXES:
            raise ValueError(f"unknown mesh axis {a!r}")
    pp = mesh.shape["pp"]
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers ({cfg.n_layers}) must divide into "
                         f"pp={pp} stages")
    ep = mesh.shape.get("ep", 1)
    if cfg.n_experts % ep:
        raise ValueError(f"n_experts {cfg.n_experts} not divisible by ep "
                         f"{ep}")


def _gpipe_program(b, mesh: Mesh, cfg: ModelConfig, n_micro: int,
                   lr: float, tokens: torch.Tensor, *, graphed: bool):
    """The GPipe step (module docstring) as a program over the tree ``b``
    (``b.params``, this rank's (stacked, embed, out, ln_f) while a call
    runs, :class:`workload._BoundPrograms`): ``tokens`` (the global batch)
    in, the last stage's loss out, ``b.params`` updated in place
    (``p -= lr·g``). Its body is the whole schedule: the forward over the
    microbatches, the two backwards, the hand-offs and the update; each
    hand-off (a send, a receive, a send's wait) is a break of the chain on
    the card, posted in the order the schedule makes it."""
    pp, dp, tp, fsdp = mesh.pp, mesh.axis("dp"), mesh.tp, mesh.fsdp
    stage, last = pp.index, pp.size - 1
    attn_fn = _resolve_attn_fn(cfg)
    buf = _tokens_buffer(tokens, tree_leaves(b.params)[0])
    rows_b, s = tokens.shape
    rows = dp if dp is not None and (rows_b // n_micro) % dp.size == 0 \
        else None
    moe = ExpertAxes(moe_act_spec(cfg, mesh), rows)

    def body():
        params = b.params
        micro = local_chunk(buf.reshape(n_micro, rows_b // n_micro, s), rows,
                            1)
        masters = [t.detach().requires_grad_(True) for t in
                   tree_leaves(params)]
        it = iter(masters)
        stacked, emb, out_w, ln_f = cast_params_for_compute(
            tree_map(lambda _: next(it), params), cfg)
        # whole weights once a step, their gradients this rank's chunk of
        # the full one (module docstring)
        layers = [_gather_fsdp({k: v[j] for k, v in stacked.items()}, cfg,
                               fsdp, reduce=False)
                  for j in range(next(iter(stacked.values())).shape[0])]
        whole = _gather_fsdp({"embed": emb, "out": out_w}, cfg, fsdp,
                             reduce=False)
        emb, out_w = whole["embed"], whole["out"]
        device = emb.device
        act = (micro.shape[1], s, cfg.d_model)
        sends = []

        # forward: each microbatch through this stage's layers, handed on
        ins, outs, auxs = [], [], []
        for i in range(n_micro):
            if stage == 0:
                x = embed({"embed": emb}, micro[i], tp)
            else:
                x = recv(pp, stage - 1, act, cfg.dtype,
                         device).requires_grad_(True)
            y = x
            aux = torch.zeros((), dtype=torch.float32, device=device)
            for layer in layers:
                y, a = _block(y, layer, cfg, attn_fn, tp=tp, moe=moe)
                aux = aux + a
            if stage < last:
                sends.append(send(y, pp, stage + 1))
            ins.append(x)
            outs.append(y)
            auxs.append(aux)

        # the last stage's loss over every microbatch's output at once
        loss = torch.zeros((), dtype=torch.float32, device=device)
        if stage == last:
            ends = [y.detach().requires_grad_(True) for y in outs]
            logits = unembed({"out": out_w}, _rmsnorm(torch.cat(ends), ln_f),
                             cfg, tp)
            if cfg.vocab_parallel_loss:   # the plain loss, as the reference's
                logits = gather_last(logits, tp)
            nll = _nll(logits[:, :-1], micro.reshape(-1, s)[:, 1:]).mean()
            nll.backward()
            loss = nll.detach() + cfg.moe_aux_weight * sum(
                a.detach() for a in auxs)

        # backward: the microbatches in reverse, input gradients handed back
        for i in reversed(range(n_micro)):
            if stage == last:
                heads, grads = [outs[i]], [ends[i].grad]
                if auxs[i].requires_grad:
                    heads.append(auxs[i])
                    grads.append(torch.full((), cfg.moe_aux_weight,
                                            device=device))
            else:
                heads = [outs[i]]
                grads = [recv(pp, stage + 1, act, cfg.dtype, device)]
            torch.autograd.backward(heads, grads)
            if stage > 0:
                sends.append(send(ins[i].grad, pp, stage - 1))
            ins[i] = outs[i] = auxs[i] = None
        for sent in sends:
            sent.wait()

        grads = [torch.zeros_like(m) if m.grad is None else m.grad
                 for m in masters]
        # embed, out and ln_f: one stage's gradient each, summed over pp
        n_stacked = len(stacked)
        shared = all_reduce(torch.cat([g.float().reshape(-1)
                                       for g in grads[n_stacked:]]), pp)
        loss = broadcast(loss.reshape(1).clone(), pp, last)
        flat = torch.cat([loss] + [g.float().reshape(-1)
                                   for g in grads[:n_stacked]] + [shared])
        flat = all_reduce(flat, dp) / (dp.size if dp is not None else 1)
        sizes = [1] + [g.numel() for g in grads]
        parts = torch.split(flat, sizes)
        with torch.no_grad():
            for p, part in zip(tree_leaves(params), parts[1:]):
                p.sub_(lr * part.reshape(p.shape).to(p.dtype))
        return parts[0][0].clone()

    return Program(body, {"tokens": buf}, graphed=graphed, advances=True)


def make_pipeline_train_step(mesh: Mesh, cfg: ModelConfig, n_micro: int,
                             lr: float = 1e-3):
    """SGD through the GPipe schedule (module docstring) on ``mesh`` (pp,
    with any of slice, dp, fsdp, sp, ep and tp). Returns ``(step,
    param_specs, token_spec)`` where ``step((stacked, embed, out, ln_f),
    tokens) -> (params, loss)`` takes this rank's shards
    (:func:`shard_pipeline_params`) and the GLOBAL batch (B, S), which
    must split into ``n_micro`` microbatches, and updates the shards IN
    PLACE, returning the same tree, as the flat steps do. The step is a
    program (:func:`_gpipe_program`): on the card captured at its first
    call as a chain of graphs broken at each collective and hand-off, and
    replayed after that; its body called as it is on the CPU. A call with
    other tensors, or another batch shape, builds it anew for them, as
    ``workload.make_sharded_train_step``'s does."""
    check_pipeline_mesh(mesh, cfg)
    specs = pipeline_param_specs(cfg, mesh)
    programs = _BoundPrograms(
        lambda b, tokens, graphed: _gpipe_program(
            b, mesh, cfg, n_micro, lr, tokens, graphed=graphed))

    def step(params: PipelineParams, tokens: torch.Tensor):
        if tokens.shape[0] % n_micro:
            raise ValueError(f"batch {tokens.shape[0]} does not split into "
                             f"n_micro={n_micro} microbatches")
        with programs.bound(params, None, (tokens.shape, tokens.dtype),
                            tokens) as prog:
            return params, prog(tokens=tokens).clone()

    step._programs = programs
    return (step, specs,
            ((("dp",) if mesh.axis("dp") is not None else None), None))
