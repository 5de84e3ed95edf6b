"""Rank programs for the port's parallel tests (tensor, data, fully-sharded,
sequence, expert and pipeline parallelism, checkpoints and the token
stream).

``tpusched_torch.mesh.launch`` runs each of these in every spawned gloo rank
on the CPU. This module imports torch, numpy and the port only, never JAX:
the ranks start from a fresh import of it, and the JAX reference runs in the
parent test process. Each program returns numpy arrays and Python values.
"""
from __future__ import annotations

import contextlib
import functools
import os

import numpy as np
import torch

from tpusched_torch import attention, checkpoint, decode, interop
from tpusched_torch import mesh as tmesh
from tpusched_torch import optim, pipeline, workload as wl
from tpusched_torch import program as tprogram
from tpusched_torch.data import TokenBatcher
from tpusched_torch.serve import Request, ServeEngine


def _np_tree(tree):
    return wl.tree_map(lambda t: t.detach().float().numpy(), tree)


def mesh_rank(m: tmesh.Mesh, cfg: wl.ModelConfig, tree) -> dict:
    """Axis layout and collectives of a {"dp": 2, "tp": 2} mesh, and
    shard_params then gather_params of ``tree``; then :func:`shift_rank`
    on the same ranks."""
    torch.set_num_threads(1)
    out = {"rank": m.rank, "coord": dict(m.coord)}
    x = torch.tensor([float(m.rank)])
    for name in ("dp", "tp", "batch"):
        a = m.batch if name == "batch" else m.axis(name)
        out[name] = {
            "ranks": a.ranks, "index": a.index, "size": a.size,
            "sum": tmesh.all_reduce(x, a).tolist(),
            "max": tmesh.all_reduce(x, a, "max").tolist(),
            "gather": tmesh.all_gather(x[None], a, 0)[:, 0].tolist(),
            "bcast": tmesh.broadcast(x.clone() + 10, a, 1).tolist()}
    params = interop.params_from_numpy(tree, cfg, "cpu")
    shards = wl.shard_params(params, cfg, m)
    out["shard_shapes"] = {k: tuple(shards[k].shape)
                           for k in ("embed", "out")}
    out["gathered"] = _np_tree(wl.gather_params(shards, cfg, m))
    out["sp_fsdp"] = shift_rank(m)
    return out


def _completions(eng: ServeEngine, reqs) -> dict:
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    return {"tokens": {c.rid: c.tokens.tolist() for c in done},
            "ticks": eng.tick_count,
            "spec_stats": dict(eng.spec_stats)}


def _count_flash_calls() -> dict:
    """Counts of this rank's calls to the flash forward and backward from
    now on (the wrappers stay for the rank's life): the plain versions'
    launches on the CPU."""
    calls = {"forward": 0, "backward": 0}

    def counted(fn, what):
        def wrapper(*args, **kwargs):
            calls[what] += 1
            return fn(*args, **kwargs)
        return wrapper
    attention.flash_forward = counted(attention.flash_forward, "forward")
    attention._flash_backward = counted(attention._flash_backward,
                                        "backward")
    return calls


def _mesh_of(meshes: dict, sizes: dict) -> tmesh.Mesh:
    """The mesh of ``sizes`` over this launch's ranks, built once."""
    key = tuple(sizes.items())
    if key not in meshes:
        meshes[key] = tmesh.build_named_mesh(sizes, "gloo", "cpu")
    return meshes[key]


def serve_rank(m: tmesh.Mesh, cases: dict) -> dict:
    """Each case ``name -> (cfg, numpy tree, engine kwargs, requests,
    prefix)``: the engine on the mesh, and, for request-keyed sampling,
    the unsharded engine too (the keyed draws are the port's own, so that
    case is held to the port's unsharded engine)."""
    torch.set_num_threads(1)
    out = {}
    for name, (cfg, tree, kw, reqs, prefix) in cases.items():
        params = interop.params_from_numpy(tree, cfg, "cpu")
        kw = dict(kw)
        if kw.pop("self_draft", False):
            kw.update(draft_params=params, draft_cfg=cfg)
        runs = {}
        for label, mesh in (("tp", m), ("solo", None)):
            if label == "solo" and not kw.get("request_keyed"):
                continue
            eng = ServeEngine(params, cfg, slots=2, max_seq=64,
                              prompt_bucket=16, mesh=mesh, device="cpu", **kw)
            if prefix is not None:
                eng.register_prefix("sys", prefix)
            runs[label] = _completions(eng, reqs)
            if mesh is not None:
                runs["kv_heads"] = int(eng.cache[0]["k"].shape[2])
                runs["scale_planes"] = "ks" in eng.cache[0]
        out[name] = runs
    return out


def _train_case(m: tmesh.Mesh, kind: str, cfg, tree, tokens) -> dict:
    """One case of :func:`train_rank` or :func:`sharded_train_rank` on
    ``m``."""
    params = interop.params_from_numpy(tree, cfg, "cpu")
    shards = wl.shard_params(params, cfg, m)
    if kind in ("grads", "mesh_grads"):
        toks = torch.from_numpy(tokens).long()
        if kind == "grads":
            loss, grads = wl.value_and_grad(shards, toks, cfg, tp=m.tp)
        else:    # the train steps' global loss and gradients
            ts = wl.TrainShardings(m, cfg)
            loss, grads = ts.mean(*ts(shards, ts.local(toks)))
        ref_loss, ref = wl.value_and_grad(params, toks, cfg)
        return {"loss": float(loss), "ref_loss": float(ref_loss),
                "grads": _np_tree(wl.gather_params(grads, cfg, m)),
                "ref": _np_tree(ref)}
    if kind == "loss":
        with torch.no_grad():
            loss = wl.loss_fn(shards, torch.from_numpy(tokens).long(),
                              cfg, tp=m.tp)
        return {"loss": float(loss)}
    losses, moments, moment_shapes = [], None, None
    if kind == "sgd":
        step, specs, tspec = wl.make_sharded_train_step(m, cfg)
        for toks in tokens:
            shards, loss = step(shards, torch.from_numpy(toks).long())
            losses.append(float(loss))
    else:
        tx = optim.adamw(1e-3)
        make = (wl.make_optax_train_step if kind == "adamw"
                else wl.make_accum_train_step)
        step, init_opt, specs, tspec = make(
            m, cfg, tx, *((4,) if kind == "accum" else ()))
        opt = init_opt(shards)
        for toks in tokens:
            shards, opt, loss = step(shards, opt,
                                     torch.from_numpy(toks).long())
            losses.append(float(loss))
        moments = sorted({str(t.dtype) for t in
                          wl.tree_leaves(opt.mu) + wl.tree_leaves(opt.nu)})
        moment_shapes = [tuple(t.shape) for t in wl.tree_leaves(opt.mu)]
    return {"losses": losses, "token_spec": tspec,
            "dtypes": sorted({str(t.dtype) for t in wl.tree_leaves(shards)}),
            "moments": moments, "moment_shapes": moment_shapes,
            "shard_shapes": [tuple(t.shape) for t in wl.tree_leaves(shards)],
            "params": _np_tree(wl.gather_params(shards, cfg, m))}


def train_rank(m: tmesh.Mesh, cases: dict) -> dict:
    """Training on a {"dp": 2, "tp": 2} mesh. Each case ``name -> (kind,
    cfg, numpy tree, tokens)``: kind "sgd", "adamw" or "accum" runs two
    steps of the matching make_*_train_step on the GLOBAL tokens (a list of
    two batches, or of two accumulation stacks) and returns the losses and
    the gathered params (and the AdamW moments' dtypes); "grads" returns
    loss and gradients at tp = 2 (value_and_grad on the shards, gathered)
    and unsharded; "loss" returns the loss_fn at tp = 2."""
    torch.set_num_threads(1)
    return {name: _train_case(m, *case) for name, case in cases.items()}


def sharded_train_rank(m: tmesh.Mesh, cases: dict) -> dict:
    """:func:`train_rank`'s cases, each on a mesh of its own over the same
    ranks: ``name -> (axis sizes, kind, cfg, numpy tree, tokens)``; kind
    "mesh_grads" returns the train steps' global loss and gradients
    (``TrainShardings``: this rank's rows and sequence chunk, then
    ``mean``) beside the unsharded model's."""
    torch.set_num_threads(1)
    meshes = {tuple(m.shape.items()): m}
    return {name: _train_case(_mesh_of(meshes, sizes), *case)
            for name, (sizes, *case) in cases.items()}


def pipeline_rank(m: tmesh.Mesh, cases: dict) -> dict:
    """One pipelined SGD step a case, each on a mesh of its own over the
    same ranks: ``name -> (axis sizes, cfg, n_micro, lr, numpy tree,
    tokens)``. Returns the loss, the gathered (stacked, embed, out, ln_f)
    after the step, this rank's pp index, its shards' shapes and its calls
    to the flash forward and backward in the step."""
    torch.set_num_threads(1)
    meshes = {tuple(m.shape.items()): m}
    calls = _count_flash_calls()
    out = {}
    for name, (sizes, cfg, n_micro, lr, tree, tokens) in cases.items():
        mesh = _mesh_of(meshes, sizes)
        step, _, token_spec = pipeline.make_pipeline_train_step(
            mesh, cfg, n_micro, lr)
        shards = pipeline.shard_pipeline_params(
            interop.pipeline_params_from_numpy(tree, cfg, "cpu"), cfg, mesh)
        calls.update(forward=0, backward=0)
        new, loss = step(shards, torch.from_numpy(tokens).long())
        out[name] = {"loss": float(loss), "stage": mesh.pp.index,
                     "calls": dict(calls), "token_spec": token_spec,
                     "shapes": [tuple(t.shape) for t in
                                wl.tree_leaves(list(shards))],
                     "params": _np_tree(list(
                         pipeline.gather_pipeline_params(new, cfg, mesh)))}
    return out


def ring_rank(m: tmesh.Mesh, cases: dict) -> dict:
    """Ring attention on this rank's sequence chunks. ``m`` is {"sp": 4}
    over four ranks; the same ranks also form {"dp": 2, "sp": 2} for sp = 2.
    Each case ``name -> (sp, causal, flash, q, k, v)`` (numpy, the whole
    sequence) returns this rank's chunk of out and of the gradients of
    sum(out²) over every rank, the sp index, and the calls the rank made to
    the flash forward and backward."""
    torch.set_num_threads(1)
    meshes = {4: m, 2: tmesh.build_named_mesh({"dp": 2, "sp": 2}, "gloo",
                                              "cpu")}
    calls = _count_flash_calls()
    out = {}
    for name, (sp, causal, flash, *qkv) in cases.items():
        axis = meshes[sp].sp
        q, k, v = (tmesh.local_chunk(torch.from_numpy(x), axis, 1).clone()
                   .requires_grad_(True) for x in qkv)
        calls.update(forward=0, backward=0)
        fn = (attention.ring_flash_attention if flash
              else attention.ring_attention)
        o = fn(q, k, v, axis, causal)
        o.square().sum().backward()
        out[name] = {"index": axis.index, "calls": dict(calls),
                     **{n: t.detach().numpy() for n, t in
                        (("out", o), ("dq", q.grad), ("dk", k.grad),
                         ("dv", v.grad))}}
    return out


def shift_rank(m: tmesh.Mesh) -> dict:
    """The collectives of sequence and fully-sharded parallelism over four
    ranks: ring_shift and its backward, and shift by −1, on {"sp": 4}; the
    axes' groups, and gather along dim 0 and its reduce-scatter backward
    over fsdp, on {"fsdp": 2, "sp": 2}. Each rank's loss weighs what it
    holds by 1 + its rank, so a gradient names the ranks it came from."""
    torch.set_num_threads(1)
    ring = tmesh.build_named_mesh({"sp": 4}, "gloo", "cpu")
    x = torch.full((2, 3), float(m.rank), requires_grad=True)
    y = tmesh.ring_shift(x, ring.sp)
    (y * (1.0 + m.rank)).sum().backward()
    back = tmesh.shift([torch.tensor([m.rank])], ring.sp, -1)[0]
    two = tmesh.build_named_mesh({"fsdp": 2, "sp": 2}, "gloo", "cpu")
    w = (torch.arange(6.0).reshape(2, 3) + 10 * m.rank).requires_grad_(True)
    whole = tmesh.gather(w, two.fsdp, 0)
    (whole * (1.0 + m.rank)).sum().backward()
    return {"shifted": y.detach().numpy(), "shift_grad": x.grad.numpy(),
            "back": int(back), "coord": dict(two.coord),
            "sp_ranks": two.sp.ranks, "fsdp_ranks": two.fsdp.ranks,
            "data_ranks": two.data.ranks, "batch_ranks": two.batch.ranks,
            "gathered": whole.detach().numpy(),
            "gather_grad": w.grad.numpy(),
            "sums": [float(tmesh.all_reduce(torch.tensor([1.0 + m.rank]),
                                            two.axis(names))[0])
                     for names in (tmesh.DATA_AXES,
                                   tmesh.DATA_AXES_BUT_FSDP)]}


def _checkpoint_case(a: tmesh.Mesh, b: tmesh.Mesh, directory: str, kind: str,
                     cfg, tree, tokens) -> dict:
    """Two steps on mesh ``a``, a save, two more (the uninterrupted run),
    then a restore onto mesh ``b`` and two steps there: the losses, the
    restored step, shard shapes and AdamW count, and the gathered ``out``
    after the continuation."""
    toks = torch.from_numpy(tokens).long()
    params = interop.params_from_numpy(tree, cfg, "cpu")
    if kind == "sgd":
        step_a, specs_a, _ = wl.make_sharded_train_step(a, cfg)
        shards = wl.shard_params(params, cfg, a)
        for _ in range(2):
            shards, _ = step_a(shards, toks)
        checkpoint.save(directory, shards, 2, mesh=a, specs=specs_a)
        base = shards
        for _ in range(2):
            base, base_loss = step_a(base, toks)
        step_b, specs_b, _ = wl.make_sharded_train_step(b, cfg)
        restored, saved = checkpoint.restore(
            directory, checkpoint.abstract_state(
                checkpoint.param_skeleton(cfg), specs_b, b), mesh=b)
        count = None
        resumed = restored
        for _ in range(2):
            resumed, loss = step_b(resumed, toks)
    else:
        tx = optim.adamw(1e-3)
        step_a, init_opt, specs_a, _ = wl.make_optax_train_step(a, cfg, tx)
        shards = wl.shard_params(params, cfg, a)
        opt = init_opt(shards)
        for _ in range(2):
            shards, opt, _ = step_a(shards, opt, toks)
        checkpoint.save(directory, shards, 2, extra=opt, mesh=a,
                        specs=specs_a)
        for _ in range(2):                      # in place
            shards, opt, base_loss = step_a(shards, opt, toks)
        step_b, init_b, specs_b, _ = wl.make_optax_train_step(b, cfg, tx)
        skeleton = init_b(wl.shard_params(params, cfg, b))
        restored, saved, r_opt = checkpoint.restore(
            directory, checkpoint.abstract_state(
                checkpoint.param_skeleton(cfg), specs_b, b), mesh=b,
            abstract_extra=checkpoint.abstract_like(skeleton, specs_b, b))
        count = r_opt.count
        resumed = restored
        for _ in range(2):
            resumed, r_opt, loss = step_b(resumed, r_opt, toks)
    layer = restored["layers"][0]
    return {"base_loss": float(base_loss), "loss": float(loss),
            "step": saved, "count": count,
            "shapes": {k: tuple(layer[k].shape) for k in ("wq", "w_gate")},
            "out": wl.gather_params(resumed, cfg, b)["out"].float().numpy()}


def checkpoint_rank(m: tmesh.Mesh, directory: str, cases: dict) -> dict:
    """Checkpoints saved on one mesh and restored onto another, each case
    ``name -> (mesh a sizes, mesh b sizes, kind, cfg, numpy tree, tokens)``
    over the same ranks, kind "sgd" (``make_sharded_train_step``) or
    "adamw" (``make_optax_train_step``, the optimizer state saved as
    ``extra``), into ``directory/name`` (:func:`_checkpoint_case`)."""
    torch.set_num_threads(1)
    meshes = {tuple(m.shape.items()): m}
    return {name: _checkpoint_case(_mesh_of(meshes, sa), _mesh_of(meshes, sb),
                                   os.path.join(directory, name), *case)
            for name, (sa, sb, *case) in cases.items()}


def serving_snapshot_rank(m: tmesh.Mesh, directory: str, cases: dict) -> dict:
    """On a {"tp": 2} mesh, each case ``name -> (cfg, prompt, new tokens)``
    reads the serving snapshot under ``directory/name`` twice, whole and as
    this rank's shards (``load_for_serving(mesh=)``), and serves the prompt
    greedily through an engine given the shards and one given the whole
    tree. Returns the shards' shapes and dtypes and both engines'
    tokens."""
    torch.set_num_threads(1)
    out = {}
    for name, (cfg, prompt, new) in cases.items():
        d = os.path.join(directory, name)
        shards = checkpoint.load_for_serving(d, cfg, mesh=m, device="cpu")
        whole = checkpoint.load_for_serving(d, cfg, device="cpu")
        runs = {}
        for label, tree in (("shards", shards), ("whole", whole)):
            eng = ServeEngine(tree, cfg, slots=2, max_seq=64,
                              prompt_bucket=16, mesh=m, device="cpu")
            eng.submit(Request(rid=0, prompt=prompt, max_new_tokens=new))
            runs[label] = eng.run_until_drained()[0].tokens.tolist()
        out[name] = {"tokens": runs,
                     "shapes": [tuple(t.shape) for t in
                                wl.tree_leaves(shards)],
                     "dtypes": sorted({str(t.dtype) for t in
                                       wl.tree_leaves(shards)})}
    return out


def batcher_rank(m: tmesh.Mesh, cfg, steps: int, ref_batch) -> dict:
    """The token stream on a {"dp": 2} mesh: ``steps`` batches of
    ``TokenBatcher(cfg, 4, mesh=m, seed=3)``, and the SGD step's loss given
    the first of them and given the reference's batch ``ref_batch``."""
    torch.set_num_threads(1)
    batches = [t.numpy() for _, t in zip(range(steps),
                                         TokenBatcher(cfg, 4, mesh=m,
                                                      seed=3))]
    params = wl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    step, _, _ = wl.make_sharded_train_step(m, cfg)
    # the step updates its shards in place: each loss from fresh ones
    losses = [float(step(wl.shard_params(params, cfg, m),
                         torch.from_numpy(b))[1])
              for b in (batches[0], np.asarray(ref_batch, np.int64))]
    return {"batches": batches, "losses": losses}


def serve_mesh_rank(m: tmesh.Mesh, directory, cases: dict) -> dict:
    """The engine on meshes over this launch's ranks. Each case ``name ->
    (axis sizes, cfg, numpy tree, engine kwargs, requests)``: the
    completions, ticks, this rank's leaf shapes and arena heads, and, for a
    sampled case, the unsharded engine's completions too (the port's own
    draws). With ``directory``, a case named ``snapshot`` loads its weights
    as this rank's shards by ``load_for_serving(directory, mesh=)``."""
    torch.set_num_threads(1)
    meshes = {tuple(m.shape.items()): m}
    out = {}
    for name, (sizes, cfg, tree, kw, reqs) in cases.items():
        mesh = _mesh_of(meshes, sizes)
        params = (checkpoint.load_for_serving(directory, cfg, mesh=mesh)
                  if name == "snapshot"
                  else interop.params_from_numpy(tree, cfg, "cpu"))
        kw = dict(kw)
        if kw.pop("self_draft", False):
            kw.update(draft_params=params, draft_cfg=cfg)
        eng = ServeEngine(params, cfg, slots=2, max_seq=64, prompt_bucket=16,
                          mesh=mesh, device="cpu", **kw)
        run = _completions(eng, reqs)
        run["shapes"] = [tuple(t.shape) for t in wl.tree_leaves(eng.params)]
        run["kv_heads"] = int(eng.cache[0]["k"].shape[2])
        if kw.get("temperature", 0.0) > 0.0:
            solo = ServeEngine(params, cfg, slots=2, max_seq=64,
                               prompt_bucket=16, device="cpu", **kw)
            run["solo"] = _completions(solo, reqs)
        out[name] = run
    return out


def generate_rank(m: tmesh.Mesh, cases: dict) -> dict:
    """``decode.generate``/``sample`` over this rank's tp shards. Each case
    ``name -> (cfg, numpy tree, prompts (b, s), steps, temperature)``; a
    sampled case draws with a generator seeded 100 + the rank, so only the
    broadcast of tp rank 0's draws can make the ranks agree."""
    torch.set_num_threads(1)
    out = {}
    for name, (cfg, tree, prompt, steps, temperature) in cases.items():
        shards = wl.shard_params(interop.params_from_numpy(tree, cfg, "cpu"),
                                 cfg, m)
        gen = torch.Generator().manual_seed(100 + m.rank)
        out[name] = decode.sample(shards, torch.from_numpy(prompt).long(),
                                  cfg, steps, gen, temperature,
                                  tp=m.tp).tolist()
    return out


class _RecordedGraph:
    """A CUDA graph's stand-in: its capture calls and replays, logged, and
    the capture mode each segment began in (``modes``)."""

    def __init__(self, log: list, index: int, modes: list):
        self.log, self.index, self.modes = log, index, modes

    def register_generator_state(self, gen) -> None:
        self.log.append(("register", self.index))

    def capture_begin(self, pool=None, capture_error_mode="global") -> None:
        self.log.append(("begin", self.index, pool))
        self.modes.append(capture_error_mode)

    def capture_end(self) -> None:
        self.log.append(("end", self.index))

    def pool(self):
        return ("pool of", self.index)

    def replay(self) -> None:
        self.log.append(("replay", self.index))


class CaptureRecorder:
    """Stands in for ``program._cuda`` on the CPU: graphs that log their
    capture calls and replays and run nothing, no stream, no device
    work. The body still runs for real in its warm-up and in its capture
    (with its collectives cut out), and the breaks run on every call."""

    def __init__(self):
        self.log: list = []
        self.modes: list = []
        self.graphs = 0

    def side_stream(self):
        return None

    def on(self, stream):
        return contextlib.nullcontext()

    def prepare(self) -> None:
        self.log.append(("prepare",))

    def graph(self) -> _RecordedGraph:
        self.graphs += 1
        return _RecordedGraph(self.log, self.graphs - 1, self.modes)

    def join(self, stream) -> None:
        pass


def collectives_of(fn) -> list:
    """The kinds of the collectives one call of ``fn`` makes through the
    mesh, in order; each runs as it comes."""
    kinds = []

    class Counter:
        name = "counter"

        def cut(self, call):
            kinds.append(call.kind)
            call()

    with tmesh.capturing(Counter()):
        fn()
    return kinds


def _chain_plan(prog, values: dict, calls: int = 2) -> dict:
    """``prog`` (built graphed) called ``calls`` times with ``values``
    under a :class:`CaptureRecorder`: its breaks' kinds, its segments, the
    collectives its warm-up ran, the breaks its replays ran, the capture
    mode of each segment and the recorder's log, in which each
    collective that runs (in the warm-up, or as a break between replays)
    is logged as ("run", kind)."""
    from tpusched_torch import program
    recorder, real = CaptureRecorder(), program._cuda
    run = tmesh.Collective.__call__

    def logged(call):
        recorder.log.append(("run", call.kind))
        run(call)

    program._cuda, tmesh.Collective.__call__ = recorder, logged
    try:
        for _ in range(calls):
            prog(**values)
    finally:
        program._cuda, tmesh.Collective.__call__ = real, run
    return {"breaks": [b.kind for b in prog.breaks],
            "segments": len(prog.segments),
            "warmup_collectives": prog.warmup_collectives,
            "breaks_run": prog.breaks_run,
            "log": recorder.log, "modes": recorder.modes}


SERVE_KW = dict(slots=2, max_seq=64, prompt_bucket=16)


def _engine_programs(mesh: tmesh.Mesh, cfg, params, program) -> dict:
    """The tiny engines' programs on ``mesh``, each built by the engine's
    own builders with ``program`` (``Program`` with ``graphed`` and
    ``pool`` bound), and the values of one call of each: the decode tick,
    the slot prefill, the chunk, and the greedy round's draft tick and
    verify span (spec_k 3, a self-draft)."""
    from tpusched_torch import serve
    spec = ServeEngine(params, cfg, mesh=mesh, device="cpu",
                       draft_params=params, draft_cfg=cfg, spec_k=3,
                       **SERVE_KW)
    chunked = ServeEngine(params, cfg, mesh=mesh, device="cpu",
                          chunk_prefill=5, **SERVE_KW)
    axes = (spec._tp, spec._ep, spec._fsdp)
    slots, k = spec.slots, spec.spec_k
    prompt = np.arange(16) % cfg.vocab
    pos = np.array([3, 5])
    return {
        "decode": (serve._build_decode_tick(
            spec._weights, spec.cache, cfg, slots, axes, program),
            dict(tokens=np.array([1, 2]), pos=pos)),
        "prefill": (serve._build_prefill_slot(
            spec._weights, spec.cache, cfg, 16, axes, program),
            dict(prompt=prompt, slot=1, true_len=9)),
        "chunk": (serve._build_prefill_chunk(
            chunked._weights, chunked.cache, cfg, 5, axes, program),
            dict(chunk=prompt[:5], slot=0, off=5, last_row=2)),
        "draft": (serve._build_draft_tick(
            spec._draft_weights, spec.draft_cache, cfg, slots, k, axes,
            program), dict(feed2=np.array([[1, 2], [3, 4]]), pos=pos)),
        "verify": (serve._build_verify_span(
            spec._weights, spec.cache, cfg, slots, k, axes, program),
            dict(scored=np.arange(2 * (k + 1)).reshape(2, k + 1), pos=pos)),
    }


def _decode_steps(m: tmesh.Mesh, cfg, params, graphed: bool) -> dict:
    """``_greedy_step`` and ``_sampled_step`` over this rank's tp shards of
    ``params``, built with ``graphed``, and the values of one call."""
    shards = wl.cast_params_for_compute(wl.shard_params(params, cfg, m), cfg)
    out = {}
    for name in ("greedy_step", "sampled_step"):
        cache = decode.init_kv_cache(cfg, 2, 24, "cpu", m.tp)
        tok = torch.zeros(2, dtype=torch.long)
        pos = torch.full((), 8, dtype=torch.long)
        buf = torch.zeros((2, 9), dtype=torch.long)
        if name == "greedy_step":
            prog = decode._greedy_step(shards, cache, tok, pos, buf, 8, cfg,
                                       m.tp, graphed=graphed)
        else:
            prog = decode._sampled_step(
                shards, cache, tok, pos, buf, 8, cfg,
                torch.Generator().manual_seed(3), (0.8, 0, 1.0),
                graphed=graphed, tp=m.tp)
        out[name] = (prog, {})
    return out


def mesh_program_rank(m: tmesh.Mesh, cases: dict) -> dict:
    """The programs over meshes of this launch's two ranks. Each case
    ``mesh name -> (axis sizes, cfg, numpy tree)``: per program of a tiny
    engine (and, on tp, ``decode``'s two steps) the kinds of the
    collectives one body call makes (``counts``), and the plan of the same
    program built graphed and called twice under a
    :class:`CaptureRecorder` (``plans``). Then ``generate`` and ``sample``
    over tp = 2 (every rank's generator seeded 7), their tokens and the
    program calls they made (``decode``), and the chain of a body that
    shifts along tp, called twice (``shift_capture``)."""
    from tpusched_torch import program
    torch.set_num_threads(1)
    meshes = {tuple(m.shape.items()): m}
    out = {}
    for name, (sizes, cfg, tree) in cases.items():
        mesh = _mesh_of(meshes, sizes)
        params = interop.params_from_numpy(tree, cfg, "cpu")
        bodies = _engine_programs(
            mesh, cfg, params, functools.partial(program.Program,
                                                 graphed=False))
        graphs = _engine_programs(
            mesh, cfg, params, functools.partial(
                program.Program, graphed=True, pool=("engine pool",)))
        if "tp" in sizes:
            bodies.update(_decode_steps(mesh, cfg, params, False))
            graphs.update(_decode_steps(mesh, cfg, params, True))
        out[name] = {
            "counts": {p: collectives_of(prog.body)
                       for p, (prog, _) in bodies.items()},
            "plans": {p: _chain_plan(prog, values)
                      for p, (prog, values) in graphs.items()}}
    cfg, tree = cases["tp"][1:]
    params = wl.shard_params(interop.params_from_numpy(tree, cfg, "cpu"),
                             cfg, m)
    prompt = torch.arange(12).reshape(2, 6) % cfg.vocab
    calls, real = [], program.Program.__call__

    def counted(self, **values):
        calls.append(self.name)
        return real(self, **values)

    program.Program.__call__ = counted
    try:
        greedy = decode.generate(params, prompt, cfg, 5, tp=m.tp)
        sampled = decode.sample(params, prompt, cfg, 5,
                                torch.Generator().manual_seed(7), 0.8,
                                top_k=20, tp=m.tp)
    finally:
        program.Program.__call__ = real
    out["decode"] = {"generate": greedy.tolist(), "sample": sampled.tolist(),
                     "calls": calls}
    x = torch.full((3,), float(m.rank))

    def shifting_body():
        return tmesh.shift([x], m.tp)[0] * 2

    shifting = program.Program(shifting_body, {}, graphed=True)
    recorder, real_cuda = CaptureRecorder(), program._cuda
    program._cuda = recorder
    try:
        got = [shifting().tolist() for _ in range(2)]
    finally:
        program._cuda = real_cuda
    out["shift_capture"] = {"log": recorder.log, "modes": recorder.modes,
                            "breaks": [b.kind for b in shifting.breaks],
                            "segments": len(shifting.segments),
                            "breaks_run": shifting.breaks_run,
                            "received":
                                shifting.breaks[0].tensor[1][0].tolist(),
                            "outputs": got}
    return out



def _mesh_train_step(m: tmesh.Mesh, kind: str, cfg, tree):
    """The port's train step of ``kind`` ("sgd", "adamw", "accum" or
    "pipeline") on ``m`` over this rank's shards of ``tree``: (a call
    taking the global tokens and returning the loss, the step, the
    shards, the optimizer state or None)."""
    if kind == "pipeline":
        step, _, _ = pipeline.make_pipeline_train_step(m, cfg, 2, 1e-2)
        params = pipeline.shard_pipeline_params(
            interop.pipeline_params_from_numpy(tree, cfg, "cpu"), cfg, m)
        return (lambda toks: step(params, toks)[1]), step, params, None
    params = wl.shard_params(interop.params_from_numpy(tree, cfg, "cpu"),
                             cfg, m)
    if kind == "sgd":
        step, _, _ = wl.make_sharded_train_step(m, cfg, lr=1e-2)
        return (lambda toks: step(params, toks)[1]), step, params, None
    tx = optim.adamw(1e-3)
    if kind == "adamw":
        step, init, _, _ = wl.make_optax_train_step(m, cfg, tx)
    else:
        step, init, _, _ = wl.make_accum_train_step(m, cfg, tx, 2)
    state = init(params)
    return (lambda toks: step(params, state, toks)[2]), step, params, state


def _step_programs(step) -> dict:
    """A train step's programs by name: the one step program, or the
    accumulation's micro-step and update."""
    progs = step._programs.programs
    if isinstance(progs, tprogram.Program):
        return {"step": progs}
    if len(progs) == 3:
        return {"micro": progs[0], "update": progs[1]}
    return {"step": progs[0]}


def mesh_train_program_rank(m: tmesh.Mesh, cases: dict) -> dict:
    """The mesh train steps as chains, over meshes of this launch's ranks.
    Each case ``name -> (axis sizes, kind, cfg, numpy tree, global token
    batches)``: the losses of the step called as it is (its bodies, as on
    the CPU), the kinds of the collectives one call of each of its
    programs' bodies makes, in order (``counts``), and, from the same
    shards, the plan of each program built graphed (``Program(graphed=
    True)``: a :class:`CaptureRecorder` stands in for CUDA) over the same
    batches: its breaks, segments, the collectives of its warm-up, the
    breaks run, the capture modes and the log, in which each collective
    that runs (in a warm-up, or as a break between replays) is
    ``("run", kind)``."""
    torch.set_num_threads(1)
    meshes = {tuple(m.shape.items()): m}
    out = {}
    for name, (sizes, kind, cfg, tree, batches) in cases.items():
        mesh = _mesh_of(meshes, sizes)
        call, step, params, state = _mesh_train_step(mesh, kind, cfg, tree)
        losses = [float(call(torch.from_numpy(t).long())) for t in batches]
        tree_now = step._programs.tree
        tree_now.params, tree_now.state = params, state
        counts = {n: collectives_of(prog.body)
                  for n, prog in _step_programs(step).items()}
        tree_now.params = tree_now.state = None
        call, step, _, _ = _mesh_train_step(mesh, kind, cfg, tree)
        build = step._programs.build
        step._programs.build = (
            lambda *args, graphed, build=build: build(*args, graphed=True))
        recorder, real = CaptureRecorder(), tprogram._cuda
        run = tmesh.Collective.__call__

        def logged(c, run=run, recorder=recorder):
            recorder.log.append(("run", c.kind))
            run(c)

        tprogram._cuda, tmesh.Collective.__call__ = recorder, logged
        try:
            for t in batches:
                call(torch.from_numpy(t).long())
        finally:
            tprogram._cuda, tmesh.Collective.__call__ = real, run
        plans = {n: {"breaks": [b.kind for b in prog.breaks],
                     "segments": len(prog.segments),
                     "warmup_collectives": prog.warmup_collectives,
                     "breaks_run": prog.breaks_run}
                 for n, prog in _step_programs(step).items()}
        out[name] = {"losses": losses, "counts": counts, "plans": plans,
                     "log": recorder.log, "modes": recorder.modes,
                     "index": {a: mesh.coord[a] for a in sizes}}
    return out
