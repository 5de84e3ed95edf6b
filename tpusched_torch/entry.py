"""The entry points: a forward step, and one step of every parallel
path on a mesh of n ranks, each checked against one process.

Counterpart of ``__graft_entry__.py``. :func:`entry` is the tiny forward
step; :func:`dryrun_multichip` runs the reference's seven checked blocks
with its meshes, sizes and tolerances, and seeds of its own:

1. the dense model (tiny, ring-flash attention) on dp/fsdp/sp/tp, one SGD
   step, its loss within 2e-3 of one process's naive-attention loss;
2. the MoE model (4 experts, top-2) on dp/ep/tp, within 1e-3;
3. the GPipe pipeline on pp/dp (2 microbatches), within 1e-3;
4. the engine at tp 2 (chunked prefill) against solo greedy ``generate``;
5. the speculative engine at tp 2 with a self-draft against the plain
   engine on one process, with near-total acceptance;
6. int8-KV ``generate`` over tp-sharded params against one process's;
7. train on dp/tp, ``export_for_serving``, ``load_for_serving`` as tp
   shards and serve, against solo ``generate`` on the same weights.

Each block is a module-level function that takes numpy params and tokens
and runs on every rank of a mesh (``mesh.launch``); the single-process
references run in the calling process. Blocks 1-3 share one launch of n
ranks, blocks 4-7's serving one launch of 2; block 7's training runs on
its own mesh ({"dp": 2, "tp": 2} when n divides by 4, else {"tp": 2}),
one more launch, before the caller exports its weights. Run it as

    python -m tpusched_torch.entry [--device cpu] [--backend gloo] [n]

``backend="nccl"`` (the default) runs one card a rank and raises when there
are fewer cards than ranks; ``backend="gloo"`` runs every rank on
``device``, sharing it. Every entry point runs on the card unless the
caller passes ``device="cpu"``.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import math
import sys
import tempfile
from typing import Dict, List, Optional

import numpy as np
import torch

from . import attention, checkpoint
from .decode import generate
from .interop import params_from_numpy, pipeline_params_from_numpy
from .mesh import BATCH_AXES, Mesh, build_named_mesh, factor_mesh, launch
from .pipeline import make_pipeline_train_step, shard_pipeline_params
from .serve import Request, ServeEngine
from .workload import (ModelConfig, forward, gather_params, init_params,
                       loss_fn, make_sharded_train_step, resolve_device,
                       shard_params, tree_map)

DENSE_RTOL = 2e-3
MOE_RTOL = 1e-3
PP_RTOL = 1e-3
PP_MICRO = 2
SERVE_GEOMETRY = dict(slots=2, max_seq=64, prompt_bucket=16)
SERVE_MESH = {"tp": 2}


def entry(device=None):
    """The tiny forward step: ``(fn, (params, tokens))`` with ``fn(params,
    tokens)`` the logits (4, 128, 2048). The reference's config (vocab
    2048, d_model 256, 2 layers, 4 heads, d_ff 512, seq 128, f32, naive
    attention); weights from a CPU generator seeded 0, so the card's equal
    the CPU's; zero tokens on the device."""
    device = resolve_device(device)
    cfg = ModelConfig(vocab=2048, d_model=256, n_layers=2, n_heads=4,
                      d_ff=512, seq=128)
    params = init_params(cfg, torch.Generator().manual_seed(0), device)
    tokens = torch.zeros((4, cfg.seq), dtype=torch.long, device=device)
    return functools.partial(forward, cfg=cfg), (params, tokens)


def dense_mesh_shape(n_devices: int) -> Dict[str, int]:
    """The dense block's mesh, as the reference picks it: dp × fsdp 2 × sp
    2 × tp 2 when n divides by 8, dp × sp 2 × tp 2 when by 4, else the
    dp × tp of ``mesh.factor_mesh`` (6 ranks: dp 3, tp 2)."""
    if n_devices >= 8 and n_devices % 8 == 0:
        return {"dp": n_devices // 8, "fsdp": 2, "sp": 2, "tp": 2}
    if n_devices % 4 == 0:
        return {"dp": n_devices // 4, "sp": 2, "tp": 2}
    dp, tp = factor_mesh(n_devices)
    return {"dp": dp, "tp": tp}


def batch_rows(axis_sizes: Dict[str, int]) -> int:
    """The rows a batch of the mesh takes, as the reference sizes it: the
    product of its batch axes, at least 2 (identical rows would let a
    dropped collective give the right loss by accident)."""
    return max(2, math.prod(axis_sizes.get(a, 1) for a in BATCH_AXES))


def check_loss(n_devices: int, name: str, got: float, want: float,
               rtol: float) -> str:
    """A mesh's loss against one process's: the reference's OK line, or
    its RuntimeError on drift (a sharding that silently computes other
    math fails here, not in a later training run)."""
    got, want = float(got), float(want)
    if not abs(got - want) <= rtol * max(abs(want), 1e-6):
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) {name}: sharded loss "
            f"{got:.6f} != single-device reference {want:.6f} "
            f"(rtol {rtol})")
    return (f"dryrun_multichip({n_devices}): {name} loss={got:.6f} "
            f"(ref {want:.6f}) OK")


# -- blocks: every rank of a mesh runs one; numpy in, Python values out ------


def _launches():
    return (attention.FLASH_FWD_LAUNCHES, attention.FLASH_BWD_DKDV_LAUNCHES,
            attention.FLASH_BWD_DQ_LAUNCHES)


def _tokens(tokens, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(tokens, dtype=np.int64)).to(device)


def train_block(mesh: Mesh, cfg: ModelConfig, params, tokens) -> dict:
    """Blocks 1 and 2: one ``make_sharded_train_step`` SGD step on
    ``mesh`` from the whole numpy ``params`` and global ``tokens``. Returns
    the loss, this rank's sp index and its flash kernel launches (K1, K2,
    K3) in the step."""
    step, _, _ = make_sharded_train_step(mesh, cfg)
    shards = shard_params(params_from_numpy(params, cfg, mesh.device), cfg,
                          mesh)
    before = _launches()
    _, loss = step(shards, _tokens(tokens, mesh.device))
    return {"loss": float(loss),
            "sp_index": mesh.sp.index if mesh.sp is not None else 0,
            "launches": tuple(a - b for a, b in zip(_launches(), before))}


def pipeline_block(mesh: Mesh, cfg: ModelConfig, params, tokens,
                   n_micro: int = PP_MICRO) -> dict:
    """Block 3: one GPipe SGD step on ``mesh`` (pp and others) from the
    whole numpy ``params``. Returns the loss and this rank's stage."""
    step, _, _ = make_pipeline_train_step(mesh, cfg, n_micro)
    shards = shard_pipeline_params(
        pipeline_params_from_numpy(params, cfg, mesh.device), cfg, mesh)
    _, loss = step(shards, _tokens(tokens, mesh.device))
    return {"loss": float(loss), "stage": mesh.pp.index}


def serve_block(mesh: Optional[Mesh], cfg: ModelConfig, params, prompts,
                max_new_tokens: int, self_draft: bool = False,
                device=None, **engine_kw) -> dict:
    """Blocks 4 and 5: the engine (``SERVE_GEOMETRY``, ``engine_kw``) on
    ``mesh``, or on ``device`` without one, serving one request a prompt;
    ``self_draft`` drafts with the target's own weights. Returns each
    request's tokens and the speculative counts."""
    tree = params_from_numpy(params, cfg,
                             mesh.device if mesh is not None else device)
    if self_draft:
        engine_kw.update(draft_params=tree, draft_cfg=cfg)
    eng = ServeEngine(tree, cfg, mesh=mesh, device=device, **SERVE_GEOMETRY,
                      **engine_kw)
    for rid, prompt in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                           max_new_tokens=max_new_tokens))
    return {"tokens": {c.rid: c.tokens.tolist()
                       for c in eng.run_until_drained()},
            "spec_stats": dict(eng.spec_stats)}


def generate_block(mesh: Optional[Mesh], cfg: ModelConfig, params, prompt,
                   steps: int, device=None) -> List[List[int]]:
    """Block 6: greedy ``generate`` of the prompts (b, s) over this rank's
    tp shards of ``params`` on ``mesh``, or whole on ``device``."""
    device = mesh.device if mesh is not None else device
    tree = params_from_numpy(params, cfg, device)
    tp = None
    if mesh is not None:
        tree, tp = shard_params(tree, cfg, mesh), mesh.tp
    return generate(tree, _tokens(prompt, device), cfg, steps,
                    tp=tp).tolist()


def handoff_train_block(mesh: Mesh, cfg: ModelConfig, params,
                        tokens) -> dict:
    """Block 7's training: one SGD step on ``mesh``; the whole trained
    params as numpy (every rank gathers them)."""
    step, _, _ = make_sharded_train_step(mesh, cfg)
    shards = shard_params(params_from_numpy(params, cfg, mesh.device), cfg,
                          mesh)
    trained, _ = step(shards, _tokens(tokens, mesh.device))
    return tree_map(lambda t: t.detach().cpu().numpy(),
                    gather_params(trained, cfg, mesh))


def handoff_serve_block(mesh: Mesh, cfg: ModelConfig, directory: str,
                        prompts, max_new_tokens: int) -> dict:
    """Block 7's serving: the snapshot under ``directory`` read as this
    rank's shards (``load_for_serving(mesh=)``) and served by the engine
    on ``mesh``, one request a prompt. Returns each request's tokens."""
    shards = checkpoint.load_for_serving(directory, cfg, mesh=mesh)
    eng = ServeEngine(shards, cfg, mesh=mesh, **SERVE_GEOMETRY)
    for rid, prompt in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                           max_new_tokens=max_new_tokens))
    return {"tokens": {c.rid: c.tokens.tolist()
                       for c in eng.run_until_drained()}}


def run_blocks(mesh: Mesh, blocks) -> Dict[str, object]:
    """A launch's rank program: each block ``(name, axis sizes, fn, args,
    kwargs)`` run as ``fn(mesh of those sizes, *args, **kwargs)``, the
    meshes built over this launch's ranks once each. Returns the results
    by name."""
    meshes = {tuple(mesh.shape.items()): mesh}
    backend = torch.distributed.get_backend()
    out = {}
    for name, sizes, fn, args, kwargs in blocks:
        key = tuple(sizes.items())
        if key not in meshes:
            meshes[key] = build_named_mesh(sizes, backend, mesh.device)
        out[name] = fn(meshes[key], *args, **kwargs)
    return out


# -- the dry run -------------------------------------------------------------


def _numpy_params(cfg: ModelConfig, seed: int):
    """Whole f32 weights from a CPU generator seeded ``seed``, as numpy."""
    return tree_map(lambda t: t.numpy(), init_params(
        cfg, torch.Generator().manual_seed(seed), "cpu"))


def _seeded_tokens(cfg: ModelConfig, rows: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, cfg.vocab, (rows, cfg.seq))


def _tiny(**changes) -> ModelConfig:
    return dataclasses.replace(ModelConfig.tiny(), **changes)


def _whole_loss(cfg: ModelConfig, params, tokens, device) -> float:
    with torch.no_grad():
        return float(loss_fn(params_from_numpy(params, cfg, device),
                             _tokens(tokens, device), cfg))


def _solo(cfg, params, prompt, steps, device) -> List[int]:
    """One process's greedy tokens for one prompt."""
    return generate_block(None, cfg, params, np.asarray(prompt)[None], steps,
                          device=device)[0]


def dryrun_multichip(n_devices: int, *, backend: str = "nccl", device=None,
                     workdir: Optional[str] = None) -> Dict[str, dict]:
    """The seven blocks of the module docstring on ``n_devices`` ranks: the
    dense block always, the MoE and pipeline blocks when n divides by 8,
    the four serving blocks when n >= 2. Prints the reference's line for
    each and raises its RuntimeError on drift. ``backend`` as
    :func:`mesh.build_named_mesh` takes it ("gloo": every rank on
    ``device``); the single-process references run here on ``device``;
    the ranks meet in temporary directories under ``workdir``. Returns
    each block's results (every rank's, and the reference's)."""
    device = resolve_device(device)
    if backend == "nccl":
        if torch.cuda.device_count() < n_devices:
            raise ValueError(
                f"backend='nccl' runs one card per rank: {n_devices} ranks, "
                f"{torch.cuda.device_count()} card(s); pass backend='gloo' "
                f"to share cards through the host")
        rank_device = None
    elif backend == "gloo":
        rank_device = device
    else:
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    n = n_devices

    def run(sizes, blocks):
        return launch(run_blocks, sizes, blocks, backend=backend,
                      device=rank_device, workdir=workdir)

    out: Dict[str, dict] = {}

    def report(name, line, **fields):
        print(line)
        out[name] = {"line": line, **fields}

    # blocks 1-3: one launch of n ranks
    dense_cfg = _tiny(attn="ringflash")
    dense_mesh = dense_mesh_shape(n)
    dense = (_numpy_params(dense_cfg, 0),
             _seeded_tokens(dense_cfg, batch_rows(dense_mesh), 7))
    blocks = [("dense", dense_mesh, train_block, (dense_cfg, *dense), {})]
    if n % 8 == 0:
        moe_cfg = _tiny(n_experts=4, moe_top_k=2)
        moe_mesh = {"dp": n // 4, "ep": 2, "tp": 2}
        moe = (_numpy_params(moe_cfg, 1),
               _seeded_tokens(moe_cfg, max(2, n // 4), 8))
        pp_cfg = _tiny()
        pp_mesh = {"pp": 2, "dp": n // 2}
        pp = (_numpy_params(pp_cfg, 2),
              _seeded_tokens(pp_cfg, 2 * max(2, n // 2), 9))
        blocks += [("moe", moe_mesh, train_block, (moe_cfg, *moe), {}),
                   ("pipeline", pp_mesh, pipeline_block, (pp_cfg, *pp), {})]
    ranks = run(dense_mesh, blocks)
    ref = _whole_loss(dataclasses.replace(dense_cfg, attn="naive"), *dense,
                      device)
    got = ranks[0]["dense"]["loss"]
    report("dense", check_loss(n, f"dense mesh={dense_mesh}", got, ref,
                               DENSE_RTOL),
           mesh=dense_mesh, loss=got, ref=ref,
           ranks=[r["dense"] for r in ranks])
    if n % 8 == 0:
        for name, sizes, cfg, data, rtol, label in (
                ("moe", moe_mesh, moe_cfg, moe, MOE_RTOL, "moe"),
                ("pipeline", pp_mesh, pp_cfg, pp, PP_RTOL, "pipeline")):
            ref = _whole_loss(cfg, *data, device)
            got = ranks[0][name]["loss"]
            report(name, check_loss(n, f"{label} mesh={sizes}", got, ref,
                                    rtol),
                   mesh=sizes, loss=got, ref=ref,
                   ranks=[r[name] for r in ranks])
    if n < 2:
        return out

    # blocks 4-7: the prompts as the reference draws them, in its order
    cfg = _tiny()
    i8_cfg = _tiny(kv_cache_dtype="int8")
    rng = np.random.default_rng(11)
    serve_prompts = [rng.integers(0, cfg.vocab, 8, dtype=np.int32)
                     for _ in range(3)]
    spec_prompts = [rng.integers(0, cfg.vocab, 7, dtype=np.int32)
                    for _ in range(3)]
    i8_prompt = rng.integers(0, cfg.vocab, (2, 12), dtype=np.int32)
    handoff_prompts = [rng.integers(0, cfg.vocab, 9, dtype=np.int32)
                       for _ in range(2)]
    serve_params = _numpy_params(cfg, 3)
    train_mesh = ({"dp": 2, "tp": 2} if n % 4 == 0 else dict(SERVE_MESH))
    handoff = (_numpy_params(cfg, 5),
               _seeded_tokens(cfg, max(2, train_mesh.get("dp", 1)), 6))
    trained = run(train_mesh, [("train", train_mesh, handoff_train_block,
                                (cfg, *handoff), {})])[0]["train"]
    with tempfile.TemporaryDirectory(dir=workdir) as snapshot:
        checkpoint.export_for_serving(
            snapshot, params_from_numpy(trained, cfg, device), cfg, step=1)
        ranks = run(SERVE_MESH, [
            ("tp-serve", SERVE_MESH, serve_block,
             (cfg, serve_params, serve_prompts, 4), dict(chunk_prefill=5)),
            ("tp-speculative", SERVE_MESH, serve_block,
             (cfg, serve_params, spec_prompts, 5),
             dict(self_draft=True, spec_k=3)),
            ("tp-int8kv", SERVE_MESH, generate_block,
             (i8_cfg, serve_params, i8_prompt, 6), {}),
            ("handoff", SERVE_MESH, handoff_serve_block,
             (cfg, snapshot, handoff_prompts, 4), {})])
        host_trained = tree_map(
            lambda t: t.cpu().numpy(),
            checkpoint.load_for_serving(snapshot, cfg, device=device))
    got = ranks[0]

    for rid, prompt in enumerate(serve_prompts):
        if got["tp-serve"]["tokens"][rid] != _solo(cfg, serve_params, prompt,
                                                   3, device):
            raise RuntimeError(
                f"dryrun_multichip({n}) tp-serve: request {rid} diverged "
                f"from single-device greedy")
    report("tp-serve", f"dryrun_multichip({n}): tp-serve mesh={SERVE_MESH} "
           f"greedy parity over {len(serve_prompts)} requests OK",
           tokens=got["tp-serve"]["tokens"])

    plain = serve_block(None, cfg, serve_params, spec_prompts, 5,
                        device=device)
    spec = got["tp-speculative"]
    if spec["tokens"] != plain["tokens"]:
        raise RuntimeError(
            f"dryrun_multichip({n}) tp-speculative: token streams diverged "
            f"from the plain engine")
    stats = spec["spec_stats"]
    acc = stats["accepted"] / max(1, stats["drafted"])
    if acc < 0.5:      # self-draft: acceptance must be near-total
        raise RuntimeError(
            f"dryrun_multichip({n}) tp-speculative: acceptance {acc:.2f} — "
            f"the accept path did not engage")
    report("tp-speculative", f"dryrun_multichip({n}): tp-speculative mesh="
           f"{SERVE_MESH} parity over {len(spec_prompts)} requests (accept "
           f"{acc:.2f}) OK", tokens=spec["tokens"], spec_stats=stats)

    solo = generate_block(None, i8_cfg, serve_params, i8_prompt, 6,
                          device=device)
    if got["tp-int8kv"] != solo:
        raise RuntimeError(
            f"dryrun_multichip({n}) tp-int8kv: sharded quantized decode "
            f"diverged from single-device int8")
    report("tp-int8kv", f"dryrun_multichip({n}): tp-int8kv mesh="
           f"{SERVE_MESH} greedy parity OK", tokens=got["tp-int8kv"])

    for rid, prompt in enumerate(handoff_prompts):
        if got["handoff"]["tokens"][rid] != _solo(cfg, host_trained, prompt,
                                                  3, device):
            raise RuntimeError(
                f"dryrun_multichip({n}) handoff: request {rid} diverged "
                f"after train→export→serve")
    report("handoff", f"dryrun_multichip({n}): train→export→serve handoff "
           f"(train mesh={train_mesh} → serve mesh={SERVE_MESH}) greedy "
           f"parity OK", tokens=got["handoff"]["tokens"])
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m tpusched_torch.entry",
        description="entry()'s forward, then dryrun_multichip(n).")
    parser.add_argument("n", nargs="?", type=int, default=8,
                        help="ranks (default 8)")
    parser.add_argument("--device", default=None,
                        help="'cpu' to run there (default: the card)")
    parser.add_argument("--backend", default="nccl", choices=("nccl", "gloo"),
                        help="nccl: one card a rank; gloo: ranks share "
                             "--device")
    args = parser.parse_args(argv)
    fn, fargs = entry(args.device)
    with torch.no_grad():
        out = fn(*fargs)
    print("entry forward:", tuple(out.shape))
    dryrun_multichip(args.n, backend=args.backend, device=args.device)
    return 0


if __name__ == "__main__":
    # through the package's module, so the spawned ranks unpickle its
    # functions by their package names
    from tpusched_torch import entry as _entry
    sys.exit(_entry.main())
