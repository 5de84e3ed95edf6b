"""Rank programs for the port's tensor- and data-parallel tests.

``tpusched_torch.mesh.launch`` runs each of these in every spawned gloo rank
on the CPU. This module imports torch, numpy and the port only, never JAX:
the ranks start from a fresh import of it, and the JAX reference runs in the
parent test process. Each program returns numpy arrays and Python values.
"""
from __future__ import annotations

import torch

from tpusched_torch import interop, mesh as tmesh, optim, workload as wl
from tpusched_torch.serve import ServeEngine


def _np_tree(tree):
    return wl.tree_map(lambda t: t.detach().float().numpy(), tree)


def mesh_rank(m: tmesh.Mesh, cfg: wl.ModelConfig, tree) -> dict:
    """Axis layout and collectives of a {"dp": 2, "tp": 2} mesh, and
    shard_params then gather_params of ``tree``."""
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
    return out


def _completions(eng: ServeEngine, reqs) -> dict:
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    return {"tokens": {c.rid: c.tokens.tolist() for c in done},
            "ticks": eng.tick_count,
            "spec_stats": dict(eng.spec_stats)}


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


def train_rank(m: tmesh.Mesh, cases: dict) -> dict:
    """Training on a {"dp": 2, "tp": 2} mesh. Each case ``name -> (kind,
    cfg, numpy tree, tokens)``: kind "sgd", "adamw" or "accum" runs two
    steps of the matching make_*_train_step on the GLOBAL tokens (a list of
    two batches, or of two accumulation stacks) and returns the losses and
    the gathered params (and the AdamW moments' dtypes); "grads" returns
    loss and gradients at tp = 2 (value_and_grad on the shards, gathered)
    and unsharded; "loss" returns the loss_fn at tp = 2."""
    torch.set_num_threads(1)
    out = {}
    for name, (kind, cfg, tree, tokens) in cases.items():
        params = interop.params_from_numpy(tree, cfg, "cpu")
        shards = wl.shard_params(params, cfg, m)
        if kind == "grads":
            toks = torch.from_numpy(tokens).long()
            loss, grads = wl.value_and_grad(shards, toks, cfg, tp=m.tp)
            ref_loss, ref = wl.value_and_grad(params, toks, cfg)
            out[name] = {"loss": float(loss), "ref_loss": float(ref_loss),
                         "grads": _np_tree(wl.gather_params(grads, cfg, m)),
                         "ref": _np_tree(ref)}
            continue
        if kind == "loss":
            with torch.no_grad():
                loss = wl.loss_fn(shards, torch.from_numpy(tokens).long(),
                                  cfg, tp=m.tp)
            out[name] = {"loss": float(loss)}
            continue
        losses, moments = [], None
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
        out[name] = {"losses": losses, "token_spec": tspec,
                     "dtypes": sorted({str(t.dtype)
                                       for t in wl.tree_leaves(shards)}),
                     "moments": moments,
                     "params": _np_tree(wl.gather_params(shards, cfg, m))}
    return out

