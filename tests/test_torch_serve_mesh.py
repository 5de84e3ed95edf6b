"""Serving over fully-sharded, sequence and pipeline axes: the port's
``ServeEngine(mesh=)`` on gloo ranks (CPU) against jaxbridge's
``ServeEngine(mesh=)`` on the same meshes of virtual CPU devices, with the
same weights (through ``interop``) and requests, completions AND tick
counts equal, on {"fsdp": 2, "tp": 2}, {"fsdp": 2}, {"sp": 2} and {"pp":
2}, plus speculative and MoE engines over fsdp. The reference shards the
engine's weights by ``param_specs`` alone (fsdp the weights, tp the arena)
and replicates everything else; the port gathers an fsdp-sharded layer
where it uses it, exactly, so its ranks compute one card's logits.

Also: an fsdp rank holds half of each matrix and of embed and out, and the
whole arena; every rank emits the same completions; a sampled engine over
fsdp equals the unsharded engine's draws with no broadcast over fsdp (the
ranks' logits are identical); and ``checkpoint.load_for_serving(mesh=)``
onto {"fsdp": 2, "tp": 2} serves the tokens the in-memory weights serve.
One spawn of four ranks and one of two (``torch_ranks.serve_mesh_rank``);
the ranks import no JAX."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_ranks
from tpusched.jaxbridge import mesh as jmeshlib
from tpusched.jaxbridge import serve as jserve
from tpusched.jaxbridge import workload as jwl
from tpusched_torch import checkpoint, interop, mesh as tmesh
from tpusched_torch import workload as wl
from tpusched_torch.serve import Request

torch.set_num_threads(1)

GEOMETRY = dict(slots=2, max_seq=64, prompt_bucket=16)
FSDP_TP = {"fsdp": 2, "tp": 2}


def _requests(seed, n, vocab):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(
        0, vocab, size=rng.integers(4, 14), dtype=np.int32),
        max_new_tokens=int(rng.integers(2, 7))) for i in range(n)]


# name -> (mesh, config changes, engine kwargs, requests seed)
CASES = {
    "fsdp_tp": (FSDP_TP, {}, {}, 3),
    "fsdp_tp_chunked": (FSDP_TP, {}, dict(chunk_prefill=6), 5),
    "fsdp_tp_speculative": (FSDP_TP, {}, dict(self_draft=True, spec_k=3), 7),
    "fsdp": ({"fsdp": 2}, {}, {}, 3),
    "sp": ({"sp": 2}, {}, {}, 3),
    "pp": ({"pp": 2}, {}, {}, 3),
    "fsdp_moe": ({"fsdp": 2}, dict(n_experts=4), {}, 9),
    "fsdp_int8": ({"fsdp": 2}, dict(kv_cache_dtype="int8"), {}, 11),
    "fsdp_sampled": ({"fsdp": 2}, {}, dict(temperature=0.8, top_k=24,
                                          seed=5), 13),
}
REFERENCE_CASES = [n for n in CASES if n != "fsdp_sampled"]


def _case(name):
    sizes, changes, kw, seed = CASES[name]
    jcfg = dataclasses.replace(jwl.ModelConfig.tiny(), **changes)
    cfg = dataclasses.replace(wl.ModelConfig.tiny(), **changes)
    jp = jwl.init_params(jax.random.PRNGKey(0), jcfg)
    return (sizes, jcfg, jp, cfg, jax.tree.map(np.asarray, jp), kw,
            _requests(seed, 4, cfg.vocab))


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Every case on its ranks: {"fsdp": 2, "tp": 2} cases and the
    snapshot on four, the two-rank meshes on two; each rank's results."""
    root = tmp_path_factory.mktemp("serve_mesh")
    sizes, _, _, cfg, tree, _, reqs = _case("fsdp_tp")
    checkpoint.export_for_serving(
        str(root), interop.params_from_numpy(tree, cfg, "cpu"), cfg)
    by_world = {4: {"snapshot": (sizes, cfg, None, {}, reqs)}, 2: {}}
    for name in CASES:
        sizes, _, _, cfg, tree, kw, reqs = _case(name)
        by_world[int(np.prod(list(sizes.values())))][name] = (
            sizes, cfg, tree, kw, reqs)
    out = {}
    for world, cases in by_world.items():
        first = next(iter(cases.values()))[0]
        ranks = tmesh.launch(torch_ranks.serve_mesh_rank, first, str(root),
                             cases, backend="gloo", device="cpu",
                             workdir=str(root))
        for name in cases:
            out[name] = [rank[name] for rank in ranks]
    return out


def _reference(name):
    """jaxbridge's engine on the case's mesh of virtual CPU devices."""
    sizes, jcfg, jp, _, _, kw, reqs = _case(name)
    kw = dict(kw)
    if kw.pop("self_draft", False):
        kw.update(draft_params=jp, draft_cfg=jcfg)
    eng = jserve.ServeEngine(jp, jcfg, mesh=jmeshlib.build_named_mesh(sizes),
                             **GEOMETRY, **kw)
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    return ({c.rid: np.asarray(c.tokens).tolist() for c in done},
            eng.tick_count, dict(eng.spec_stats))


@pytest.mark.parametrize("name", REFERENCE_CASES)
def test_mesh_engine_matches_reference_mesh_engine(served, name):
    """Completions and tick counts equal jaxbridge's engine on the same
    mesh (and a speculative engine's round statistics)."""
    got = served[name][0]
    tokens, ticks, spec_stats = _reference(name)
    assert got["tokens"] == tokens
    assert got["ticks"] == ticks
    if name.endswith("speculative"):
        assert got["spec_stats"] == spec_stats
        assert spec_stats["accepted"] > 0.5 * spec_stats["drafted"]


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_agree_and_hold_their_shards(served, name):
    """Every rank emits the same completions in the same ticks. Each holds
    its shard of every leaf by ``param_specs``: over fsdp half of every
    matrix, embed and out; the arena is whole over fsdp, split over tp."""
    sizes, _, _, cfg, tree, _, _ = _case(name)
    runs = served[name]
    for run in runs[1:]:
        assert (run["tokens"], run["ticks"]) == (runs[0]["tokens"],
                                                 runs[0]["ticks"])
    layout = tmesh.Mesh(sizes)
    shapes, over_fsdp = [], []
    wl.tree_map(lambda x, spec: (
        shapes.append(wl.shard_shape(x.shape, spec, layout)),
        over_fsdp.append("fsdp" in spec)),
        interop.params_from_numpy(tree, cfg, "cpu"),
        wl.param_specs(cfg, layout))
    assert runs[0]["shapes"] == shapes
    # every matrix of a layer (7, the router excepted), embed and out
    assert sum(over_fsdp) == (7 * cfg.n_layers + 2 if "fsdp" in sizes else 0)
    assert runs[0]["kv_heads"] == cfg.kv_heads // sizes.get("tp", 1)


def test_sampled_fsdp_engine_needs_no_broadcast(served):
    """At temperature 0.8 over fsdp (no model axis, so no host decision is
    broadcast) both ranks and the unsharded engine draw the same tokens:
    the gathered weights are the whole ones bit for bit, so are the
    logits, and the generators are seeded alike."""
    runs = served["fsdp_sampled"]
    for run in runs:
        assert run["tokens"] == run["solo"]["tokens"]
        assert run["ticks"] == run["solo"]["ticks"]
    assert runs[0]["tokens"] != served["fsdp"][0]["tokens"]


def test_load_for_serving_onto_fsdp_tp_serves_the_same_tokens(served):
    """The snapshot read as {"fsdp": 2, "tp": 2} shards (each leaf at its
    shard's shape, no whole tree on any rank) serves what the in-memory
    weights serve on that mesh, on every rank."""
    for snap, mem in zip(served["snapshot"], served["fsdp_tp"]):
        assert snap["shapes"] == mem["shapes"]
        assert snap["tokens"] == mem["tokens"]
        assert snap["ticks"] == mem["ticks"]
