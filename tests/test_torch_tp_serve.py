"""Tensor-parallel serving: the port's ``ServeEngine(mesh=)`` at tp = 2 on two
gloo ranks (CPU) against jaxbridge's ``ServeEngine(mesh=)`` on a tp = 2
virtual CPU mesh, with the same weights (through ``interop``) and the same
requests: completions AND tick counts equal in every mode the reference's
own tp tests serve (tests/test_serve.py: plain, chunked, prefix, int8,
greedy speculative with a self-draft on the mesh, request-keyed sampled),
plus an MoE engine. One spawn of two ranks serves every case
(``torch_ranks.serve_rank``); the ranks import no JAX. Request-keyed draws
are the port's own convention (not threefry), so that case is held to the
port's unsharded engine, as the reference's is to its own.

The mesh guards raise the reference's messages, checked in-process on a
layout mesh (``Mesh({"tp": 2})``: the guards fire before any collective)."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

import torch_ranks
from tpusched.jaxbridge import serve as jserve
from tpusched.jaxbridge import workload as jwl
from tpusched_torch import mesh as tmesh, workload as wl
from tpusched_torch.serve import Request, ServeEngine

torch.set_num_threads(1)

GEOMETRY = dict(slots=2, max_seq=64, prompt_bucket=16)


def _cfgs(**changes):
    return (dataclasses.replace(jwl.ModelConfig.tiny(), **changes),
            dataclasses.replace(wl.ModelConfig.tiny(), **changes))


def _prompt(rng, lo, hi, vocab):
    return rng.integers(0, vocab, size=rng.integers(lo, hi), dtype=np.int32)


def _requests(seed, n, lo, hi, new_lo, new_hi, vocab, prefix_id=None):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=_prompt(rng, lo, hi, vocab),
                    max_new_tokens=int(rng.integers(new_lo, new_hi)),
                    prefix_id=prefix_id) for i in range(n)]


# name -> (config changes, engine kwargs, requests seed and shape, prefix
# length): the reference's tp tests' geometry and draws, and an MoE case
CASES = {
    "plain": ({}, {}, (9, 4, 4, 12, 2, 6), 0),
    "chunked": ({}, dict(chunk_prefill=6), (17, 4, 6, 16, 2, 6), 0),
    "prefix": ({}, dict(chunk_prefill=6), (29, 3, 4, 10, 2, 5), 9),
    "int8": (dict(kv_cache_dtype="int8"), {}, (37, 4, 4, 12, 5, 6), 0),
    "speculative": ({}, dict(self_draft=True, spec_k=3), (17, 5, 3, 14, 3, 8),
                    0),
    "request_keyed": ({}, dict(temperature=0.8, top_k=24, seed=5,
                               request_keyed=True), (67, 4, 3, 12, 5, 6), 0),
    "moe": (dict(n_experts=4), {}, (41, 4, 4, 12, 2, 6), 0),
}


def _case(name):
    changes, kw, (seed, n, lo, hi, new_lo, new_hi), prefix_len = CASES[name]
    jcfg, cfg = _cfgs(**changes)
    jp = jwl.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(seed + 1000)
    prefix = (rng.integers(0, cfg.vocab, prefix_len, dtype=np.int32)
              if prefix_len else None)
    reqs = _requests(seed, n, lo, hi, new_lo, new_hi, cfg.vocab,
                     "sys" if prefix_len else None)
    return jcfg, jp, cfg, tree, kw, reqs, prefix


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Every case served by the port at tp = 2, both ranks' results."""
    cases = {}
    for name in CASES:
        _, _, cfg, tree, kw, reqs, prefix = _case(name)
        cases[name] = (cfg, tree, kw, reqs, prefix)
    return tmesh.launch(torch_ranks.serve_rank, {"tp": 2}, cases,
                        backend="gloo", device="cpu",
                        workdir=str(tmp_path_factory.mktemp("ranks")))


def _reference(name):
    """jaxbridge's engine on a tp = 2 mesh of virtual CPU devices."""
    jcfg, jp, _, _, kw, reqs, prefix = _case(name)
    kw = dict(kw)
    if kw.pop("self_draft", False):
        kw.update(draft_params=jp, draft_cfg=jcfg)
    mesh = JMesh(np.array(jax.devices()[:2]), ("tp",))
    eng = jserve.ServeEngine(jp, jcfg, mesh=mesh, **GEOMETRY, **kw)
    if prefix is not None:
        eng.register_prefix("sys", prefix)
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    return ({c.rid: np.asarray(c.tokens).tolist() for c in done},
            eng.tick_count, dict(eng.spec_stats))


@pytest.mark.parametrize("name", [n for n in CASES if n != "request_keyed"])
def test_tp_engine_matches_reference_tp_engine(served, name):
    """Completions and tick counts equal jaxbridge's tp = 2 engine's (and
    the speculative engine's round statistics too)."""
    got = served[0][name]["tp"]
    tokens, ticks, spec_stats = _reference(name)
    assert got["tokens"] == tokens
    assert got["ticks"] == ticks
    if name == "speculative":
        assert got["spec_stats"] == spec_stats
        assert spec_stats["accepted"] > 0.5 * spec_stats["drafted"]


def test_request_keyed_tp_engine_matches_unsharded(served):
    """Request-keyed sampling at tp = 2 equals the unsharded engine's
    stream for every request, ticks included, as the reference's
    test_request_keyed_composes_with_tp_mesh holds its own."""
    runs = served[0]["request_keyed"]
    assert runs["tp"]["tokens"] == runs["solo"]["tokens"]
    assert runs["tp"]["ticks"] == runs["solo"]["ticks"]


@pytest.mark.parametrize("name", list(CASES))
def test_ranks_agree(served, name):
    """Both ranks emit the same completions in the same ticks, and each
    holds kv_heads/tp heads of the arena (with its scale planes, int8)."""
    a, b = served[0][name], served[1][name]
    assert a["tp"] == b["tp"]
    _, cfg = _cfgs(**CASES[name][0])
    assert a["kv_heads"] == b["kv_heads"] == cfg.kv_heads // 2
    assert a["scale_planes"] == (name == "int8")


def _error(make):
    try:
        make()
    except (ValueError, NotImplementedError) as e:
        return type(e), str(e)
    return None


@pytest.mark.parametrize("what", ["kv_heads", "vocab_parallel_loss",
                                  "draft_kv_heads"])
def test_mesh_guards_raise_the_reference_messages(what):
    """kv_heads % tp, the vocab-parallel loss and the draft's kv_heads % tp
    are refused with the reference's ValueError and message."""
    draft = {}
    changes = dict(vocab_parallel_loss=True) if what == "vocab_parallel_loss" \
        else {}
    if what == "kv_heads":
        changes = dict(n_heads=4, n_kv_heads=1)
    jcfg, cfg = _cfgs(**changes)
    jp = jwl.init_params(jax.random.PRNGKey(0), jcfg)
    p = wl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jdraft = cfg_draft = None
    if what == "draft_kv_heads":
        jdraft, cfg_draft = _cfgs(n_heads=4, n_kv_heads=1)
        draft = dict(draft_params=wl.init_params(
            cfg_draft, torch.Generator().manual_seed(1), "cpu"),
            draft_cfg=cfg_draft)
    mesh = JMesh(np.array(jax.devices()[:2]), ("tp",))
    jdraft_kw = ({} if jdraft is None else dict(
        draft_params=jwl.init_params(jax.random.PRNGKey(1), jdraft),
        draft_cfg=jdraft))
    want = _error(lambda: jserve.ServeEngine(jp, jcfg, mesh=mesh, **GEOMETRY,
                                             **jdraft_kw))
    got = _error(lambda: ServeEngine(
        p, cfg, mesh=tmesh.Mesh({"tp": 2}, device="cpu"), device="cpu",
        **GEOMETRY, **draft))
    assert want is not None and want[0] is ValueError
    assert got == want


def test_a_mesh_without_tp_serves_replicated():
    """A dp-only mesh shards nothing: every leaf and the arena are whole,
    and the engine serves as the unsharded one does (no collective runs)."""
    cfg = wl.ModelConfig.tiny()
    p = wl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    reqs = _requests(9, 4, 4, 12, 2, 6, cfg.vocab)
    runs = []
    for mesh in (tmesh.Mesh({"dp": 2}, rank=1, device="cpu"), None):
        eng = ServeEngine(p, cfg, mesh=mesh, device="cpu", **GEOMETRY)
        for r in reqs:
            eng.submit(r)
        runs.append(({c.rid: c.tokens.tolist()
                      for c in eng.run_until_drained()}, eng.tick_count))
        assert eng.cache[0]["k"].shape[2] == cfg.kv_heads
    assert runs[0] == runs[1]
