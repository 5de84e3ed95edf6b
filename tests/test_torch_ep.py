"""Expert parallelism (ep): the port's MoE steps and engine on meshes of
gloo ranks (CPU) against jaxbridge's on the same meshes of virtual CPU
devices, f32 tiny with 4 experts, top-2.

Training, one spawn of eight ranks (``torch_ranks.sharded_train_rank``):
on {"dp": 2, "ep": 2, "tp": 2} an SGD step against jaxbridge's
``make_sharded_train_step`` and the global loss and every gradient leaf
against jaxbridge's whole-batch ``value_and_grad``, at capacity factor 1.25
and at 0.5, where the reference drops slots (without drops a wrong rank
order could not show: an expert's capacity slots are interchangeable);
the same on {"ep": 2, "sp": 2, "tp": 2} with ring-flash, the reference's
``test_moe_ringflash_full_matrix_mesh`` mesh, where the aux must count
once; AdamW accumulation on dp×ep×tp against optax. Every leaf within
1e-5 of its largest entry. AdamW's first step moves an element by about
lr·g/(|g| + 1e-8), so where the accumulated gradient is below 1e-7 the
step's size is set by the gradient's last bits (on this batch one wq
element, |g| 3.9e-9, which jaxbridge's own dp×ep×tp and unsharded steps
put 4.8e-5 apart): there the parameters are held within 2·lr, the most
one step can move an element.

Serving, one spawn of four ranks (``torch_ranks.serve_rank``): the ep
engine on {"ep": 2, "tp": 2} against jaxbridge's ``ServeEngine(mesh=)`` on
the same virtual mesh, completions and ticks, monolithic and chunked.

In-process on layout meshes: the shards' shapes under ep and the refusal
of an ep that does not divide the experts."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh as JMesh

import torch_ranks
from test_torch_tp_serve import GEOMETRY, _requests
from test_torch_tp_train import _assert_leaves_close, _cfgs, _named
from tpusched.jaxbridge import mesh as jmeshlib
from tpusched.jaxbridge import serve as jserve
from tpusched.jaxbridge import workload as jwl
from tpusched_torch import mesh as tmesh, workload as wl
from tpusched_torch.serve import ServeEngine

torch.set_num_threads(1)

RTOL = 1e-5
LR = 1e-3
DP_EP_TP = {"dp": 2, "ep": 2, "tp": 2}
EP_SP_TP = {"ep": 2, "sp": 2, "tp": 2}
MOE = dict(n_experts=4, moe_top_k=2)


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(
        0, wl.ModelConfig.tiny().vocab, shape, dtype=np.int32)


# name -> (mesh, kind, config changes, param seed, global batch)
CASES = {
    "sgd_cf1.25": (DP_EP_TP, "sgd", {}, 1, [_tokens((4, 32), 10)]),
    "sgd_cf0.5": (DP_EP_TP, "sgd", dict(moe_capacity_factor=0.5), 1,
                  [_tokens((4, 32), 10)]),
    "sgd_ep_sp_ringflash": (EP_SP_TP, "sgd", dict(attn="ringflash"), 2,
                            [_tokens((2, 32), 20)]),
    "accum": (DP_EP_TP, "accum", {}, 3, [_tokens((3, 4, 32), 30)]),
    "grads_cf1.25": (DP_EP_TP, "mesh_grads", {}, 1, _tokens((4, 32), 10)),
    "grads_cf0.5": (DP_EP_TP, "mesh_grads", dict(moe_capacity_factor=0.5),
                    1, _tokens((4, 32), 10)),
    "grads_ep_sp_ringflash": (EP_SP_TP, "mesh_grads", dict(
        attn="ringflash"), 2, _tokens((2, 32), 20)),
}


def _case(name):
    sizes, kind, changes, seed, tokens = CASES[name]
    jcfg, cfg = _cfgs(**MOE, **changes)
    jp = jwl.init_params(jax.random.PRNGKey(seed), jcfg)
    return sizes, kind, jcfg, cfg, jp, tokens


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    args = {}
    for name in CASES:
        sizes, kind, _, cfg, jp, toks = _case(name)
        args[name] = (sizes, kind, cfg, jax.tree.map(np.asarray, jp), toks)
    return tmesh.launch(torch_ranks.sharded_train_rank, DP_EP_TP, args,
                        backend="gloo", device="cpu",
                        workdir=str(tmp_path_factory.mktemp("ranks")))


def _reference_steps(name):
    """jaxbridge's steps on the same mesh: (losses, params). Its ep×sp×tp
    mesh carries dp of 1, as its own test's does."""
    sizes, kind, jcfg, _, jp, batches = _case(name)
    if "dp" not in sizes:
        sizes = {"dp": 1, **sizes}
    mesh = jmeshlib.build_named_mesh(sizes)
    params = jax.tree.map(np.asarray, jp)
    losses = []
    if kind == "sgd":
        step, pshard, tshard = jwl.make_sharded_train_step(mesh, jcfg)
        params = jax.device_put(params, pshard)
        for toks in batches:
            params, loss = step(params, jax.device_put(toks, tshard))
            losses.append(float(loss))
        return losses, params
    step, init_opt, pshard, tshard = jwl.make_accum_train_step(
        mesh, jcfg, optax.adamw(LR), 4)
    params = jax.device_put(params, pshard)
    opt = init_opt(params)
    for toks in batches:
        params, opt, loss = step(params, opt, jax.device_put(toks, tshard))
        losses.append(float(loss))
    return losses, params


def _assert_adamw_close(got, ref, grads):
    """Every element within 1e-5 of its leaf's largest entry, or within
    2·lr where the accumulated gradient is below 1e-7 (module
    docstring)."""
    got, ref, grads = _named(got), _named(ref), _named(grads)
    assert got.keys() == ref.keys()
    for path, r in ref.items():
        err = np.abs(got[path] - r)
        tiny = np.abs(grads[path]) < 1e-7
        assert (err[~tiny] <= RTOL * np.abs(r).max()).all(), path
        assert (err[tiny] <= 2 * LR).all(), path


@pytest.mark.parametrize("name", ["sgd_cf1.25", "sgd_cf0.5",
                                  "sgd_ep_sp_ringflash", "accum"])
def test_ep_steps_match_reference(trained, name):
    """Every rank's loss (the global one) and the gathered parameters after
    the step within 1e-5 of jaxbridge's step on the same mesh (AdamW's as
    the module docstring says)."""
    losses, jparams = _reference_steps(name)
    jparams = jax.tree.map(np.asarray, jparams)
    if CASES[name][1] == "sgd":
        def close(got):
            _assert_leaves_close(got, jparams)
    else:
        _, _, jcfg, _, jp, (stack,) = _case(name)
        grad = jax.jit(jax.grad(lambda p, t: jwl.loss_fn(p, t, jcfg)))
        acc = jax.tree.map(lambda *g: np.mean(np.stack(g), axis=0),
                           *(grad(jp, toks) for toks in stack))

        def close(got):
            _assert_adamw_close(got, jparams, acc)
    for rank in trained:
        np.testing.assert_allclose(rank[name]["losses"], losses, rtol=RTOL)
        close(rank[name]["params"])


@pytest.mark.parametrize("name", ["grads_cf1.25", "grads_cf0.5",
                                  "grads_ep_sp_ringflash"])
def test_ep_gradients_match_whole_batch_reference(trained, name):
    """The global loss and every leaf's gradient, gathered over ep and tp,
    against jaxbridge's ``value_and_grad`` of the whole batch in one
    program: capacity ranked over all B·S tokens, the load balance's means
    global, the aux counted once under sp, the router's gradient summed
    over ep and tp."""
    _, _, jcfg, _, jp, toks = _case(name)
    loss, grads = jax.value_and_grad(jwl.loss_fn)(jp, toks, jcfg)
    for rank in trained:
        got = rank[name]
        assert got["loss"] == pytest.approx(float(loss), rel=RTOL)
        _assert_leaves_close(got["grads"], jax.tree.map(np.asarray, grads))
    assert np.abs(np.asarray(grads["layers"][0]["router"])).max() > 0


def test_reference_drops_slots_at_half_capacity():
    """At capacity factor 0.5 the reference drops slots on this batch (its
    loss differs from the same weights' with room for every slot), so the
    cf 0.5 cases hold the port's global rank order, not only its sums."""
    _, _, jcfg, _, jp, toks = _case("grads_cf0.5")
    roomy = dataclasses.replace(jcfg, moe_capacity_factor=100.0)
    assert abs(float(jwl.loss_fn(jp, toks, jcfg))
               - float(jwl.loss_fn(jp, toks, roomy))) > 1e-3


def test_ep_leaves_are_shards_of_the_experts():
    """Each rank of dp×ep×tp holds E/ep experts of every stack, their d_ff
    over tp, and the router whole."""
    cfg = dataclasses.replace(wl.ModelConfig.tiny(), **MOE)
    layer = wl.param_shapes(cfg)["layers"][0]
    params = wl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    shards = wl.shard_params(params, cfg, tmesh.Mesh(DP_EP_TP, rank=5))
    got = shards["layers"][0]
    e, d, f = layer["w_gate"]
    assert tuple(got["w_gate"].shape) == (e // 2, d, f // 2)
    assert tuple(got["w_down"].shape) == (e // 2, f // 2, d)
    assert tuple(got["router"].shape) == layer["router"]
    # rank 5 is ep index 0: the first half of the experts
    torch.testing.assert_close(got["w_up"],
                               params["layers"][0]["w_up"][:2, :, f // 2:])


@pytest.mark.parametrize("make", ["shard_params", "make_sharded_train_step",
                                  "ServeEngine"])
def test_ep_that_does_not_divide_the_experts_is_refused(make):
    cfg = dataclasses.replace(wl.ModelConfig.tiny(), **MOE)
    p = wl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = tmesh.Mesh({"ep": 3}, device="cpu")
    calls = {
        "shard_params": lambda: wl.shard_params(p, cfg, mesh),
        "make_sharded_train_step": lambda: wl.make_sharded_train_step(
            mesh, cfg),
        "ServeEngine": lambda: ServeEngine(
            p, cfg, mesh=mesh, slots=1, max_seq=32, prompt_bucket=8)}
    with pytest.raises(ValueError, match="not divisible by ep 3"):
        calls[make]()


def test_moe_act_spec_is_the_ep_axis():
    """The counterpart of the reference's ``moe_act_spec``: the ep axis for
    an MoE model on a mesh with ep, else None."""
    moe = dataclasses.replace(wl.ModelConfig.tiny(), **MOE)
    mesh = tmesh.Mesh(DP_EP_TP, rank=6)
    axis = wl.moe_act_spec(moe, mesh)
    assert (axis.name, axis.size, axis.index) == ("ep", 2, 1)
    assert wl.moe_act_spec(wl.ModelConfig.tiny(), mesh) is None
    assert wl.moe_act_spec(moe, tmesh.Mesh({"dp": 2, "tp": 2})) is None
    assert wl.TrainShardings(mesh, moe).ep == axis


# -- serving over ep ----------------------------------------------------------

SERVE_CASES = {  # name -> (engine kwargs, requests seed and shape)
    "monolithic": ({}, (41, 4, 4, 12, 2, 6)),
    "chunked": (dict(chunk_prefill=6), (43, 4, 6, 16, 2, 6)),
}


def _serve_case(name):
    kw, (seed, n, lo, hi, new_lo, new_hi) = SERVE_CASES[name]
    jcfg, cfg = _cfgs(**MOE)
    jp = jwl.init_params(jax.random.PRNGKey(4), jcfg)
    reqs = _requests(seed, n, lo, hi, new_lo, new_hi, cfg.vocab)
    return jcfg, jp, cfg, kw, reqs


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    cases = {}
    for name in SERVE_CASES:
        _, jp, cfg, kw, reqs = _serve_case(name)
        cases[name] = (cfg, jax.tree.map(np.asarray, jp), kw, reqs, None)
    return tmesh.launch(torch_ranks.serve_rank, {"ep": 2, "tp": 2}, cases,
                        backend="gloo", device="cpu",
                        workdir=str(tmp_path_factory.mktemp("ranks")))


@pytest.mark.parametrize("name", list(SERVE_CASES))
def test_ep_engine_matches_reference_ep_engine(served, name):
    """Every rank's completions and tick count equal jaxbridge's engine's on
    an {"ep": 2, "tp": 2} mesh of virtual CPU devices; each rank holds the
    arena's kv_heads/tp heads (replicated over ep)."""
    jcfg, jp, cfg, kw, reqs = _serve_case(name)
    mesh = JMesh(np.array(jax.devices()[:4]).reshape(2, 2), ("ep", "tp"))
    eng = jserve.ServeEngine(jp, jcfg, mesh=mesh, **GEOMETRY, **kw)
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    tokens = {c.rid: np.asarray(c.tokens).tolist() for c in done}
    for rank in served:
        got = rank[name]["tp"]
        assert got["tokens"] == tokens
        assert got["ticks"] == eng.tick_count
        assert rank[name]["kv_heads"] == cfg.kv_heads // 2
