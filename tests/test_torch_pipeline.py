"""Pipeline parallelism (pp): the port's GPipe step on meshes of eight gloo
ranks (CPU) against jaxbridge's ``make_pipeline_train_step`` on the same
meshes of virtual CPU devices and its single-program ``loss_fn`` and
``sgd_train_step``, f32, case for case as tests/test_pipeline.py:

- the loss for (pp, n_micro) in (2, 2), (4, 4) and (2, 4) on {"pp": pp,
  "dp": 8 // pp} within 1e-5 of both;
- one SGD step's update of every stacked leaf, ``embed``, ``out`` and
  ``ln_f`` against ``sgd_train_step`` (atol 2e-5, rtol 2e-4, as there), on
  {"pp": 2, "dp": 2, "tp": 2};
- MoE on {"pp": 2, "ep": 2, "tp": 2}: the loss and the update against
  jaxbridge's pipeline, which is not ``loss_fn``: capacity is ranked per
  microbatch and only the last stage's aux enters the loss (the cases with
  n_micro 2, and with ``moe_aux_weight`` 0.01, differ from ``loss_fn``);
- flash stages launching the flash forward and backward (their plain
  versions here) (L/pp)·n_micro times a stage: no remat inside a stage;
- fsdp, sp and slice beside pp, on {"pp": 2, "fsdp": 2, "dp": 2}, {"pp":
  2, "sp": 2, "dp": 2}, {"pp": 2, "slice": 2, "dp": 2} and {"pp": 2,
  "fsdp": 2, "tp": 2}: the loss, every updated leaf and every update within
  1e-5 of jaxbridge's pipeline. Rows split over dp alone, so an fsdp
  leaf's update must be its chunk of the one full gradient's, not a sum
  over fsdp (which would be twice it);
- the refusals: layers that do not split into the stages, a batch that
  does not split into the microbatches, and an axis the port does not know.

One spawn of eight ranks runs every case (``torch_ranks.pipeline_rank``);
the ranks import no JAX."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_ranks
from test_torch_tp_train import _assert_leaves_close
from tpusched.jaxbridge import mesh as jmeshlib
from tpusched.jaxbridge import pipeline as jpipe
from tpusched.jaxbridge import workload as jwl
from tpusched_torch import interop, mesh as tmesh, optim, pipeline
from tpusched_torch import workload as wl

torch.set_num_threads(1)

RTOL = 1e-5
TINY = dict(vocab=128, d_model=32, n_layers=4, n_heads=2, d_ff=64, seq=16)
MOE = dict(n_experts=4, moe_top_k=2)
PP_EP_TP = {"pp": 2, "ep": 2, "tp": 2}


def _tokens(rows, seed):
    return np.random.default_rng(seed).integers(
        0, TINY["vocab"], (rows, TINY["seq"]), dtype=np.int32)


# name -> (mesh, config changes, n_micro, lr, param seed, global batch)
CASES = {
    "pp2_micro2": ({"pp": 2, "dp": 4}, {}, 2, 1e-3, 0, _tokens(8, 1)),
    "pp4_micro4": ({"pp": 4, "dp": 2}, {}, 4, 1e-3, 0, _tokens(8, 1)),
    "pp2_micro4": ({"pp": 2, "dp": 4}, {}, 4, 1e-3, 0, _tokens(8, 1)),
    "update": ({"pp": 2, "dp": 2, "tp": 2}, dict(n_layers=2), 2, 1e-2, 4,
               _tokens(4, 5)),
    "moe_micro1": (PP_EP_TP, dict(**MOE, moe_aux_weight=0.0), 1, 1e-3, 6,
                   _tokens(4, 7)),
    "moe_micro2": (PP_EP_TP, dict(**MOE, moe_aux_weight=0.0), 2, 1e-3, 6,
                   _tokens(4, 7)),
    "moe_aux": (PP_EP_TP, MOE, 1, 1e-3, 6, _tokens(4, 7)),
    "moe_aux_micro2_cf0.5": (PP_EP_TP, dict(**MOE, moe_capacity_factor=0.5),
                             2, 1e-3, 6, _tokens(4, 7)),
    "flash": ({"pp": 2, "dp": 4}, dict(attn="flash", remat=True), 4, 1e-3, 8,
              _tokens(8, 9)),
    # the reference's tiny depth, 2 microbatches, and an lr at which the
    # update dominates the weights' rounding
    "fsdp_dp": ({"pp": 2, "fsdp": 2, "dp": 2}, dict(n_layers=2), 2, 1.0, 10,
                _tokens(8, 11)),
    "sp_dp": ({"pp": 2, "sp": 2, "dp": 2}, dict(n_layers=2), 2, 1.0, 10,
              _tokens(8, 11)),
    "slice_dp": ({"pp": 2, "slice": 2, "dp": 2}, dict(n_layers=2), 2, 1.0, 10,
                 _tokens(8, 11)),
    "fsdp_tp": ({"pp": 2, "fsdp": 2, "tp": 2}, dict(n_layers=2), 2, 1.0, 10,
                _tokens(8, 11)),
}
REPLICA_AND_FSDP = ["fsdp_dp", "sp_dp", "slice_dp", "fsdp_tp"]


def _cfgs(changes):
    return (jwl.ModelConfig(**{**TINY, **changes}),
            wl.ModelConfig(**{**TINY, **changes}))


def _case(name):
    sizes, changes, n_micro, lr, seed, tokens = CASES[name]
    jcfg, cfg = _cfgs(changes)
    tree = jax.tree.map(np.asarray,
                        jwl.init_params(jax.random.PRNGKey(seed), jcfg))
    return sizes, jcfg, cfg, n_micro, lr, tree, tokens


@pytest.fixture(scope="module")
def piped(tmp_path_factory):
    args = {}
    for name in CASES:
        sizes, _, cfg, n_micro, lr, tree, tokens = _case(name)
        args[name] = (sizes, cfg, n_micro, lr, tree, tokens)
    return tmesh.launch(torch_ranks.pipeline_rank, {"pp": 2, "dp": 4}, args,
                        backend="gloo", device="cpu",
                        workdir=str(tmp_path_factory.mktemp("ranks")))


def _reference_pipeline(name):
    """jaxbridge's pipelined step on the same mesh: (loss, new params as
    (stacked, embed, out, ln_f))."""
    sizes, jcfg, _, n_micro, lr, tree, tokens = _case(name)
    mesh = jmeshlib.build_named_mesh(sizes)
    step, shardings, tshard = jpipe.make_pipeline_train_step(
        mesh, jcfg, n_micro, lr)
    params = jax.device_put((jpipe.stack_layers(tree), tree["embed"],
                             tree["out"], tree["ln_f"]), shardings)
    new, loss = step(params, jax.device_put(tokens, tshard))
    return float(loss), [jax.tree.map(np.asarray, p) for p in new]


def _loss_fn(name):
    """jaxbridge's single-program loss, through its naive attention."""
    _, jcfg, _, _, _, tree, tokens = _case(name)
    jcfg = dataclasses.replace(jcfg, attn="naive", remat=False)
    return float(jwl.loss_fn(tree, tokens, jcfg))


@pytest.mark.parametrize("name", ["pp2_micro2", "pp4_micro4", "pp2_micro4"])
def test_pipeline_loss_matches_plain_loss(piped, name):
    """Every rank returns the last stage's loss, within 1e-5 of jaxbridge's
    pipeline on the same mesh and of its single-program loss."""
    want, _ = _reference_pipeline(name)
    assert want == pytest.approx(_loss_fn(name), rel=RTOL)
    for rank in piped:
        assert rank[name]["loss"] == pytest.approx(want, rel=RTOL)


def test_pipeline_update_matches_plain_sgd(piped):
    """One pipelined SGD step moves every stacked leaf, embed, out and
    ln_f where the single-program step moves them (2e-5, as the
    reference's own test): their gradients summed over pp and averaged
    over dp, tp's as in the flat steps."""
    _, jcfg, _, _, lr, tree, tokens = _case("update")
    plain, _ = jax.jit(lambda p, t: jwl.sgd_train_step(p, t, jcfg, lr=lr))(
        tree, tokens)
    plain = jax.tree.map(np.asarray, plain)
    want = [jax.tree.map(np.asarray, jpipe.stack_layers(plain)),
            plain["embed"], plain["out"], plain["ln_f"]]
    for rank in piped:
        got = rank["update"]["params"]
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(g, w, atol=2e-5, rtol=2e-4)


@pytest.mark.parametrize("name", ["moe_micro1", "moe_micro2", "moe_aux",
                                  "moe_aux_micro2_cf0.5"])
def test_pipelined_moe_matches_reference_pipeline(piped, name):
    """MoE on {"pp": 2, "ep": 2, "tp": 2}: the loss and every updated leaf
    within 1e-5 of jaxbridge's pipeline, including where that pipeline
    leaves ``loss_fn`` (n_micro 2: capacity ranked per microbatch; an aux
    weight: only the last stage's aux, summed over microbatches)."""
    want, new = _reference_pipeline(name)
    plain = _loss_fn(name)
    if name == "moe_micro1":
        assert want == pytest.approx(plain, rel=RTOL)
    else:
        assert abs(want - plain) > 1e-4
    for rank in piped:
        assert rank[name]["loss"] == pytest.approx(want, rel=RTOL)
        _assert_leaves_close(rank[name]["params"], new)


def test_pipeline_shards_and_token_spec(piped):
    """Each stage holds L/pp layers of every stacked leaf, E/ep experts of
    the expert stacks with d_ff over tp, and embed, out and ln_f as the
    flat steps shard them; tokens split over dp."""
    d, f, v, e = TINY["d_model"], TINY["d_ff"], TINY["vocab"], 4
    half = d // 2                   # the tiny model's heads: d_kv == d
    want = [(2, d, half), (2, d, half), (2, d, half), (2, half, d),
            (2, d), (2, d), (2, d, e), (2, e // 2, d, f // 2),
            (2, e // 2, d, f // 2), (2, e // 2, f // 2, d),
            (v, half), (half, v), (d,)]
    for rank in piped:
        assert rank["moe_aux"]["shapes"] == want
    assert piped[0]["pp2_micro2"]["token_spec"] == (("dp",), None)
    assert piped[0]["moe_aux"]["token_spec"] == (None, None)


def test_flash_stages_launch_once_per_layer_and_microbatch(piped):
    """With flash attention (and remat on, which a stage ignores) every
    stage calls the flash forward and backward (L/pp)·n_micro times a
    step, and the loss equals the single-program loss."""
    _, _, cfg, n_micro, *_ = _case("flash")
    want = (cfg.n_layers // 2) * n_micro
    for rank in piped:
        assert rank["flash"]["calls"] == {"forward": want, "backward": want}
        assert rank["flash"]["loss"] == pytest.approx(_loss_fn("flash"),
                                                      rel=RTOL)
    assert sorted({r["flash"]["stage"] for r in piped}) == [0, 1]


@pytest.mark.parametrize("name", REPLICA_AND_FSDP)
def test_pipeline_over_fsdp_sp_slice_matches_reference(piped, name):
    """The loss, every updated leaf and every update (new − old: the
    learning rate times the gradient) within 1e-5 of jaxbridge's pipeline
    on the same mesh; every rank returns the same loss, and an fsdp rank
    holds half of each leaf the spec puts over fsdp."""
    sizes, _, cfg, _, _, tree, _ = _case(name)
    want, new = _reference_pipeline(name)
    old = [jax.tree.map(np.asarray, jpipe.stack_layers(tree)),
           tree["embed"], tree["out"], tree["ln_f"]]
    want_update = jax.tree.map(lambda a, b: a - b, new, old)
    for rank in piped:
        got = rank[name]
        assert got["loss"] == pytest.approx(want, rel=RTOL)
        _assert_leaves_close(got["params"], new)
        _assert_leaves_close(jax.tree.map(lambda a, b: a - b,
                                          got["params"], old), want_update)
    layout = tmesh.Mesh(sizes)
    shapes, over_fsdp = [], []
    wl.tree_map(lambda x, spec: (
        shapes.append(wl.shard_shape(x.shape, spec, layout)),
        over_fsdp.append("fsdp" in spec)),
        list(interop.pipeline_params_from_numpy(tree, cfg, "cpu")),
        list(pipeline.pipeline_param_specs(cfg, layout)))
    assert piped[0][name]["shapes"] == shapes
    # every matrix of a layer (7), embed and out are halved over fsdp
    assert sum(over_fsdp) == (9 if "fsdp" in sizes else 0)


def test_pipeline_rejects_indivisible_layers():
    cfg = wl.ModelConfig(**{**TINY, "n_layers": 3})
    with pytest.raises(ValueError, match="stages"):
        pipeline.make_pipeline_train_step(tmesh.Mesh({"pp": 2}), cfg, 2)


def test_pipeline_rejects_a_batch_that_does_not_split():
    cfg = wl.ModelConfig(**TINY)
    mesh = tmesh.Mesh({"pp": 2}, device="cpu")
    step, _, _ = pipeline.make_pipeline_train_step(mesh, cfg, 4)
    shards = pipeline.shard_pipeline_params(pipeline.init_pipeline_params(
        cfg, torch.Generator().manual_seed(0), "cpu"), cfg, mesh)
    with pytest.raises(ValueError, match="n_micro=4"):
        step(shards, torch.zeros((6, cfg.seq), dtype=torch.long))


@pytest.mark.parametrize("axis,error", [("xp", ValueError)])
def test_pipeline_refuses_other_axes(axis, error):
    cfg = wl.ModelConfig(**TINY)
    with pytest.raises(error, match=repr(axis)):
        pipeline.make_pipeline_train_step(
            tmesh.Mesh({"pp": 2, axis: 2}), cfg, 2)


@pytest.mark.parametrize("make", ["make_sharded_train_step",
                                  "make_optax_train_step",
                                  "make_accum_train_step", "shard_params"])
def test_flat_steps_refuse_pp_naming_the_pipeline(make):
    cfg = dataclasses.replace(wl.ModelConfig.tiny(), n_layers=4)
    mesh = tmesh.Mesh({"pp": 2, "dp": 2})
    args = {"make_sharded_train_step": (mesh, cfg),
            "make_optax_train_step": (mesh, cfg, optim.adamw(1e-3)),
            "make_accum_train_step": (mesh, cfg, optim.adamw(1e-3), 2),
            "shard_params": (wl.init_params(
                cfg, torch.Generator().manual_seed(0), "cpu"), cfg, mesh)}
    with pytest.raises(NotImplementedError,
                       match="pipeline.make_pipeline_train_step"):
        getattr(wl, make)(*args[make])
