"""Fully-sharded (fsdp) and sequence-parallel (sp) training: the port's
steps on meshes of four gloo ranks (CPU) against jaxbridge's on the same
meshes of virtual CPU devices, f32 tiny: AdamW on {"fsdp": 2, "tp": 2},
three steps, with the moments shaped like the shards; SGD on {"sp": 2,
"tp": 2} with the ring, ring-flash and (whole sequence gathered) flash
attention; accumulation on {"fsdp": 2, "sp": 2}; the vocab-parallel loss
under sp against the reference's and the replicated one. Losses and every
parameter within 1e-5 relative. Every leaf's gradient on {"fsdp": 2, "sp":
2} against the unsharded model's within 1e-5: it fails if an fsdp leaf is
summed over fsdp twice or the loss is a mean of the ranks' means. The AdamW
and accumulation steps' parameters are held by each leaf's relative L2
error: AdamW moves an element whose gradient is near zero by about lr
whatever the gradient's rounding, and jaxbridge's own {"fsdp": 2, "tp": 2}
and unsharded steps leave one w_down element 2e-5 of the leaf's largest
apart after three steps. Then one
spawn of eight ranks: SGD with ring-flash on {"fsdp": 2, "sp": 2, "tp": 2}
against jaxbridge's {"dp": 1, "fsdp": 2, "sp": 2, "tp": 2} step. The ranks
(``torch_ranks.sharded_train_rank``) import no JAX."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_ranks
from test_torch_tp_train import _assert_leaves_close, _cfgs, _named
from tpusched.jaxbridge import mesh as jmeshlib
from tpusched.jaxbridge import workload as jwl
from tpusched_torch import mesh as tmesh, workload as wl

torch.set_num_threads(1)

RTOL = 1e-5
FSDP_TP = {"fsdp": 2, "tp": 2}
SP_TP = {"sp": 2, "tp": 2}
FSDP_SP = {"fsdp": 2, "sp": 2}
DRYRUN = {"fsdp": 2, "sp": 2, "tp": 2}


def _tokens(shape, seed):
    return np.random.default_rng(seed).integers(
        0, wl.ModelConfig.tiny().vocab, shape, dtype=np.int32)


def _batches(kind, seed, steps):
    seq = wl.ModelConfig.tiny().seq
    if kind == "accum":
        return [_tokens((4, 4, seq), seed), _tokens((3, 4, seq), seed + 1)]
    if kind == "mesh_grads":
        return _tokens((4, seq), seed)
    return [_tokens((4, seq), seed + i) for i in range(steps)]


# name -> (mesh, kind, config changes, param seed, token seed, steps)
CASES = {
    "adamw_fsdp_tp": (FSDP_TP, "adamw", dict(attn="flash", remat=True), 1,
                      10, 3),
    "sgd_sp_tp_ring": (SP_TP, "sgd", dict(attn="ring"), 2, 20, 2),
    "sgd_sp_tp_ringflash": (SP_TP, "sgd", dict(attn="ringflash",
                                               remat=True), 3, 30, 2),
    "sgd_sp_tp_flash": (SP_TP, "sgd", dict(attn="flash"), 4, 40, 2),
    "accum_fsdp_sp": (FSDP_SP, "accum", dict(attn="ringflash"), 5, 50, 2),
    "vocab_parallel_sp": (SP_TP, "sgd", dict(attn="ring",
                                             vocab_parallel_loss=True), 6,
                          60, 2),
    "vocab_parallel_loss_sp": (SP_TP, "mesh_grads", dict(
        attn="ringflash", vocab_parallel_loss=True), 7, 70, 1),
    "replicated_loss_sp": (SP_TP, "mesh_grads", dict(attn="ringflash"), 7,
                           70, 1),
    "grads_fsdp_sp_ringflash": (FSDP_SP, "mesh_grads", dict(
        attn="ringflash", remat=True), 8, 80, 1),
    "grads_fsdp_sp_naive": (FSDP_SP, "mesh_grads", {}, 9, 90, 1),
}
DRYRUN_CASE = (DRYRUN, "sgd", dict(attn="ringflash"), 11, 110, 1)


def _case(spec):
    sizes, kind, changes, seed, tok_seed, steps = spec
    jcfg, cfg = _cfgs(**changes)
    jp = jwl.init_params(jax.random.PRNGKey(seed), jcfg)
    return sizes, kind, jcfg, cfg, jp, _batches(kind, tok_seed, steps)


def _launch(cases, sizes, tmp_path_factory):
    args = {}
    for name, spec in cases.items():
        mesh, kind, _, cfg, jp, toks = _case(spec)
        args[name] = (mesh, kind, cfg, jax.tree.map(np.asarray, jp), toks)
    return tmesh.launch(torch_ranks.sharded_train_rank, sizes, args,
                        backend="gloo", device="cpu",
                        workdir=str(tmp_path_factory.mktemp("ranks")))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return _launch(CASES, FSDP_SP, tmp_path_factory)


@pytest.fixture(scope="module")
def dryrun(tmp_path_factory):
    return _launch({"dryrun": DRYRUN_CASE}, DRYRUN, tmp_path_factory)


def _reference(spec):
    """jaxbridge's steps on the same mesh: (losses, params)."""
    sizes, kind, jcfg, _, jp, batches = _case(spec)
    mesh = jmeshlib.build_named_mesh(sizes)
    if kind == "sgd":
        step, pshard, tshard = jwl.make_sharded_train_step(mesh, jcfg)
        params = jax.device_put(jp, pshard)
        losses = []
        for toks in batches:
            params, loss = step(params, jax.device_put(toks, tshard))
            losses.append(float(loss))
        return losses, params
    make = (jwl.make_optax_train_step if kind == "adamw"
            else jwl.make_accum_train_step)
    step, init_opt, pshard, tshard = make(
        mesh, jcfg, optax.adamw(1e-3), *((4,) if kind == "accum" else ()))
    params = jax.device_put(jp, pshard)
    opt = init_opt(params)
    losses = []
    for toks in batches:
        params, opt, loss = step(params, opt, jax.device_put(toks, tshard))
        losses.append(float(loss))
    return losses, params


def _assert_leaves_close_l2(got, ref, rtol=RTOL):
    """Every leaf's relative L2 error within ``rtol``."""
    got, ref = _named(got), _named(ref)
    assert got.keys() == ref.keys()
    for path, r in ref.items():
        err = np.linalg.norm(got[path] - r) / np.linalg.norm(r)
        assert err <= rtol, (path, err)


def _check_steps(ranks, name, spec):
    losses, jparams = _reference(spec)
    close = (_assert_leaves_close if spec[1] == "sgd"
             else _assert_leaves_close_l2)
    for rank in ranks:
        np.testing.assert_allclose(rank[name]["losses"], losses, rtol=RTOL)
        close(rank[name]["params"], jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("name", ["adamw_fsdp_tp", "sgd_sp_tp_ring",
                                  "sgd_sp_tp_ringflash", "sgd_sp_tp_flash",
                                  "accum_fsdp_sp", "vocab_parallel_sp"])
def test_steps_match_reference(trained, name):
    """Every step's loss on every rank (the global mean) and the gathered
    parameters within 1e-5 relative of the reference's on the same mesh."""
    _check_steps(trained, name, CASES[name])


def test_adamw_moments_mirror_the_shards(trained):
    """AdamW's state lives on the shards: each moment has its leaf's shard
    shape, an fsdp-sharded matrix half its whole size on {"fsdp": 2, "tp":
    2}, and the token spec is the batch axes', sequence whole."""
    got = trained[0]["adamw_fsdp_tp"]
    assert got["moment_shapes"] == got["shard_shapes"]
    shapes = wl.param_shapes(wl.ModelConfig.tiny())
    assert got["shard_shapes"][0] == (shapes["embed"][0] // 2,
                                      shapes["embed"][1] // 2)
    assert trained[0]["sgd_sp_tp_ring"]["token_spec"] == (None, None)
    assert trained[0]["accum_fsdp_sp"]["token_spec"] == (None, ("fsdp",),
                                                          None)


def test_vocab_parallel_loss_under_sp(trained):
    """The vocab-parallel loss keeps the logits sp- and vocab-sharded: its
    global loss equals the replicated loss of the same weights and the
    reference's vocab-parallel loss on its sp×tp mesh."""
    sizes, _, jcfg, _, jp, toks = _case(CASES["vocab_parallel_loss_sp"])
    mesh = jmeshlib.build_named_mesh(sizes)
    ts = jwl.TrainShardings(mesh, jcfg)
    jloss = float(jax.jit(lambda p, t: jwl.loss_fn(p, t, jcfg,
                                                   **ts.loss_kwargs()))(
        jax.device_put(jp, ts.params), jnp.asarray(toks)))
    for rank in trained:
        got = rank["vocab_parallel_loss_sp"]
        assert got["loss"] == pytest.approx(jloss, rel=RTOL)
        assert got["loss"] == pytest.approx(
            rank["replicated_loss_sp"]["loss"], rel=RTOL)
        _assert_leaves_close(got["grads"], got["ref"])


@pytest.mark.parametrize("name", ["grads_fsdp_sp_ringflash",
                                  "grads_fsdp_sp_naive"])
def test_every_leaf_gradient_matches_unsharded(trained, name):
    """The global loss and every leaf's gradient on {"fsdp": 2, "sp": 2},
    gathered, against the unsharded model's on the same batch: each matrix
    summed over fsdp once (its reduce-scatter) and the norms over every
    axis, the loss the mean over all B × (S − 1) positions."""
    for rank in trained:
        got = rank[name]
        assert got["loss"] == pytest.approx(got["ref_loss"], rel=RTOL)
        _assert_leaves_close(got["grads"], got["ref"])


def test_dryrun_mesh_matches_reference(dryrun):
    """Eight ranks, {"fsdp": 2, "sp": 2, "tp": 2} with ring-flash: the step's
    loss and parameters equal jaxbridge's on its dryrun mesh {"dp": 1,
    "fsdp": 2, "sp": 2, "tp": 2}."""
    spec = ({"dp": 1, **DRYRUN}, *DRYRUN_CASE[1:])
    _check_steps(dryrun, "dryrun", spec)


@pytest.mark.parametrize("sizes", [{"sp": 2}, {"dp": 2}])
def test_moe_capacity_over_sp_or_dp_is_refused(sizes):
    """Capacity routing ranks every token of the global batch for expert
    slots, which a rank's rows or sequence chunk alone cannot: the MoE
    layer gathers them (tests/test_torch_ep.py holds it to the reference),
    so sp and dp are no longer refused; an ep beside them that does not
    divide the experts is."""
    cfg = dataclasses.replace(wl.ModelConfig.tiny(), n_experts=4)
    wl.make_sharded_train_step(tmesh.Mesh(sizes), cfg)
    with pytest.raises(ValueError, match="not divisible by ep"):
        wl.make_sharded_train_step(tmesh.Mesh({**sizes, "ep": 3}), cfg)
