"""Data- and tensor-parallel training: the port's steps on a {"dp": 2, "tp": 2}
mesh of four gloo ranks (CPU) against jaxbridge's on a {"dp": 2, "tp": 2}
virtual CPU mesh, f32 tiny: ``make_sharded_train_step`` (SGD),
``make_optax_train_step`` (the port's AdamW against optax.adamw) and
``make_accum_train_step`` (a stack of 4, then a short one of 3), two steps
each on the same global batches, losses and every parameter within 1e-5
relative; f32 masters and moments under bf16 compute; the vocab-parallel
loss against the reference's and the replicated one; and every leaf's
gradient at tp = 2, the MoE router's included, against the unsharded one.
One spawn of four ranks runs every case (``torch_ranks.train_rank``); the
ranks import no JAX."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_ranks
from tpusched.jaxbridge import mesh as jmeshlib
from tpusched.jaxbridge import workload as jwl
from tpusched_torch import mesh as tmesh, workload as wl

torch.set_num_threads(1)

MESH = {"dp": 2, "tp": 2}
RTOL = 1e-5


def _cfgs(**changes):
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
    return (dataclasses.replace(jwl.ModelConfig.tiny(),
                                **{k: jdt.get(v, v) for k, v in
                                   changes.items()}),
            dataclasses.replace(wl.ModelConfig.tiny(), **changes))


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape,
                                                dtype=np.int32)


# name -> (kind, config changes, param seed, global token batches)
def _batches(kind, seed):
    seq = wl.ModelConfig.tiny().seq
    if kind == "accum":
        return [_tokens(wl.ModelConfig.tiny(), (4, 4, seq), seed),
                _tokens(wl.ModelConfig.tiny(), (3, 4, seq), seed + 1)]
    if kind in ("grads", "loss"):
        return _tokens(wl.ModelConfig.tiny(), (2, seq), seed)
    return [_tokens(wl.ModelConfig.tiny(), (4, seq), seed + i)
            for i in range(2)]


CASES = {
    "sgd": ("sgd", dict(attn="flash", remat=True), 1, 50),
    "adamw": ("adamw", {}, 2, 60),
    "accum": ("accum", {}, 3, 70),
    "mixed_precision": ("adamw", dict(dtype=torch.bfloat16,
                                      param_dtype=torch.float32), 4, 80),
    "vocab_parallel_sgd": ("sgd", dict(vocab_parallel_loss=True), 5, 90),
    "vocab_parallel_loss": ("loss", dict(vocab_parallel_loss=True), 6, 100),
    "replicated_loss": ("loss", {}, 6, 100),
    "grads_dense": ("grads", dict(attn="flash", remat=True), 7, 110),
    "grads_moe": ("grads", dict(n_experts=4), 8, 120),
}


def _case(name):
    kind, changes, seed, tok_seed = CASES[name]
    jcfg, cfg = _cfgs(**changes)
    jp = jwl.init_params(jax.random.PRNGKey(seed), jcfg)
    return kind, jcfg, cfg, jp, _batches(kind, tok_seed)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    cases = {}
    for name in CASES:
        kind, _, cfg, jp, toks = _case(name)
        cases[name] = (kind, cfg, jax.tree.map(np.asarray, jp), toks)
    return tmesh.launch(torch_ranks.train_rank, MESH, cases, backend="gloo",
                        device="cpu",
                        workdir=str(tmp_path_factory.mktemp("ranks")))


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: np.asarray(tree, dtype=np.float32)}
    return {path: leaf for k, v in items
            for path, leaf in _named(v, f"{prefix}/{k}").items()}


def _assert_leaves_close(got, ref, rtol=RTOL):
    """Every leaf within ``rtol`` of its reference, relative to the leaf's
    largest entry."""
    got, ref = _named(got), _named(ref)
    assert got.keys() == ref.keys()
    for path, r in ref.items():
        np.testing.assert_allclose(got[path], r, rtol=0,
                                   atol=rtol * np.abs(r).max(), err_msg=path)


def _reference(name):
    """jaxbridge's steps on a dp2×tp2 mesh: (losses, params)."""
    kind, jcfg, _, jp, batches = _case(name)
    mesh = jmeshlib.build_named_mesh(MESH)
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


@pytest.mark.parametrize("name", ["sgd", "adamw", "accum",
                                  "vocab_parallel_sgd"])
def test_steps_match_reference(trained, name):
    """Two steps: every rank's losses (the global mean) and the gathered
    parameters equal the reference's within 1e-5 relative."""
    losses, jparams = _reference(name)
    for rank in trained:
        np.testing.assert_allclose(rank[name]["losses"], losses, rtol=RTOL)
        _assert_leaves_close(rank[name]["params"],
                             jax.tree.map(np.asarray, jparams))
    assert trained[0][name]["token_spec"] == (
        (None, ("dp",), None) if name == "accum" else (("dp",), None))


def test_mixed_precision_masters_and_moments_stay_f32(trained):
    """bf16 compute over f32 masters on the mesh: the shards and both AdamW
    moments stay f32, and the losses are the reference's to bf16
    precision."""
    losses, _ = _reference("mixed_precision")
    for rank in trained:
        got = rank["mixed_precision"]
        assert got["dtypes"] == ["torch.float32"]
        assert got["moments"] == ["torch.float32"]
        np.testing.assert_allclose(got["losses"], losses, rtol=2e-2)


def test_vocab_parallel_loss_matches_reference_and_replicated(trained):
    """The vocab-parallel loss (out column-parallel, logsumexp over the
    tp-sharded vocabulary) equals the replicated loss of the same weights
    and the reference's vocab-parallel loss on its tp mesh."""
    _, jcfg, _, jp, toks = _case("vocab_parallel_loss")
    mesh = jmeshlib.build_named_mesh(MESH)
    ts = jwl.TrainShardings(mesh, jcfg)
    assert ts.vocab_spec is not None
    jloss = float(jax.jit(lambda p, t: jwl.loss_fn(p, t, jcfg,
                                                   **ts.loss_kwargs()))(
        jax.device_put(jp, ts.params), jnp.asarray(toks)))
    for rank in trained:
        got = rank["vocab_parallel_loss"]["loss"]
        assert got == pytest.approx(jloss, rel=RTOL)
        assert got == pytest.approx(rank["replicated_loss"]["loss"],
                                    rel=RTOL)


@pytest.mark.parametrize("name", ["grads_dense", "grads_moe"])
def test_every_leaf_gradient_matches_unsharded(trained, name):
    """Loss and every leaf's gradient at tp = 2, gathered, against the
    unsharded run's: the norms and the MoE router (replicated leaves whose
    gradients come back through the tp sums) included."""
    for rank in trained:
        got = rank[name]
        assert got["loss"] == pytest.approx(got["ref_loss"], rel=RTOL)
        _assert_leaves_close(got["grads"], got["ref"])
        if name == "grads_moe":
            assert np.abs(got["ref"]["layers"][0]["router"]).max() > 0


def test_moe_over_a_data_parallel_batch_is_refused():
    """Capacity routing ranks the global batch's tokens for expert slots,
    which a rank's share alone cannot: the MoE layer gathers the batch
    (tests/test_torch_ep.py holds it to the reference), so a dp batch is
    no longer refused; an ep that does not divide the experts is."""
    cfg = dataclasses.replace(wl.ModelConfig.tiny(), n_experts=4)
    wl.make_sharded_train_step(tmesh.Mesh({"dp": 2, "tp": 1}), cfg)
    with pytest.raises(ValueError, match="not divisible by ep"):
        wl.make_sharded_train_step(tmesh.Mesh({"dp": 2, "ep": 3}), cfg)
