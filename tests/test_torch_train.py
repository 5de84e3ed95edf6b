"""The port's training path against tpusched.jaxbridge.workload and optax on
the CPU: loss and gradients (naive and flash attention, with and without
remat), the SGD step, AdamW against optax.adamw, gradient accumulation and
mixed precision. The JAX parameters come across through interop; tokens
and gradients are made with numpy from a seed."""
from __future__ import annotations

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpusched.jaxbridge import mesh as meshlib
from tpusched.jaxbridge import workload as jwl
from tpusched_torch import interop, optim, workload as wl

torch.set_num_threads(1)


def _pair(**changes):
    """(reference cfg, port cfg) with the same changes applied to tiny()."""
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
    jchanges = {k: jdt.get(v, v) for k, v in changes.items()}
    return (dataclasses.replace(jwl.ModelConfig.tiny(), **jchanges),
            dataclasses.replace(wl.ModelConfig.tiny(), **changes))


def _params(jcfg, cfg, seed=0):
    jp = jwl.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, interop.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                         "cpu")


def _tokens(cfg, batch, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab,
                                                (batch, cfg.seq),
                                                dtype=np.int32)


def _named(tree, prefix=""):
    """{path: leaf} of a parameter tree, for the port's and JAX's alike
    (their leaf orders differ)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    return {path: leaf for k, v in items
            for path, leaf in _named(v, f"{prefix}/{k}").items()}


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_trees_close(got, ref, rtol=0.0, atol=0.0, atol_of_max=0.0):
    got, ref = _named(got), _named(ref)
    assert got.keys() == ref.keys()
    for path in ref:
        r = _f32(ref[path])
        np.testing.assert_allclose(
            _f32(got[path]), r, rtol=rtol,
            atol=max(atol, atol_of_max * np.abs(r).max()), err_msg=path)


def _assert_within_one_bf16_ulp(got, ref):
    got, ref = _named(got), _named(ref)
    for path in ref:
        r = _f32(ref[path])
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(r), 1e-30))) - 7)
        assert (np.abs(_f32(got[path]) - r) <= ulp).all(), path


@pytest.mark.parametrize("kv", [0, 1], ids=["mha", "mqa"])
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("attn", ["naive", "flash"])
def test_loss_and_grads_match_reference(attn, remat, kv):
    """loss_fn and its gradients on tiny f32 (as it is, and with its two
    heads over one KV head) vs jax.value_and_grad of the reference's loss_fn
    (flash: the Pallas kernels in interpret mode)."""
    jcfg, cfg = _pair(attn=attn, remat=remat, n_kv_heads=kv)
    jp, p = _params(jcfg, cfg)
    toks = _tokens(cfg, 2, 0)
    jloss, jgrads = jax.value_and_grad(jwl.loss_fn)(jp, jnp.asarray(toks),
                                                    jcfg)
    loss, grads = wl.value_and_grad(p, torch.from_numpy(toks).long(), cfg)
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    _assert_trees_close(grads, jgrads, rtol=3e-4, atol_of_max=3e-4)


@pytest.mark.parametrize("attn", ["naive", "flash"])
def test_remat_changes_no_number(attn):
    """Checkpointed blocks recompute the same forward: loss and gradients
    equal those without remat."""
    cfg = dataclasses.replace(wl.ModelConfig.tiny(), attn=attn)
    p = wl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_tokens(cfg, 2, 1)).long()
    loss, grads = wl.value_and_grad(p, toks, cfg)
    rloss, rgrads = wl.value_and_grad(
        p, toks, dataclasses.replace(cfg, remat=True))
    assert rloss.item() == loss.item()
    for a, b in zip(wl.tree_leaves(rgrads), wl.tree_leaves(grads)):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    with torch.no_grad():    # no gradients: remat is the plain forward
        torch.testing.assert_close(
            wl.forward(p, toks, dataclasses.replace(cfg, remat=True)),
            wl.forward(p, toks, cfg), rtol=0, atol=0)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 1e-6)])
def test_cross_entropy_matches_reference(dtype, tol):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((2, 7, 50)).astype(np.float32) * 4
    targets = rng.integers(0, 50, (2, 7), dtype=np.int32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = float(jwl._cross_entropy(jnp.asarray(logits, jdt),
                                   jnp.asarray(targets)))
    got = wl._cross_entropy(torch.from_numpy(logits).to(dtype),
                            torch.from_numpy(targets).long()).item()
    assert got == pytest.approx(ref, rel=tol)


def test_vocab_parallel_loss_waits_for_the_parallelism_slice():
    with pytest.raises(NotImplementedError, match="Parallelism"):
        wl._cross_entropy(torch.zeros(1, 2, 4), torch.zeros(1, 2).long(),
                          vocab_spec=object())


def test_sgd_steps_match_reference():
    """Three dependent SGD steps, f32: params within 1e-5."""
    jcfg, cfg = _pair(attn="flash", remat=True)
    jp, p = _params(jcfg, cfg, seed=1)
    for i in range(3):
        toks = _tokens(cfg, 2, 10 + i)
        jp, jloss = jwl.sgd_train_step(jp, jnp.asarray(toks), jcfg, lr=1e-2)
        p, loss = wl.sgd_train_step(p, torch.from_numpy(toks).long(), cfg,
                                    lr=1e-2)
        assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    _assert_trees_close(p, jp, rtol=0, atol_of_max=1e-5)


def test_adamw_defaults_are_optax():
    want = inspect.signature(optax.adamw).parameters
    pinned = {"b1": optim.B1, "b2": optim.B2, "eps": optim.EPS,
              "weight_decay": optim.WEIGHT_DECAY,
              "mu_dtype": optim.adamw(1e-3).mu_dtype}
    for name, value in pinned.items():
        assert value == want[name].default, name


@pytest.mark.parametrize("param_dtype,mu_dtype", [
    (torch.float32, None), (torch.bfloat16, torch.float32),
    (torch.bfloat16, None)], ids=["f32", "bf16-mu-f32", "bf16"])
def test_adamw_matches_optax(param_dtype, mu_dtype):
    """Three AdamW steps on the same params and gradients: the port's
    optimizer against optax.adamw (run op by op, as PyTorch runs). f32
    params agree to 1e-5; bf16 params, mu and nu within one bf16 ulp."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           None: None}
    jcfg, cfg = _pair(dtype=param_dtype)
    jp, p = _params(jcfg, cfg, seed=2)
    jtx = optax.adamw(1e-2, mu_dtype=jdt[mu_dtype])
    tx = optim.adamw(1e-2, mu_dtype=mu_dtype)
    jstate, state = jtx.init(jp), tx.init(p)
    rng = np.random.default_rng(3)
    for _ in range(3):
        g = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32) * 0.1, jax.tree.map(np.asarray, jp))
        jg = jax.tree.map(lambda a: jnp.asarray(a, jdt[param_dtype]), g)
        updates, jstate = jtx.update(jg, jstate, jp)
        jp = optax.apply_updates(jp, updates)
        tg = interop.params_from_numpy(jax.tree.map(np.asarray, jg), cfg,
                                       "cpu")
        tx.update_(tg, state, p)
    adam = jstate[0]
    assert state.count == int(adam.count) == 3
    assert wl.tree_leaves(state.mu)[0].dtype == (mu_dtype or param_dtype)
    if param_dtype == torch.float32:
        _assert_trees_close(p, jp, atol=1e-5)
        _assert_trees_close(state.mu, adam.mu, rtol=1e-5, atol_of_max=1e-6)
        _assert_trees_close(state.nu, adam.nu, rtol=1e-5, atol_of_max=1e-6)
    else:
        _assert_within_one_bf16_ulp(p, jp)
        _assert_within_one_bf16_ulp(state.nu, adam.nu)
        if mu_dtype is None:
            _assert_within_one_bf16_ulp(state.mu, adam.mu)
        else:
            _assert_trees_close(state.mu, adam.mu, rtol=1e-5,
                                atol_of_max=1e-6)


def test_adamw_rounds_constants_as_jax_does():
    """JAX rounds a Python scalar to the array's dtype before it multiplies:
    with bf16 state optax's b2 = 0.999 is 1.0, and nu does not decay."""
    assert optim._as(0.999, torch.bfloat16) == 1.0
    assert float(jnp.asarray(0.999, jnp.bfloat16)) == 1.0
    assert optim._as(0.999, torch.float32) == float(np.float32(0.999))


# Full AdamW steps hold params to 1e-4 absolute, a tenth of lr: Adam divides
# by √nu, so where a gradient element nearly cancels across steps, the
# float-level differences between the two frameworks' gradients move its
# update by a few % of lr. The optimizer alone, on identical gradients, is
# held to 1e-5 in test_adamw_matches_optax.
ADAMW_STEP_ATOL = 1e-4


def _jax_adamw_step(jcfg, tx):
    def step(jp, opt, toks):
        loss, grads = jax.value_and_grad(jwl.loss_fn)(jp, toks, jcfg)
        updates, opt = tx.update(grads, opt, jp)
        return optax.apply_updates(jp, updates), opt, loss
    return step


@pytest.mark.parametrize("attn", ["naive", "flash"])
def test_adamw_train_steps_match_reference(attn):
    """Three steps of make_optax_train_step with AdamW, f32 tiny, against
    the reference's step body (value_and_grad, tx.update, apply_updates)."""
    jcfg, cfg = _pair(attn=attn, remat=True)
    jp, p = _params(jcfg, cfg, seed=4)
    jstep = _jax_adamw_step(jcfg, optax.adamw(1e-3))
    jopt = optax.adamw(1e-3).init(jp)
    step, init_opt, pshard, tshard = wl.make_optax_train_step(
        None, cfg, optim.adamw(1e-3))
    assert pshard is None and tshard is None
    opt = init_opt(p)
    for i in range(3):
        toks = _tokens(cfg, 2, 20 + i)
        jp, jopt, jloss = jstep(jp, jopt, jnp.asarray(toks))
        p, opt, loss = step(p, opt, torch.from_numpy(toks).long())
        assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    _assert_trees_close(p, jp, atol=ADAMW_STEP_ATOL)


def test_accum_step_matches_one_whole_batch_step():
    """Four microbatches of 2 in one accumulation step land where one
    AdamW step over the batch of 8 does: mean loss and params."""
    cfg = wl.ModelConfig.tiny()
    toks = torch.from_numpy(_tokens(cfg, 8, 30)).long()
    tx = optim.adamw(1e-3)
    step, init_opt, _, _ = wl.make_optax_train_step(None, cfg, tx)
    p = wl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    p, _, loss = step(p, init_opt(p), toks)
    astep, ainit, _, _ = wl.make_accum_train_step(None, cfg, tx, 4)
    ap = wl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    ap, _, aloss = astep(ap, ainit(ap), toks.reshape(4, 2, cfg.seq))
    assert aloss.item() == pytest.approx(loss.item(), rel=1e-5)
    for a, b in zip(wl.tree_leaves(ap), wl.tree_leaves(p)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_accum_step_matches_reference():
    """Against the reference's accumulation step on a one-device dp mesh,
    AdamW, f32; the divisor comes from the stack (3 microbatches, built
    for 4)."""
    jcfg, cfg = _pair()
    jp, p = _params(jcfg, cfg, seed=5)
    stack = _tokens(cfg, 6, 31).reshape(3, 2, cfg.seq)
    mesh = meshlib.build_named_mesh({"dp": 1})
    jstep, jinit, jpshard, jsshard = jwl.make_accum_train_step(
        mesh, jcfg, optax.adamw(1e-3), accum_steps=4)
    jp = jax.device_put(jp, jpshard)
    jp, _, jloss = jstep(jp, jinit(jp), jax.device_put(jnp.asarray(stack),
                                                       jsshard))
    step, init_opt, _, _ = wl.make_accum_train_step(None, cfg,
                                                    optim.adamw(1e-3), 4)
    p, _, loss = step(p, init_opt(p), torch.from_numpy(stack).long())
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    _assert_trees_close(p, jp, atol=ADAMW_STEP_ATOL)


def test_mixed_precision_masters_and_mu_stay_f32():
    """f32 masters, bf16 compute: gradients come back f32 through the cast,
    the step keeps masters and both moments f32, and the loss is the
    reference's to bf16 precision."""
    jcfg, cfg = _pair(dtype=torch.bfloat16, param_dtype=torch.float32)
    jp, p = _params(jcfg, cfg, seed=6)
    assert wl.tree_leaves(p)[0].dtype == torch.float32
    toks = _tokens(cfg, 2, 32)
    step, init_opt, _, _ = wl.make_optax_train_step(None, cfg,
                                                    optim.adamw(1e-3))
    opt = init_opt(p)
    _, grads = wl.value_and_grad(p, torch.from_numpy(toks).long(), cfg)
    assert all(g.dtype == torch.float32 for g in wl.tree_leaves(grads))
    p, opt, loss = step(p, opt, torch.from_numpy(toks).long())
    for tree in (p, opt.mu, opt.nu):
        assert all(t.dtype == torch.float32 for t in wl.tree_leaves(tree))
    jloss = jwl.loss_fn(jp, jnp.asarray(toks), jcfg)
    assert loss.item() == pytest.approx(float(jloss), rel=2e-2)


@pytest.mark.parametrize("make", ["make_optax_train_step",
                                  "make_accum_train_step"])
def test_sharded_steps_wait_for_the_parallelism_slice(make):
    args = (4,) if make == "make_accum_train_step" else ()
    with pytest.raises(NotImplementedError, match="Parallelism"):
        getattr(wl, make)(object(), wl.ModelConfig.tiny(),
                          optim.adamw(1e-3), *args)
