"""The single-card train steps as programs (``program.Program``), on the CPU.

Without a mesh, ``make_sharded_train_step`` (SGD), ``make_optax_train_step``
(AdamW) and ``make_accum_train_step`` each run a program over static
buffers: captured as a CUDA graph on the card, its body called as it is
here. On tiny f32, dense (remat on) and with 4 experts (the capacity
path), three steps of each:

- equal the eager path the port ran before the steps became programs
  (written out below: ``sgd_train_step``'s new tree, AdamW's corrections
  as Python floats, the accumulation's list of losses) bitwise, losses,
  params and both moments;
- equal jaxbridge's ``sgd_train_step``, ``make_optax_train_step`` and
  ``make_accum_train_step`` within the tolerances
  ``tests/test_torch_train.py`` pins;
- read a bias correction that follows the step count (a step that
  replayed step 1's would fail here);
- and a call with another tree updates that tree's tensors and leaves the
  tensors of the first as they were;
- hold no tree alive after the call (a dropped tree is freed), and are
  freed, programs and all, once the step is dropped;
- and over a one-rank mesh run the same body, bit for bit.
"""
from __future__ import annotations

import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpusched.jaxbridge import mesh as meshlib
from tpusched.jaxbridge import workload as jwl
from tpusched_torch import interop, optim, workload as wl
from tpusched_torch import mesh as tmesh
from tpusched_torch.program import Program

torch.set_num_threads(1)

KINDS = {"dense": {"remat": True}, "moe": {"n_experts": 4}}
OPTS = ["sgd", "adamw", "accum"]
LR = {"sgd": 1e-2, "adamw": 1e-3, "accum": 1e-3}
ACCUM = 4
STACKS = (4, 3, 4)          # the second stack shorter than ACCUM
STEPS = 3
# as tests/test_torch_train.py: SGD params within 1e-5 of the largest, AdamW
# params within 1e-4 absolute (a tenth of lr), losses within 1e-5 relative
SGD_ATOL_OF_MAX = 1e-5
ADAMW_STEP_ATOL = 1e-4


def _pair(kind):
    return (dataclasses.replace(jwl.ModelConfig.tiny(), **KINDS[kind]),
            dataclasses.replace(wl.ModelConfig.tiny(), **KINDS[kind]))


def _params(jcfg, cfg, seed=0):
    jp = jwl.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, interop.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                         "cpu")


def _batches(opt, cfg):
    """Each step's tokens: (2, S) rows, or an (n, 2, S) stack."""
    rng = np.random.default_rng(40)
    if opt == "accum":
        return [rng.integers(0, cfg.vocab, (n, 2, cfg.seq), dtype=np.int32)
                for n in STACKS]
    return [rng.integers(0, cfg.vocab, (2, cfg.seq), dtype=np.int32)
            for _ in range(STEPS)]


def _clone(tree):
    return wl.tree_map(torch.clone, tree)


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    return {path: leaf for k, v in items
            for path, leaf in _named(v, f"{prefix}/{k}").items()}


def _program_run(opt, cfg, params, batches):
    """The port's step (a program, its body called on the CPU) over
    ``batches``: (losses, params, AdamW state or None)."""
    if opt == "sgd":
        step, _, _ = wl.make_sharded_train_step(None, cfg, lr=LR[opt])
        losses = []
        for toks in batches:
            out, loss = step(params, torch.from_numpy(toks).long())
            assert out is params          # updated in place, as donated
            losses.append(loss)
        return losses, params, None
    tx = optim.adamw(LR[opt])
    if opt == "adamw":
        step, init_opt, _, _ = wl.make_optax_train_step(None, cfg, tx)
    else:
        step, init_opt, _, _ = wl.make_accum_train_step(None, cfg, tx, ACCUM)
    state = init_opt(params)
    losses = []
    for toks in batches:
        out, out_state, loss = step(params, state,
                                    torch.from_numpy(toks).long())
        assert out is params and out_state is state
        losses.append(loss)
    return losses, params, state


# -- the eager path as it was before the steps became programs ----------------

@torch.no_grad()
def _eager_adamw_update(tx, grads, state, params):
    """``optim.AdamW.update_`` before its split: the bias corrections as
    Python floats."""
    state.count += 1
    t = state.count
    for g, mu, nu, p in zip(wl.tree_leaves(grads), wl.tree_leaves(state.mu),
                            wl.tree_leaves(state.nu), wl.tree_leaves(params)):
        mu_new = (optim._as(1 - optim.B1, g.dtype) * g
                  + optim._as(optim.B1, mu.dtype) * mu)
        nu_new = (optim._as(1 - optim.B2, g.dtype) * g.square()
                  + optim._as(optim.B2, nu.dtype) * nu)
        mu_hat = mu_new / optim._bias_correction(optim.B1, t, mu_new.dtype)
        nu_hat = nu_new / optim._bias_correction(optim.B2, t, nu_new.dtype)
        u = mu_hat / (nu_hat.sqrt() + optim._as(optim.EPS, nu_hat.dtype))
        u = u + optim._as(optim.WEIGHT_DECAY, p.dtype) * p
        u = optim._as(-tx.lr, u.dtype) * u
        p.copy_(p + u)
        mu.copy_(mu_new)
        nu.copy_(nu_new)


def _eager_run(opt, cfg, params, batches):
    """The same steps as the eager code computed them: (losses, params,
    AdamW state or None)."""
    losses = []
    if opt == "sgd":
        for toks in batches:
            params, loss = wl.sgd_train_step(
                params, torch.from_numpy(toks).long(), cfg, lr=LR[opt])
            losses.append(loss)
        return losses, params, None
    tx = optim.adamw(LR[opt])
    state = tx.init(params)
    for toks in batches:
        toks = torch.from_numpy(toks).long()
        if opt == "adamw":
            loss, grads = wl.value_and_grad(params, toks, cfg)
        else:
            acc = wl.tree_map(lambda p: torch.zeros(p.shape), params)
            micro = []
            for t in toks:
                loss, g = wl.value_and_grad(params, t, cfg)
                wl.tree_map(lambda a, x: a.add_(x.float()), acc, g)
                micro.append(loss)
            loss = torch.stack(micro).mean()
            grads = wl.tree_map(lambda a: a / toks.shape[0], acc)
        _eager_adamw_update(tx, wl.tree_map(lambda p, g: g.to(p.dtype),
                                            params, grads), state, params)
        losses.append(loss)
    return losses, params, state


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("opt", OPTS)
def test_program_steps_equal_the_eager_steps_bitwise(opt, kind):
    """Three steps through the program's body equal the eager steps bit
    for bit: every loss, every parameter and, for AdamW, mu, nu and the
    count."""
    jcfg, cfg = _pair(kind)
    _, p = _params(jcfg, cfg, seed=1)
    batches = _batches(opt, cfg)
    losses, params, state = _program_run(opt, cfg, _clone(p), batches)
    ref_losses, ref_params, ref_state = _eager_run(opt, cfg, _clone(p),
                                                   batches)
    assert all(torch.equal(a, b) for a, b in zip(losses, ref_losses))
    trees = [(params, ref_params)]
    if state is not None:
        assert state.count == ref_state.count == len(batches)
        trees += [(state.mu, ref_state.mu), (state.nu, ref_state.nu)]
    for got, want in trees:
        for path, leaf in _named(want).items():
            assert torch.equal(_named(got)[path], leaf), path


def _jax_run(opt, jcfg, jp, batches):
    """jaxbridge's steps over the same batches: (losses, params)."""
    losses = []
    if opt == "sgd":
        for toks in batches:
            jp, loss = jwl.sgd_train_step(jp, jnp.asarray(toks), jcfg,
                                          lr=LR[opt])
            losses.append(float(loss))
        return losses, jp
    mesh = meshlib.build_named_mesh({"dp": 1})
    tx = optax.adamw(LR[opt])
    if opt == "adamw":
        step, init, pshard, tshard = jwl.make_optax_train_step(mesh, jcfg, tx)
    else:
        step, init, pshard, tshard = jwl.make_accum_train_step(
            mesh, jcfg, tx, accum_steps=ACCUM)
    jp = jax.device_put(jp, pshard)
    state = init(jp)
    for toks in batches:
        jp, state, loss = step(jp, state, jax.device_put(jnp.asarray(toks),
                                                         tshard))
        losses.append(float(loss))
    return losses, jp


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("opt", OPTS)
def test_program_steps_match_reference(opt, kind):
    """Three steps of the port's program against jaxbridge's steps from the
    same weights and batches: losses within 1e-5 relative, SGD params
    within 1e-5 of the largest, AdamW params within 1e-4 absolute."""
    jcfg, cfg = _pair(kind)
    jp, p = _params(jcfg, cfg, seed=2)
    batches = _batches(opt, cfg)
    losses, params, _ = _program_run(opt, cfg, p, batches)
    ref_losses, ref_params = _jax_run(opt, jcfg, jp, batches)
    assert [x.item() for x in losses] == pytest.approx(ref_losses, rel=1e-5)
    got, want = _named(params), _named(ref_params)
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        ref = np.asarray(leaf, np.float32)
        atol = (SGD_ATOL_OF_MAX * np.abs(ref).max() if opt == "sgd"
                else ADAMW_STEP_ATOL)
        np.testing.assert_allclose(got[path].numpy(), ref, rtol=0,
                                   atol=atol, err_msg=path)


@pytest.mark.parametrize("opt", ["adamw", "accum"])
def test_bias_correction_follows_the_step_count(opt, monkeypatch):
    """The device part reads each step's own corrections ``1 − b**t``
    from its buffers: steps 1, 2 and 3 read three different values, each
    optax's for its count (a step that kept step 1's would decay its
    moments wrongly and still lower the loss)."""
    _, cfg = _pair("dense")
    p = wl.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    seen = []
    apply_ = optim.AdamW.apply_

    def spy(self, grads, state, params, corr):
        seen.append({key[0]: buf.item() for key, buf in corr.items()})
        return apply_(self, grads, state, params, corr)

    monkeypatch.setattr(optim.AdamW, "apply_", spy)
    _program_run(opt, cfg, p, _batches(opt, cfg))
    for decay in (optim.B1, optim.B2):
        got = [s[decay] for s in seen]
        want = [optim._bias_correction(decay, t, torch.float32)
                for t in range(1, STEPS + 1)]
        assert got == want and len(set(got)) == STEPS, (decay, got)


@pytest.mark.parametrize("opt", OPTS)
def test_a_call_with_another_tree_updates_that_tree(opt):
    """Two steps on tree A, then one on tree B (new tensors, as after a
    restore): B's tensors move, A's stay as A's two steps left them, and
    B's step equals a fresh step's on B."""
    _, cfg = _pair("dense")
    p = wl.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    toks = [torch.from_numpy(b).long() for b in _batches(opt, cfg)]
    tx = optim.adamw(LR[opt])
    if opt == "sgd":
        step, _, _ = wl.make_sharded_train_step(None, cfg, lr=LR[opt])

        def run(s, tree, state, t):
            return s(tree, t)[1]
        fresh_step = wl.make_sharded_train_step(None, cfg, lr=LR[opt])[0]
        init_opt = lambda _: None   # noqa: E731
    else:
        make = (wl.make_optax_train_step if opt == "adamw" else
                lambda m, c, x: wl.make_accum_train_step(m, c, x, ACCUM))
        step, init_opt, _, _ = make(None, cfg, tx)
        fresh_step = make(None, cfg, tx)[0]

        def run(s, tree, state, t):
            return s(tree, state, t)[2]
    a, b, fresh = _clone(p), _clone(p), _clone(p)
    sa, sb, sf = init_opt(a), init_opt(b), init_opt(fresh)
    run(step, a, sa, toks[0])
    run(step, a, sa, toks[1])
    a_after = _clone(a)
    loss = run(step, b, sb, toks[2])
    want = run(fresh_step, fresh, sf, toks[2])
    assert torch.equal(loss, want)
    for x, y, z, w in zip(wl.tree_leaves(a), wl.tree_leaves(a_after),
                          wl.tree_leaves(b), wl.tree_leaves(fresh)):
        assert torch.equal(x, y) and torch.equal(z, w)
    assert not all(torch.equal(x, y) for x, y in zip(wl.tree_leaves(b),
                                                     wl.tree_leaves(p)))


@pytest.mark.parametrize("opt", OPTS)
def test_the_step_keeps_no_tree_alive(opt):
    """After a call the step holds its tree only by weak references: the
    caller's ``del`` frees params and state (before a restore loads the
    next tree, say), and a later call with another tree runs."""
    _, cfg = _pair("dense")
    p = wl.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    toks = [torch.from_numpy(b).long() for b in _batches(opt, cfg)]
    tx = optim.adamw(LR[opt])
    if opt == "sgd":
        step = wl.make_sharded_train_step(None, cfg, lr=LR[opt])[0]
        call = lambda tree, state, t: step(tree, t)   # noqa: E731
        init_opt = lambda _: None                      # noqa: E731
    else:
        step, init_opt, _, _ = (
            wl.make_optax_train_step(None, cfg, tx) if opt == "adamw"
            else wl.make_accum_train_step(None, cfg, tx, ACCUM))
        call = step
    tree = _clone(p)
    state = init_opt(tree)
    call(tree, state, toks[0])
    assert step._programs.tree.params is None
    assert step._programs.tree.state is None
    held = wl.tree_leaves(tree)
    if state is not None:
        held += wl.tree_leaves(state.mu) + wl.tree_leaves(state.nu)
    refs = [weakref.ref(t) for t in held]
    del tree, state, held
    gc.collect()
    assert all(r() is None for r in refs)
    other = _clone(p)
    assert torch.isfinite(call(other, init_opt(other), toks[1])[-1])


@pytest.mark.parametrize("opt", OPTS)
def test_a_dropped_step_frees_its_programs_at_once(opt):
    """No reference cycle holds a step's programs: the last reference to
    the step dropped, they are freed at once, by their count, and not
    left to the cyclic collector (which on the card could destroy their
    graph in the middle of another program's capture)."""
    _, cfg = _pair("dense")
    p = wl.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    toks = torch.from_numpy(_batches(opt, cfg)[0]).long()
    tx = optim.adamw(LR[opt])
    if opt == "sgd":
        step = wl.make_sharded_train_step(None, cfg, lr=LR[opt])[0]
        step(p, toks)
    else:
        step, init_opt, _, _ = (
            wl.make_optax_train_step(None, cfg, tx) if opt == "adamw"
            else wl.make_accum_train_step(None, cfg, tx, ACCUM))
        step(p, init_opt(p), toks)
    progs = step._programs.programs
    refs = [weakref.ref(x) for x in (
        (progs,) if isinstance(progs, Program) else progs)
        if isinstance(x, Program)]
    assert refs
    collecting = gc.isenabled()
    gc.disable()
    try:
        del progs, step
        assert all(r() is None for r in refs)
    finally:
        if collecting:
            gc.enable()


@pytest.mark.parametrize("opt", OPTS)
def test_a_mesh_step_runs_the_same_body(opt):
    """Over a mesh the step is the same program, its body called: on a
    one-rank {"dp": 1} mesh (no collective) three steps equal the
    single-card step's bit for bit, params updated in place."""
    jcfg, cfg = _pair("dense")
    _, p = _params(jcfg, cfg, seed=6)
    batches = [torch.from_numpy(b).long() for b in _batches(opt, cfg)]
    tx = optim.adamw(LR[opt])
    out = {}
    for name, mesh in (("mesh", tmesh.Mesh({"dp": 1})), ("card", None)):
        tree = _clone(p)
        if opt == "sgd":
            step = wl.make_sharded_train_step(mesh, cfg, lr=LR[opt])[0]
            losses = [step(tree, t)[1] for t in batches]
        else:
            step, init_opt, _, _ = (
                wl.make_optax_train_step(mesh, cfg, tx) if opt == "adamw"
                else wl.make_accum_train_step(mesh, cfg, tx, ACCUM))
            state = init_opt(tree)
            losses = [step(tree, state, t)[2] for t in batches]
        progs = step._programs.programs
        first = progs if isinstance(progs, Program) else progs[0]
        assert isinstance(first, Program) and not first.graphed
        out[name] = (losses, tree)
    for a, b in zip(out["mesh"][0], out["card"][0]):
        assert torch.equal(a, b)
    for path, leaf in _named(out["card"][1]).items():
        assert torch.equal(_named(out["mesh"][1])[path], leaf), path
    assert not torch.equal(out["mesh"][1]["embed"], p["embed"])


def test_programs_are_bodies_on_the_cpu():
    """On the CPU each step is a program whose body is called, the loss
    written into the output the first call made; the step hands back a
    copy, so a kept loss outlives the next call."""
    cfg = wl.ModelConfig.tiny()
    p = wl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.from_numpy(_batches("sgd", cfg)[0]).long()
    step, _, _ = wl.make_sharded_train_step(None, cfg, lr=1e-2)
    kept = step(p, toks)[1]
    prog = step._programs.programs
    assert isinstance(prog, Program) and prog.advances
    assert not prog.graphed and prog.graph is None
    first = prog.outputs
    assert torch.equal(first, kept) and first is not kept
    second = step(p, toks)[1]
    assert step._programs.programs is prog and prog.outputs is first
    assert torch.equal(second, first) and not torch.equal(second, kept)
