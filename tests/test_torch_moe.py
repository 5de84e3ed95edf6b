"""The port's mixture-of-experts family against tpusched.jaxbridge on the
CPU: routing (ties included), capacity, the capacity and dropless MoE
layers, the forward with its aux loss, loss and gradients, mixed precision,
and the inference path (prefill, decode, greedy generation, the serving
engine). The JAX parameters come across through interop; inputs are made
with numpy from a seed."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusched.jaxbridge import decode as jdec, workload as jwl
from tpusched_torch import decode, interop, workload as wl
from tpusched_torch.serve import Request, ServeEngine

torch.set_num_threads(1)


def _pair(**changes):
    """(reference cfg, port cfg): tiny() with 4 experts and ``changes``."""
    changes = {"n_experts": 4, **changes}
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
    jchanges = {k: jdt.get(v, v) for k, v in changes.items()}
    return (dataclasses.replace(jwl.ModelConfig.tiny(), **jchanges),
            dataclasses.replace(wl.ModelConfig.tiny(), **changes))


def _params(jcfg, cfg, seed=0):
    jp = jwl.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, interop.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                         "cpu")


def _x(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, shape,
                                                dtype=np.int32)


def _close(got, ref, rel=1e-5):
    """Within ``rel`` of the reference's largest magnitude."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-30))


def _forced_router(cfg, jp, p, scale=100.0):
    """Every token routed to expert 0 (then expert 1), as in
    tests/test_moe.py's overflow case."""
    router = np.zeros((cfg.d_model, cfg.n_experts), np.float32)
    router[:, 0], router[:, 1] = 1.0, 0.5
    for jlayer, layer in zip(jp["layers"], p["layers"]):
        jlayer["router"] = jnp.asarray(router * scale)
        layer["router"] = torch.from_numpy(router * scale)


@pytest.mark.parametrize("router", ["random", "zero"])
def test_router_gates_match_reference(router):
    """Same experts, same gates; a zero router makes every probability equal,
    and both sides then pick experts 0 and 1 (torch.topk would not)."""
    jcfg, cfg = _pair()
    w = (_x(1, (cfg.d_model, 4)) / 8 if router == "random"
         else np.zeros((cfg.d_model, 4), np.float32))
    x = _x(2, (40, cfg.d_model))
    jprobs, jgate, jidx = jwl._router_gates(jnp.asarray(x),
                                            {"router": jnp.asarray(w)}, jcfg)
    probs, gate, idx = wl._router_gates(torch.from_numpy(x),
                                        {"router": torch.from_numpy(w)}, cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gate.numpy(), np.asarray(jgate), atol=1e-6)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-6)
    if router == "zero":
        assert (idx.numpy() == [0, 1]).all()


@pytest.mark.parametrize("n_experts", [1, 2, 4, 8, 16])
def test_moe_capacity_matches_reference(n_experts):
    for k in (1, 2, 4):
        for factor in (0.25, 1.0, 1.25, 2.0):
            for tokens in (1, 7, 16, 64, 1000, 1024, 4096):
                changes = dict(n_experts=n_experts, moe_top_k=k,
                               moe_capacity_factor=factor)
                jcfg, cfg = _pair(**changes)
                assert wl.moe_capacity(cfg, tokens) == \
                    jwl.moe_capacity(jcfg, tokens), (changes, tokens)
    assert wl.moe_capacity(wl.ModelConfig.mixtral_like(seq=1024), 1024) == 320


@pytest.mark.parametrize("case", ["routed", "overflow"])
def test_moe_mlp_matches_reference(case):
    """The capacity path's output and aux loss. In the overflow case every
    token (all with positive features) picks expert 0, then expert 1, and
    each expert takes 4 slots: only the first 4 tokens are served, the rest
    pass through with a zero MLP output."""
    changes = dict(moe_capacity_factor=0.25) if case == "overflow" else {}
    jcfg, cfg = _pair(**changes)
    jp, p = _params(jcfg, cfg, seed=1)
    h = _x(3, (2, 16, cfg.d_model))
    if case == "overflow":
        _forced_router(cfg, jp, p)
        h = np.abs(h)
    jout, jaux = jwl._moe_mlp(jnp.asarray(h), jp["layers"][0], jcfg)
    out, aux = wl._moe_mlp(torch.from_numpy(h), p["layers"][0], cfg)
    _close(out, jout)
    assert aux.item() == pytest.approx(float(jaux), rel=1e-5)
    if case == "overflow":
        assert wl.moe_capacity(cfg, 32) == 4
        served = out.reshape(32, -1).abs().sum(dim=-1) > 0
        assert served.tolist() == [True] * 4 + [False] * 28
        assert aux.item() == pytest.approx(4.0, rel=1e-3)   # all on one


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_mlp_dropless_matches_reference(top_k):
    jcfg, cfg = _pair(moe_top_k=top_k)
    jp, p = _params(jcfg, cfg, seed=2)
    h = _x(4, (3, 5, cfg.d_model))
    jout, jaux = jwl._moe_mlp_dropless(jnp.asarray(h), jp["layers"][1], jcfg)
    out, aux = wl._moe_mlp_dropless(torch.from_numpy(h), p["layers"][1], cfg)
    _close(out, jout)
    assert aux == float(jaux) == 0.0


def test_dropless_output_depends_on_its_token_alone():
    """A token's dropless output is the same alone or among other tokens;
    the capacity path's is not (a crowded expert drops it)."""
    cfg = dataclasses.replace(wl.ModelConfig.tiny(), n_experts=4,
                              moe_capacity_factor=0.25)
    p = wl.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    layer = p["layers"][0]
    h = torch.from_numpy(_x(5, (1, 24, cfg.d_model)))
    together, _ = wl._moe_mlp_dropless(h, layer, cfg)
    alone = torch.cat([wl._moe_mlp_dropless(h[:, i:i + 1], layer, cfg)[0]
                       for i in range(24)], dim=1)
    torch.testing.assert_close(together, alone, rtol=1e-5, atol=1e-6)
    crowded, _ = wl._moe_mlp(h, layer, cfg)
    solo = torch.cat([wl._moe_mlp(h[:, i:i + 1], layer, cfg)[0]
                      for i in range(24)], dim=1)
    assert not torch.allclose(crowded, solo, atol=1e-3)


def test_single_expert_equals_dense():
    """E=1, top-1, ample capacity: the MoE layer is the dense SwiGLU with
    that expert's weights, on both sides."""
    jcfg, cfg = _pair(n_experts=1, moe_top_k=1, moe_capacity_factor=4.0)
    jp, p = _params(jcfg, cfg, seed=4)
    dense = dataclasses.replace(cfg, n_experts=0)
    dp = {**p, "layers": [{k: (v[0] if k.startswith("w_") and v.ndim == 3
                               else v) for k, v in layer.items()
                           if k != "router"} for layer in p["layers"]]}
    toks = torch.from_numpy(_tokens(cfg, (2, 16), 5)).long()
    got = wl.forward(p, toks, cfg)
    torch.testing.assert_close(got, wl.forward(dp, toks, dense),
                               rtol=1e-5, atol=1e-5)
    _close(got, jwl.forward(jp, jnp.asarray(toks.numpy()), jcfg))


@pytest.mark.parametrize("attn", ["naive", "flash"])
def test_forward_with_aux_matches_reference(attn):
    jcfg, cfg = _pair(attn=attn)
    jp, p = _params(jcfg, cfg, seed=5)
    toks = _tokens(cfg, (2, 32), 6)
    jlogits, jaux = jwl.forward(jp, jnp.asarray(toks), jcfg, with_aux=True)
    logits, aux = wl.forward(p, torch.from_numpy(toks).long(), cfg,
                             with_aux=True)
    _close(logits, jlogits)
    assert aux.dtype == torch.float32 and aux.item() > 0
    assert aux.item() == pytest.approx(float(jaux), rel=1e-5)
    dense_cfg = dataclasses.replace(cfg, n_experts=0)
    dense = wl.init_params(dense_cfg, torch.Generator().manual_seed(0), "cpu")
    _, zero = wl.forward(dense, torch.from_numpy(toks).long(), dense_cfg,
                         with_aux=True)
    assert zero.item() == 0.0


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    return {path: leaf for k, v in items
            for path, leaf in _named(v, f"{prefix}/{k}").items()}


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_loss_and_grads_match_reference(remat):
    """loss_fn (nll + aux weight × aux) and every gradient, the router's
    included, against jax.value_and_grad of the reference's loss_fn."""
    jcfg, cfg = _pair(remat=remat)
    jp, p = _params(jcfg, cfg, seed=6)
    toks = _tokens(cfg, (2, cfg.seq), 7)
    jloss, jgrads = jax.value_and_grad(jwl.loss_fn)(jp, jnp.asarray(toks),
                                                    jcfg)
    loss, grads = wl.value_and_grad(p, torch.from_numpy(toks).long(), cfg)
    assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
    got, ref = _named(grads), _named(jgrads)
    assert got.keys() == ref.keys() and "/layers/0/router" in got
    for path in ref:
        _close(got[path], ref[path], rel=1e-4)


def test_mixed_precision_keeps_the_router_f32():
    """f32 masters, bf16 compute: every leaf but the router is cast, the
    router's gradient and AdamW state stay f32, and the loss is the
    reference's to bf16 precision."""
    from tpusched_torch import optim
    jcfg, cfg = _pair(dtype=torch.bfloat16, param_dtype=torch.float32)
    jp, p = _params(jcfg, cfg, seed=7)
    cast = wl.cast_params_for_compute(p, cfg)
    assert cast["layers"][0]["router"].dtype == torch.float32
    assert cast["layers"][0]["w_gate"].dtype == torch.bfloat16
    toks = torch.from_numpy(_tokens(cfg, (2, cfg.seq), 8)).long()
    loss, grads = wl.value_and_grad(p, toks, cfg)
    assert all(g.dtype == torch.float32 for g in wl.tree_leaves(grads))
    jloss = jwl.loss_fn(jp, jnp.asarray(toks.numpy()), jcfg)
    assert loss.item() == pytest.approx(float(jloss), rel=2e-2)
    # a bf16 model's router stays f32, and so do its gradient and state
    bf = dataclasses.replace(cfg, param_dtype=None)
    bp = wl.init_params(bf, torch.Generator().manual_seed(0), "cpu")
    assert bp["layers"][0]["router"].dtype == torch.float32
    assert bp["layers"][0]["w_up"].dtype == torch.bfloat16
    step, init_opt, _, _ = wl.make_optax_train_step(None, bf,
                                                    optim.adamw(1e-3))
    state = init_opt(bp)
    bp, state, loss = step(bp, state, toks)
    assert np.isfinite(loss.item())
    for tree in (bp, state.mu, state.nu):
        assert tree["layers"][1]["router"].dtype == torch.float32
    _, bgrads = wl.value_and_grad(bp, toks, bf)
    assert bgrads["layers"][0]["router"].dtype == torch.float32


def test_bf16_forward_matches_reference(monkeypatch):
    """bf16 at a fixed seed whose routes agree on both sides (recorded at
    every layer and asserted), within 2e-2 of the largest logit."""
    jcfg, cfg = _pair(dtype=torch.bfloat16)
    # at some seeds a token's top-2 flips between two near-equal experts
    # in bf16, and its output then differs by far more than rounding
    jp, p = _params(jcfg, cfg, seed=11)
    assert p["layers"][0]["router"].dtype == torch.float32
    routes = {"jax": [], "torch": []}

    def recording(side, fn):
        def wrapped(*args, **kw):
            out = fn(*args, **kw)
            routes[side].append(np.asarray(out[2]))
            return out
        return wrapped

    monkeypatch.setattr(jwl, "_router_gates",
                        recording("jax", jwl._router_gates))
    monkeypatch.setattr(wl, "_router_gates",
                        recording("torch", wl._router_gates))
    toks = _tokens(cfg, (2, 16), 9)
    ref = jwl.forward(jp, jnp.asarray(toks), jcfg)
    got = wl.forward(p, torch.from_numpy(toks).long(), cfg)
    assert len(routes["torch"]) == len(routes["jax"]) == cfg.n_layers
    for a, b in zip(routes["torch"], routes["jax"]):
        np.testing.assert_array_equal(a, b)
    _close(got, ref, rel=2e-2)


def test_interop_carries_the_moe_tree():
    """The router is checked as f32 and the expert stacks as the master
    dtype; a router of another dtype is refused."""
    jcfg, cfg = _pair(dtype=torch.bfloat16)
    jp = jwl.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    p = interop.params_from_numpy(tree, cfg, "cpu")
    assert set(p["layers"][0]) == set(jp["layers"][0])
    assert p["layers"][0]["w_down"].shape == (4, cfg.d_ff, cfg.d_model)
    np.testing.assert_array_equal(p["layers"][1]["router"].numpy(),
                                  tree["layers"][1]["router"])
    tree["layers"][1]["router"] = tree["layers"][1]["router"].astype(
        tree["embed"].dtype)
    with pytest.raises(ValueError, match=r"layers\[1\]\.router: dtype"):
        interop.params_from_numpy(tree, cfg, "cpu")


@pytest.mark.parametrize("attn", ["naive", "flash"])
def test_prefill_and_decode_steps_match_reference(attn):
    """Prefill, then two decode steps at per-row positions: logits and the
    cache, through the dropless path on both sides."""
    jcfg, cfg = _pair(attn=attn, n_kv_heads=1)
    jp, p = _params(jcfg, cfg, seed=10)
    prompt = _tokens(cfg, (3, 8), 11)
    jl, jc = jdec.prefill(jp, jdec.init_kv_cache(jcfg, 3, 16),
                          jnp.asarray(prompt), jcfg)
    pl, pc = decode.prefill(p, decode.init_kv_cache(cfg, 3, 16, "cpu"),
                            torch.from_numpy(prompt).long(), cfg)
    _close(pl, jl, rel=1e-4)
    tok = _tokens(cfg, (3,), 12)
    pos = np.array([8, 5, 7], np.int32)
    for _ in range(2):
        jlog, jc = jdec.decode_step(jp, jc, jnp.asarray(tok),
                                    jnp.asarray(pos), jcfg)
        plog, pc = decode.decode_step(p, pc, torch.from_numpy(tok).long(),
                                      torch.as_tensor(pos), cfg)
        _close(plog, jlog, rel=1e-4)
        for jlayer, layer in zip(jc, pc):
            _close(layer["k"], jlayer["k"])
        tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
        pos = pos + 1


@pytest.mark.parametrize("seed", [0, 13])
def test_generate_greedy_tokens_equal_reference(seed):
    jcfg, cfg = _pair()
    jp, p = _params(jcfg, cfg, seed=seed)
    prompt = _tokens(cfg, (2, 9), seed + 1)
    ref = np.asarray(jdec.generate(jp, jnp.asarray(prompt), jcfg, steps=7))
    got = decode.generate(p, torch.from_numpy(prompt).long(), cfg, steps=7)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("attn", ["naive", "flash"])
def test_engine_matches_solo_and_reference(attn):
    """Continuous batching on an MoE model: every completion equals the
    port's generate alone and the reference's."""
    jcfg, cfg = _pair(attn=attn)
    jp, p = _params(jcfg, cfg, seed=14)
    rng = np.random.default_rng(15)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab,
                                               size=int(rng.integers(3, 15)),
                                               dtype=np.int32),
                    max_new_tokens=int(rng.integers(2, 7)))
            for i in range(4)]
    eng = ServeEngine(p, cfg, slots=2, max_seq=48, prompt_bucket=16,
                      device="cpu")
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    assert sorted(c.rid for c in done) == list(range(4))
    for c in done:
        req = reqs[c.rid]
        solo = decode.generate(p, torch.from_numpy(req.prompt)[None].long(),
                               cfg, steps=req.max_new_tokens - 1)[0].numpy()
        ref = np.asarray(jdec.generate(jp, jnp.asarray(req.prompt)[None],
                                       jcfg, steps=req.max_new_tokens - 1))[0]
        np.testing.assert_array_equal(c.tokens, solo)
        np.testing.assert_array_equal(c.tokens, ref)


def test_moe_entry_points_need_a_device(monkeypatch):
    cfg = dataclasses.replace(wl.ModelConfig.tiny(), n_experts=4)
    p = wl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wl.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(p, wl.ModelConfig.mixtral_like(), slots=1, max_seq=32,
                    prompt_bucket=8)
