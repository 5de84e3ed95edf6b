"""tpusched_torch.workload and .interop against tpusched.jaxbridge.workload
on the CPU: the JAX parameters come across through interop, and the same
numpy inputs go through both forwards."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusched.jaxbridge import workload as jwl
from tpusched_torch import interop, workload as wl

torch.set_num_threads(1)


def _pair(**changes):
    """(reference cfg, port cfg) with the same changes applied to tiny()."""
    jchanges = {k: (jnp.bfloat16 if v is torch.bfloat16 else v)
                for k, v in changes.items()}
    return (dataclasses.replace(jwl.ModelConfig.tiny(), **jchanges),
            dataclasses.replace(wl.ModelConfig.tiny(), **changes))


def _params(jcfg, cfg, seed=0):
    jp = jwl.init_params(jax.random.PRNGKey(seed), jcfg)
    return jp, interop.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                         "cpu")


def test_config_validation_matches_reference():
    for kwargs, exc in ((dict(n_heads=4, n_kv_heads=3), ValueError),
                        (dict(d_model=66, n_heads=4), ValueError),
                        (dict(kv_cache_dtype="int4"), ValueError)):
        with pytest.raises(exc):
            jwl.ModelConfig(**kwargs)
        with pytest.raises(exc):
            wl.ModelConfig(**kwargs)
    with pytest.raises(ValueError, match="'int8'"):
        wl.ModelConfig(kv_cache_dtype=torch.int8)


@pytest.mark.parametrize("preset", ["tiny", "llama_like", "llama_like_big",
                                    "llama_like_xl", "mixtral_like"])
def test_presets_match_reference(preset):
    ref, got = getattr(jwl.ModelConfig, preset)(), \
        getattr(wl.ModelConfig, preset)()
    for f in dataclasses.fields(ref):
        a, b = getattr(ref, f.name), getattr(got, f.name)
        if f.name in ("dtype", "param_dtype") and a is not None:
            assert str(b).split(".")[-1] == np.dtype(a).name, f.name
        else:
            assert a == b, f.name
    assert got.kv_heads == ref.kv_heads
    assert got.head_dim == ref.d_model // ref.n_heads


@pytest.mark.parametrize("n_experts", [0, 4], ids=["dense", "moe"])
def test_init_params_shapes_dtypes_and_scale(n_experts):
    jcfg, cfg = _pair(n_kv_heads=1, n_experts=n_experts,
                      dtype=torch.bfloat16)
    jp = jwl.init_params(jax.random.PRNGKey(0), jcfg)
    p = wl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jshapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert jax.tree.map(lambda t: tuple(t.shape), p) == jshapes
    assert p["layers"][0].keys() == jp["layers"][0].keys()
    # the MoE router is f32 whatever the master dtype, as in the reference
    jdtypes = jax.tree.map(lambda a: np.dtype(a.dtype).name, jp)
    assert jax.tree.map(lambda t: str(t.dtype).split(".")[-1], p) == jdtypes
    assert torch.equal(p["ln_f"], torch.ones(cfg.d_model, dtype=cfg.dtype))
    # normal / sqrt(fan_in), as the reference: embed (256, 64) has std 1/16,
    # wq (64, 64) 1/8; each expert of a stack by its own fan-in, w_gate
    # (E, 64, 128) 1/8 and w_down (E, 128, 64) 1/sqrt(128); the router
    # (64, E) 1/8
    want = [("embed", 1 / 16), ("layers/0/wq", 1 / 8)]
    if n_experts:
        want += [("layers/0/w_gate", 1 / 8), ("layers/1/w_down", 128**-0.5),
                 ("layers/0/router", 1 / 8)]
    for path, std in want:
        t, a = p, jp
        for key in path.split("/"):
            t, a = (t[int(key)], a[int(key)]) if key.isdigit() else \
                (t[key], a[key])
        stds = [float(t.float().std())] + ([float(x.float().std())
                                             for x in t] if t.ndim == 3
                                            else [])
        assert all(abs(s - std) < 0.1 * std for s in stds), path
        assert abs(float(jnp.std(a.astype(jnp.float32))) - std) < 0.1 * std
    again = wl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(p["layers"][1]["wq"], again["layers"][1]["wq"])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 2e-2)])
def test_rmsnorm_matches_reference(dtype, tol):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    w = rng.standard_normal(64).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(jwl._rmsnorm(jnp.asarray(x, jdt), jnp.asarray(w, jdt))
                     .astype(jnp.float32))
    got = wl._rmsnorm(torch.from_numpy(x).to(dtype),
                      torch.from_numpy(w).to(dtype)).float().numpy()
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("pos", [0, 7, np.array([0, 3, 11], np.int32)],
                         ids=["zero", "scalar", "per-row"])
def test_rotary_matches_reference(pos):
    x = np.random.default_rng(2).standard_normal((3, 6, 2, 32)).astype(
        np.float32)
    ref = np.asarray(jwl._rotary(jnp.asarray(x), jnp.asarray(pos)))
    got = wl._rotary(torch.from_numpy(x), torch.as_tensor(pos)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("attn", ["naive", "flash"])
@pytest.mark.parametrize("n_kv_heads", [0, 1], ids=["mha", "gqa"])
def test_forward_matches_reference(attn, n_kv_heads):
    jcfg, cfg = _pair(attn=attn, n_kv_heads=n_kv_heads)
    jp, p = _params(jcfg, cfg)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 32),
                                             dtype=np.int32)
    ref = np.asarray(jwl.forward(jp, jnp.asarray(toks), jcfg))
    got = wl.forward(p, torch.from_numpy(toks).long(), cfg).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("attn", ["naive", "flash"])
def test_forward_bf16_matches_reference(attn):
    jcfg, cfg = _pair(attn=attn, n_kv_heads=1, dtype=torch.bfloat16)
    jp, p = _params(jcfg, cfg, seed=1)
    assert p["embed"].dtype == torch.bfloat16
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (2, 16),
                                             dtype=np.int32)
    ref = np.asarray(jwl.forward(jp, jnp.asarray(toks), jcfg)
                     .astype(jnp.float32))
    got = wl.forward(p, torch.from_numpy(toks).long(), cfg).float().numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=2e-2 * np.abs(ref).max())


def test_interop_copies_readonly_bf16_arrays():
    jcfg, cfg = _pair(dtype=torch.bfloat16)
    jp = jwl.init_params(jax.random.PRNGKey(2), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    assert tree["embed"].dtype.name == "bfloat16"
    assert not tree["embed"].flags.writeable
    p = interop.params_from_numpy(tree, cfg, "cpu")
    for a, t in zip(jax.tree.leaves(tree), jax.tree.leaves(p)):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(),
                                      a.astype(np.float32))
    p["embed"].zero_()                      # a copy: the source is untouched
    assert np.asarray(jp["embed"]).astype(np.float32).any()


def test_interop_checks_shapes_and_dtypes():
    jcfg, cfg = _pair()
    tree = jax.tree.map(np.asarray,
                        jwl.init_params(jax.random.PRNGKey(0), jcfg))
    with pytest.raises(ValueError, match="dtype"):
        interop.params_from_numpy(
            tree, dataclasses.replace(cfg, dtype=torch.bfloat16), "cpu")
    with pytest.raises(ValueError, match=r"layers\[0\]\.wk: shape"):
        interop.params_from_numpy(
            tree, dataclasses.replace(cfg, n_kv_heads=1), "cpu")
    with pytest.raises(ValueError, match="layers"):
        interop.params_from_numpy(
            tree, dataclasses.replace(cfg, n_layers=3), "cpu")


def test_cast_params_for_compute():
    cfg = wl.ModelConfig(vocab=64, d_model=32, n_heads=2, d_ff=64,
                         n_layers=1, dtype=torch.bfloat16,
                         param_dtype=torch.float32)
    p = wl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert p["out"].dtype == torch.float32
    cast = wl.cast_params_for_compute(p, cfg)
    assert all(t.dtype == torch.bfloat16 for t in jax.tree.leaves(cast))
    same = dataclasses.replace(cfg, param_dtype=None)
    assert wl.cast_params_for_compute(p, same) is p


def test_module_owns_the_params():
    cfg = wl.ModelConfig.tiny()
    p = wl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    model = wl.DecoderLM(cfg, p)
    sd = model.state_dict()
    assert "embed" in sd and "layers.1.wq" in sd
    assert not any(t.requires_grad for t in model.parameters())
    toks = torch.arange(8)[None]
    torch.testing.assert_close(model(toks), wl.forward(p, toks, cfg))
    half = model.to(torch.bfloat16)
    assert half.params["layers"][0]["w_up"].dtype == torch.bfloat16


def test_entry_points_need_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wl.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wl.init_params(wl.ModelConfig.tiny(), torch.Generator())
    assert wl.resolve_device("cpu") == torch.device("cpu")
