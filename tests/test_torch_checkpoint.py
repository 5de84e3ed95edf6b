"""tpusched_torch.checkpoint against tpusched.jaxbridge.checkpoint on the CPU,
case for case with ``tests/test_checkpoint.py``: a state saved on one mesh
and restored onto another continues as jaxbridge's orbax save → restore →
continue does on a virtual CPU mesh, within 1e-5 (dense {"dp": 4, "tp": 2}
→ {"fsdp": 2, "sp": 2, "tp": 2}; MoE {"dp": 2, "ep": 2, "tp": 2} → {"dp":
1, "ep": 4, "tp": 2}; AdamW state with the params, within 1e-6 of the
uninterrupted run); the serving snapshot loads whole as the compute cast
and as tensor-parallel shards that an engine serves as it serves the whole
tree; half-written step directories are skipped. The port runs on eight
(and two) gloo ranks through ``torch_ranks``; the ranks import no JAX."""
from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_ranks
from tpusched.jaxbridge import checkpoint as jck
from tpusched.jaxbridge import workload as jwl
from tpusched.jaxbridge.decode import generate as jgenerate
from tpusched.jaxbridge.mesh import build_named_mesh as jmesh
from tpusched_torch import checkpoint, mesh as tmesh, workload as wl

torch.set_num_threads(1)

TOL = 1e-5
# name -> (mesh a, mesh b, kind, experts, token seed), as tests/test_checkpoint.py
CASES = {
    "dense": ({"dp": 4, "tp": 2}, {"fsdp": 2, "sp": 2, "tp": 2}, "sgd", 0, 1),
    "moe": ({"dp": 2, "ep": 2, "tp": 2}, {"dp": 1, "ep": 4, "tp": 2}, "sgd",
            4, 1),
    "adamw": ({"dp": 4, "tp": 2}, {"dp": 4, "tp": 2}, "adamw", 0, 2),
}


def _cfgs(n_experts):
    return (dataclasses.replace(jwl.ModelConfig.tiny(), n_experts=n_experts),
            dataclasses.replace(wl.ModelConfig.tiny(), n_experts=n_experts))


def _tokens(cfg, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (4, cfg.seq),
                                                dtype=np.int32)


def _jax_flow(name, directory):
    """jaxbridge's save → restore → continue: (uninterrupted loss, resumed
    loss, resumed ``out``)."""
    mesh_a, mesh_b, kind, experts, seed = CASES[name]
    jcfg, _ = _cfgs(experts)
    tokens = _tokens(jcfg, seed)
    params = jwl.init_params(jax.random.PRNGKey(0), jcfg)
    ma = jmesh(mesh_a)
    if kind == "sgd":
        step_a, pshard_a, tshard_a = jwl.make_sharded_train_step(ma, jcfg)
        params = jax.device_put(params, pshard_a)
        toks = jax.device_put(tokens, tshard_a)
        for _ in range(2):
            params, _ = step_a(params, toks)
        jck.save(directory, params, step=2)
        base = params
        for _ in range(2):
            base, base_loss = step_a(base, toks)
        step_b, pshard_b, tshard_b = jwl.make_sharded_train_step(
            jmesh(mesh_b), jcfg)
        restored, _ = jck.restore(directory, jck.abstract_state(
            jax.eval_shape(lambda: jwl.init_params(jax.random.PRNGKey(0),
                                                   jcfg)), pshard_b))
        toks = jax.device_put(tokens, tshard_b)
        for _ in range(2):
            restored, loss = step_b(restored, toks)
        return float(base_loss), float(loss), np.asarray(restored["out"])
    step, init_opt, pshard, tshard = jwl.make_optax_train_step(
        ma, jcfg, optax.adamw(1e-3))
    params = jax.device_put(params, pshard)
    opt = init_opt(params)
    toks = jax.device_put(tokens, tshard)
    for _ in range(2):
        params, opt, _ = step(params, opt, toks)
    jck.save(directory, {"params": params, "opt": opt}, step=2)
    base_p, base_o = params, opt
    for _ in range(2):
        base_p, base_o, base_loss = step(base_p, base_o, toks)
    shardings = {"params": pshard,
                 "opt": jax.tree_util.tree_map(lambda x: x.sharding, opt)}
    restored, _ = jck.restore(directory, jck.abstract_state(
        jax.eval_shape(lambda: {"params": params, "opt": opt}), shardings))
    r_p, r_o = restored["params"], restored["opt"]
    for _ in range(2):
        r_p, r_o, loss = step(r_p, r_o, toks)
    return float(base_loss), float(loss), np.asarray(r_p["out"])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's cases in one spawn of eight ranks, and jaxbridge's."""
    root = tmp_path_factory.mktemp("ckpt")
    cases = {}
    for name, (mesh_a, mesh_b, kind, experts, seed) in CASES.items():
        jcfg, cfg = _cfgs(experts)
        tree = jax.tree.map(np.asarray,
                            jwl.init_params(jax.random.PRNGKey(0), jcfg))
        cases[name] = (mesh_a, mesh_b, kind, cfg, tree, _tokens(cfg, seed))
    port = tmesh.launch(torch_ranks.checkpoint_rank, {"dp": 4, "tp": 2},
                        str(root / "port"), cases, backend="gloo",
                        device="cpu", workdir=str(root))
    ref = {name: _jax_flow(name, str(root / "jax" / name)) for name in CASES}
    return port, ref


@pytest.mark.parametrize("name", list(CASES))
def test_resume_on_new_mesh_matches_reference(runs, name):
    """Every rank's uninterrupted and resumed losses and the resumed
    ``out`` within 1e-5 of jaxbridge's; the restored step is 2."""
    port, ref = runs
    base, loss, out = ref[name]
    for r in port:
        got = r[name]
        assert got["step"] == 2
        np.testing.assert_allclose(got["base_loss"], base, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(got["loss"], loss, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["out"], out, rtol=TOL, atol=TOL)


def test_restored_shards_take_the_new_mesh(runs):
    """Dense: wq (d, d) column-parallel over fsdp 2 × tp 2 on mesh b; MoE:
    one expert a rank after ep 2 → 4."""
    port, _ = runs
    d, f = wl.ModelConfig.tiny().d_model, wl.ModelConfig.tiny().d_ff
    for r in port:
        assert r["dense"]["shapes"]["wq"] == (d // 2, d // 2)
        assert r["moe"]["shapes"]["w_gate"] == (1, d, f // 2)


def test_adamw_state_resumes_exactly(runs):
    """The AdamW continuation within 1e-6 of the uninterrupted run on the
    same mesh, and the restored count 2."""
    port, _ = runs
    for r in port:
        got = r["adamw"]
        assert got["count"] == 2
        np.testing.assert_allclose(got["loss"], got["base_loss"], rtol=1e-6,
                                   atol=1e-6)


SERVE_CFGS = {  # name -> (dtype, param_dtype)
    "bf16": (torch.bfloat16, torch.float32),
    "f32": (torch.float32, None),
}


def _serve_cfgs(name):
    dtype, pdtype = SERVE_CFGS[name]
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32,
           None: None}
    return (dataclasses.replace(jwl.ModelConfig.tiny(), dtype=jdt[dtype],
                                param_dtype=jdt[pdtype]),
            dataclasses.replace(wl.ModelConfig.tiny(), dtype=dtype,
                                param_dtype=pdtype))


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """Each config's export (step 7) from jaxbridge's initial weights, the
    reference's params, and the tp = 2 spawn's loads and engines."""
    root = tmp_path_factory.mktemp("serving")
    prompt = np.random.default_rng(1).integers(0, 256, 8, dtype=np.int32)
    made, cases = {}, {}
    for name in SERVE_CFGS:
        jcfg, cfg = _serve_cfgs(name)
        jp = jwl.init_params(jax.random.PRNGKey(0), jcfg)
        from tpusched_torch import interop
        params = interop.params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                           "cpu")
        path = checkpoint.export_for_serving(str(root / name), params, cfg,
                                             step=7)
        made[name] = (jcfg, cfg, jp, params, path)
        cases[name] = (cfg, prompt, 6)
    ranks = tmesh.launch(torch_ranks.serving_snapshot_rank, {"tp": 2},
                         str(root), cases, backend="gloo", device="cpu",
                         workdir=str(root))
    return root, prompt, made, ranks


@pytest.mark.parametrize("name", list(SERVE_CFGS))
def test_replicated_serving_load_is_the_compute_cast(snapshots, name):
    """The whole load equals ``cast_params_for_compute`` exactly (and
    jaxbridge's cast), in the compute dtype; the path names the step."""
    root, _, made, _ = snapshots
    jcfg, cfg, jp, params, path = made[name]
    assert os.path.basename(path) == "serving_00000007"
    assert checkpoint.latest_serving_step(str(root / name)) == 7
    loaded = checkpoint.load_for_serving(str(root / name), cfg, device="cpu")
    want = wl.cast_params_for_compute(params, cfg)
    ref = jax.tree.map(lambda a: np.asarray(a, np.float32),
                       jwl.cast_params_for_compute(jp, jcfg))
    got = wl.tree_leaves(loaded)
    assert len(got) == len(wl.tree_leaves(want))
    for a, b in zip(got, wl.tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    wl.tree_map(lambda a, r: np.testing.assert_array_equal(a.float().numpy(),
                                                           r), loaded, ref)
    assert loaded["layers"][0]["wq"].dtype == cfg.dtype


@pytest.mark.parametrize("name", list(SERVE_CFGS))
def test_sharded_serving_load_serves_as_the_whole_tree(snapshots, name):
    """On {"tp": 2} every leaf comes back at its shard's shape in the
    compute dtype, and the engine given the shards serves the tokens of
    the engine given the whole tree; the ranks agree."""
    _, _, made, ranks = snapshots
    _, cfg, *_ = made[name]
    layout = tmesh.Mesh({"tp": 2})
    want = []
    wl.tree_map(lambda t, spec: want.append(wl.shard_shape(t.shape, spec,
                                                          layout)),
                made[name][3], wl.param_specs(cfg, layout))
    for r in ranks:
        got = r[name]
        assert got["shapes"] == want
        assert got["dtypes"] == [str(cfg.dtype)]
        assert got["tokens"]["shards"] == got["tokens"]["whole"]
        assert got["tokens"] == ranks[0][name]["tokens"]


def test_sharded_serving_load_generates_as_reference(snapshots):
    """f32: the tp = 2 engine on the loaded shards gives jaxbridge's greedy
    ``generate`` tokens on the original params."""
    _, prompt, made, ranks = snapshots
    jcfg, _, jp, _, _ = made["f32"]
    ref = np.asarray(jgenerate(jp, jnp.asarray(prompt)[None], jcfg,
                               steps=5))[0].tolist()
    assert ranks[0]["f32"]["tokens"]["shards"] == ref


def test_latest_step_empty_and_missing_dir(tmp_path):
    for d in (tmp_path, tmp_path / "missing"):
        assert checkpoint.latest_step(str(d)) is None
        assert checkpoint.latest_serving_step(str(d)) is None
        assert jck.latest_step(str(d)) is None
    cfg = wl.ModelConfig.tiny()
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path), checkpoint.abstract_state(
            checkpoint.param_skeleton(cfg)), device="cpu")
    with pytest.raises(FileNotFoundError):
        checkpoint.load_for_serving(str(tmp_path), cfg, device="cpu")


def test_latest_step_skips_temporary_dirs(tmp_path):
    """A crashed save leaves a temporary directory (the port's ``.tmp-``,
    orbax's ``.orbax-checkpoint-tmp-``) beside good snapshots: the last
    good one is the latest, as jaxbridge reads the same directory."""
    for name in ("step_00000003", "step_00000007.orbax-checkpoint-tmp-12345",
                 "step_00000009.tmp-0123abcd", "serving_00000002",
                 "serving_00000009.orbax-checkpoint-tmp-6",
                 "serving_00000011.tmp-feed"):
        os.makedirs(tmp_path / name)
    assert checkpoint.latest_step(str(tmp_path)) == 3 \
        == jck.latest_step(str(tmp_path))
    assert checkpoint.latest_serving_step(str(tmp_path)) == 2 \
        == jck.latest_serving_step(str(tmp_path))


def test_restore_skips_a_half_written_save(tmp_path):
    """One process, no mesh: after a good save of step 3, a half-written
    step 5 (a temporary directory with a torn file) is skipped and step 3
    restores, whole, with its AdamW state."""
    from tpusched_torch import optim
    cfg = wl.ModelConfig.tiny()
    params = wl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tx = optim.adamw(1e-3)
    state = tx.init(params)
    state.count = 3
    checkpoint.save(str(tmp_path), params, 3, extra=state)
    torn = tmp_path / "step_00000005.tmp-deadbeef"
    os.makedirs(torn)
    (torn / "__0_0.distcp").write_bytes(b"torn")
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000005.tmp-deadbeef"]
    got, step, extra = checkpoint.restore(
        str(tmp_path), checkpoint.abstract_state(
            checkpoint.param_skeleton(cfg)), device="cpu",
        abstract_extra=checkpoint.abstract_like(tx.init(params)))
    assert step == 3 and extra.count == 3
    for a, b in zip(wl.tree_leaves(got) + wl.tree_leaves(extra.mu),
                    wl.tree_leaves(params) + wl.tree_leaves(state.mu)):
        assert torch.equal(a, b)
