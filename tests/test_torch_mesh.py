"""tpusched_torch.mesh and the port's shardings against
tpusched.jaxbridge.mesh and jaxbridge.workload.param_specs: factor_mesh,
param_specs leaf for leaf on dense, MoE and vocab-parallel configs over
several meshes, shard_params then a gather, slice_assignment on pods made
with tpusched.testing, the axis groups and collectives of a four-rank gloo
mesh, the ring hop of sp and the gather of fsdp with their backwards (one
spawn; the ranks import no JAX) and the refusals: nccl with more ranks than
cards, the ep and pp axes, and serving over fsdp or sp."""
from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_ranks
from tpusched.jaxbridge import mesh as jmeshlib
from tpusched.jaxbridge import workload as jwl
from tpusched_torch import mesh as tmesh, optim, workload as wl
from tpusched_torch.serve import ServeEngine

torch.set_num_threads(1)


@pytest.mark.parametrize("n", range(1, 17))
def test_factor_mesh_matches_reference(n):
    assert tmesh.factor_mesh(n) == jmeshlib.factor_mesh(n)
    assert tmesh.factor_mesh(n, max_tp=2) == jmeshlib.factor_mesh(n, max_tp=2)


MESHES = [{"tp": 2}, {"dp": 2, "tp": 2}, {"dp": 8}, {"tp": 4},
          {"slice": 2, "dp": 2, "tp": 2}, {"dp": 2, "fsdp": 2, "tp": 2},
          {"dp": 2, "ep": 2, "tp": 2}, {"fsdp": 2, "sp": 2, "tp": 2}]
CONFIGS = {"dense": {}, "moe": dict(n_experts=4),
           "vocab_parallel": dict(vocab_parallel_loss=True),
           "moe_vocab_parallel": dict(n_experts=4, vocab_parallel_loss=True)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k, x in tree.items()
                for p, v in _flat(x, f"{prefix}/{k}").items()}
    if isinstance(tree, list):
        return {p: v for i, x in enumerate(tree)
                for p, v in _flat(x, f"{prefix}/{i}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(
    f"{k}{v}" for k, v in s.items()))
@pytest.mark.parametrize("kind", list(CONFIGS))
def test_param_specs_match_reference_leaf_for_leaf(kind, sizes):
    jcfg = dataclasses.replace(jwl.ModelConfig.tiny(), **CONFIGS[kind])
    cfg = dataclasses.replace(wl.ModelConfig.tiny(), **CONFIGS[kind])
    ref = jwl.param_specs(jcfg, jmeshlib.build_named_mesh(sizes))
    ref = jax.tree_util.tree_map(tuple, ref, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    got = wl.param_specs(cfg, tmesh.Mesh(sizes))
    assert _flat(got) == {k: tuple(v) for k, v in _flat(ref).items()}


@pytest.mark.parametrize("sizes", [{"tp": 2}, {"dp": 2, "tp": 2}, {"tp": 4},
                                   {"slice": 2, "dp": 2, "tp": 2}],
                         ids=lambda s: "x".join(f"{k}{v}"
                                                for k, v in s.items()))
@pytest.mark.parametrize("kind", list(CONFIGS))
def test_shards_join_back_to_the_tree(kind, sizes):
    """Every rank's shard_params, joined along each leaf's sharded dims in
    index order, is the tree; a dim is cut only over tp."""
    cfg = dataclasses.replace(wl.ModelConfig.tiny(), n_heads=4, n_kv_heads=4,
                              **CONFIGS[kind])
    params = wl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    n = int(np.prod(list(sizes.values())))
    shards = [wl.shard_params(params, cfg, tmesh.Mesh(sizes, rank=r))
              for r in range(n)]
    specs = _flat(wl.param_specs(cfg, tmesh.Mesh(sizes)))
    full = _flat(params)
    tp = sizes.get("tp", 1)
    for path, leaf in full.items():
        spec = specs[path]
        parts = [_flat(s)[path] for s in shards]
        dim = spec.index("tp") if "tp" in spec else None
        if dim is None:
            assert all(torch.equal(p, leaf) for p in parts), path
            continue
        by_tp = [parts[r] for r in range(tp)]   # tp varies fastest
        assert torch.equal(torch.cat(by_tp, dim=dim), leaf), path
        assert all(p.is_contiguous() for p in parts)


def test_slice_assignment_matches_reference():
    from tpusched.plugins.topologymatch import COORD_ANNOTATION
    from tpusched.testing import make_pod
    assert tmesh.COORD_ANNOTATION == COORD_ANNOTATION
    pods = [make_pod(f"p{i}", node_name=f"n{i}",
                     annotations={COORD_ANNOTATION: f"{i * 2}-{i % 2}-0"})
            for i in (3, 1, 0, 2)]
    pods.append(make_pod("unbound", annotations={COORD_ANNOTATION: "9-9-9"}))
    pods.append(make_pod("no-coord", node_name="n9"))
    got = tmesh.slice_assignment(pods)
    assert got == jmeshlib.slice_assignment(pods)
    assert [c for c, _ in got] == [(0, 0, 0), (2, 1, 0), (4, 0, 0),
                                   (6, 1, 0)]


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    cfg = dataclasses.replace(wl.ModelConfig.tiny(), n_experts=2)
    jp = jwl.init_params(jax.random.PRNGKey(3), dataclasses.replace(
        jwl.ModelConfig.tiny(), n_experts=2))
    tree = jax.tree.map(np.asarray, jp)
    out = tmesh.launch(torch_ranks.mesh_rank, {"dp": 2, "tp": 2}, cfg, tree,
                       backend="gloo", device="cpu",
                       workdir=str(tmp_path_factory.mktemp("ranks")))
    return tree, out


def test_axis_groups_of_a_four_rank_mesh(four_ranks):
    """Ranks lie row-major (tp fastest); each axis's group holds the ranks
    that share the other coordinate, and sum, max, gather and broadcast run
    over it."""
    _, ranks = four_ranks
    grid = np.arange(4).reshape(2, 2)          # (dp, tp)
    for r, out in enumerate(ranks):
        d, t = divmod(r, 2)
        assert out["rank"] == r and out["coord"] == {"dp": d, "tp": t}
        for name, members in (("dp", grid[:, t]), ("tp", grid[d, :]),
                              ("batch", grid[:, t])):
            got = out[name]
            assert list(got["ranks"]) == members.tolist()
            assert got["index"] == (d if name != "tp" else t)
            assert got["sum"] == [float(members.sum())]
            assert got["max"] == [float(members.max())]
            assert got["gather"] == members.astype(float).tolist()
            assert got["bcast"] == [float(members[1]) + 10]


def test_shard_then_gather_returns_the_tree(four_ranks):
    tree, ranks = four_ranks
    for out in ranks:
        assert out["shard_shapes"] == {"embed": (256, 32), "out": (32, 256)}
        got, want = _flat(out["gathered"]), _flat(tree)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_ring_shift_and_its_backward(four_ranks):
    """On {"sp": 4}, ring_shift hands each rank's tensor to index + 1 and
    its gradient comes back from there (the receiver's weight 1 + its
    rank); shift by −1 goes the other way."""
    _, ranks = four_ranks
    for r, out in enumerate(ranks):
        got = out["sp_fsdp"]
        np.testing.assert_array_equal(got["shifted"],
                                      np.full((2, 3), (r - 1) % 4))
        np.testing.assert_array_equal(got["shift_grad"],
                                      np.full((2, 3), 1 + (r + 1) % 4))
        assert got["back"] == (r + 1) % 4


def test_gather_and_its_reduce_scatter_backward(four_ranks):
    """On {"fsdp": 2, "sp": 2} (sp fastest), each fsdp group is the two
    ranks of one sp index: gather joins their chunks along dim 0, and the
    backward sums both ranks' gradients of the whole (weights 1 + rank)
    and keeps this rank's chunk. The data axes (batch and sp) hold all four
    ranks, the same without fsdp the sp pair."""
    _, ranks = four_ranks
    for r, out in enumerate(ranks):
        got = out["sp_fsdp"]
        f, s = divmod(r, 2)
        assert got["coord"] == {"fsdp": f, "sp": s}
        assert list(got["fsdp_ranks"]) == [s, 2 + s]
        assert list(got["batch_ranks"]) == [s, 2 + s]
        assert list(got["sp_ranks"]) == [2 * f, 2 * f + 1]
        assert list(got["data_ranks"]) == [0, 1, 2, 3]
        assert got["sums"] == [10.0, float(2 * (2 * f + 1) + 1)]
        chunk = np.arange(6.0).reshape(2, 3)
        np.testing.assert_array_equal(got["gathered"], np.concatenate(
            [chunk + 10 * s, chunk + 10 * (2 + s)]))
        np.testing.assert_array_equal(got["gather_grad"],
                                      np.full((2, 3), 4.0 + 2 * s))


def test_nccl_with_more_ranks_than_cards_is_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="backend='gloo'"):
        tmesh.build_named_mesh({"tp": 2})
    with pytest.raises(ValueError, match="backend='gloo'"):
        tmesh.build_mesh(4, backend="nccl")


@pytest.mark.parametrize("axis", ["fsdp", "sp", "ep", "pp"])
def test_unported_axes_are_refused(axis):
    """shard_params and every train step refuse a pp axis, naming the
    pipeline's step (pp trains through
    ``pipeline.make_pipeline_train_step``, tests/test_torch_pipeline.py)
    and ROADMAP; the engine takes a pp axis as replicas. fsdp, sp and ep of
    size 2 train (tests/test_torch_fsdp_sp_train.py, tests/test_torch_ep.py)
    and serve (tests/test_torch_serve_mesh.py, tests/test_torch_ep.py):
    every call builds."""
    cfg = wl.ModelConfig.tiny()
    p = wl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")

    def calls(mesh):
        return [lambda: wl.shard_params(p, cfg, mesh),
                lambda: wl.make_sharded_train_step(mesh, cfg),
                lambda: wl.make_optax_train_step(mesh, cfg,
                                                 optim.adamw(1e-3)),
                lambda: wl.make_accum_train_step(mesh, cfg,
                                                 optim.adamw(1e-3), 2),
                lambda: ServeEngine(p, cfg, mesh=mesh, slots=1, max_seq=32,
                                    prompt_bucket=8)]
    *train, serve = calls(tmesh.Mesh({axis: 2, "tp": 1}, device="cpu"))
    if axis == "pp":
        for call in train:
            with pytest.raises(NotImplementedError, match=(
                    "'pp'.*make_pipeline_train_step.*ROADMAP")):
                call()
    else:
        for call in train:
            call()
    serve()


def test_layout_mesh_refuses_collectives():
    """A mesh built without process groups has layout only: a collective
    over one of its axes of size > 1 raises, one of size 1 is the
    identity."""
    m = tmesh.Mesh({"dp": 1, "tp": 2}, rank=1)
    x = torch.ones(3)
    assert m.coord == {"dp": 0, "tp": 1} and m.tp.ranks == (0, 1)
    assert tmesh.all_reduce(x, m.axis("dp")) is x
    with pytest.raises(RuntimeError, match="build_named_mesh"):
        tmesh.all_reduce(x, m.tp)
