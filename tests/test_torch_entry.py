"""The entry points: ``tpusched_torch.entry`` against
``__graft_entry__.py`` on the CPU.

- ``entry(device="cpu")``'s forward on jaxbridge's ``entry()`` params
  equals jaxbridge's forward (1e-5), at the reference's config;
- the dense block's mesh for n in 8, 4, 6, 2 and 3 is the reference's;
- each of the seven dryrun blocks, fed jaxbridge's own arrays (the
  reference dryrun's seeds and prompts), matches jaxbridge's computation
  on the same meshes of virtual CPU devices: the dense, MoE and pipeline
  losses to 1e-5, and the tokens of the tp-serve, tp-speculative,
  tp-int8kv and hand-off blocks exactly (the hand-off's trained weights to
  1e-5 too). One spawn of eight gloo ranks runs blocks 1-3, one of four
  the hand-off's training on {"dp": 2, "tp": 2}, one of two the serving
  blocks (``entry.run_blocks``; the ranks import no JAX);
- ``dryrun_multichip(8, backend="gloo", device="cpu")`` prints the
  reference's seven lines, in its order and with its names;
- a loss off by more than the tolerance raises the reference's
  RuntimeError."""
from __future__ import annotations

import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusched.jaxbridge import checkpoint as jckpt
from tpusched.jaxbridge import decode as jdec
from tpusched.jaxbridge import mesh as jmeshlib
from tpusched.jaxbridge import pipeline as jpipe
from tpusched.jaxbridge import serve as jserve
from tpusched.jaxbridge import workload as jwl
from tpusched_torch import checkpoint, entry, interop, mesh as tmesh
from tpusched_torch import workload as wl

torch.set_num_threads(1)

RTOL = 1e-5
N = 8
TP = {"tp": 2}
TRAIN = {"dp": 2, "tp": 2}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jtokens(seed, rows, cfg):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed),
                                         (rows, cfg.seq), 0, cfg.vocab,
                                         dtype=jnp.int32))


def _cfgs(**changes):
    return (dataclasses.replace(jwl.ModelConfig.tiny(), **changes),
            dataclasses.replace(wl.ModelConfig.tiny(), **changes))


def _prompts():
    """The reference dryrun's prompts, drawn in its order."""
    rng = np.random.default_rng(11)
    serve = [rng.integers(0, 256, 8, dtype=np.int32) for _ in range(3)]
    spec = [rng.integers(0, 256, 7, dtype=np.int32) for _ in range(3)]
    i8 = rng.integers(0, 256, (2, 12), dtype=np.int32)
    handoff = [rng.integers(0, 256, 9, dtype=np.int32) for _ in range(2)]
    return serve, spec, i8, handoff


# name -> (mesh, config changes, param seed, token seed, rows)
LOSS_BLOCKS = {
    "dense": (entry.dense_mesh_shape(N), dict(attn="ringflash"), 0, 7, 2),
    "moe": ({"dp": 2, "ep": 2, "tp": 2}, dict(n_experts=4, moe_top_k=2), 1,
            8, 2),
    "pipeline": ({"pp": 2, "dp": 4}, {}, 2, 9, 8),
}


def _loss_block(name):
    sizes, changes, pseed, tseed, rows = LOSS_BLOCKS[name]
    jcfg, cfg = _cfgs(**changes)
    jp = jwl.init_params(jax.random.PRNGKey(pseed), jcfg)
    return sizes, jcfg, jp, cfg, _np(jp), _jtokens(tseed, rows, jcfg)


def _handoff_data():
    jcfg, cfg = _cfgs()
    jp = jwl.init_params(jax.random.PRNGKey(5), jcfg)
    return jcfg, jp, cfg, _np(jp), _jtokens(6, 2, jcfg)


@pytest.fixture
def one_thread_ranks(monkeypatch):
    """Spawned ranks start torch with one intra-op thread (they inherit the
    environment), as the other tests' rank programs set it, so that eight
    ranks do not crowd the host."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def ported(tmp_path_factory):
    """Every block of the port on jaxbridge's arrays: rank 0's results of
    the 8-, 4- and 2-rank spawns, and the hand-off's trained weights."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        return _ported(tmp_path_factory)


def _ported(tmp_path_factory):
    root = tmp_path_factory.mktemp("entry")
    blocks = []
    for name in LOSS_BLOCKS:
        sizes, _, _, cfg, tree, tokens = _loss_block(name)
        fn = entry.pipeline_block if name == "pipeline" else entry.train_block
        blocks.append((name, sizes, fn, (cfg, tree, tokens), {}))
    run = functools.partial(tmesh.launch, entry.run_blocks, backend="gloo",
                            device="cpu", workdir=str(root))
    out = run(LOSS_BLOCKS["dense"][0], blocks)[0]
    _, _, cfg, tree, tokens = _handoff_data()
    trained = run(TRAIN, [("train", TRAIN, entry.handoff_train_block,
                           (cfg, tree, tokens), {})])[0]["train"]
    snapshot = str(root / "snapshot")
    checkpoint.export_for_serving(
        snapshot, interop.params_from_numpy(trained, cfg, "cpu"), cfg, step=1)
    serve_p, spec_p, i8_p, handoff_p = _prompts()
    _, cfg = _cfgs()
    _, i8_cfg = _cfgs(kv_cache_dtype="int8")
    tree = _np(jwl.init_params(jax.random.PRNGKey(3), _cfgs()[0]))
    out.update(run(TP, [
        ("tp-serve", TP, entry.serve_block, (cfg, tree, serve_p, 4),
         dict(chunk_prefill=5)),
        ("tp-speculative", TP, entry.serve_block, (cfg, tree, spec_p, 5),
         dict(self_draft=True, spec_k=3)),
        ("tp-int8kv", TP, entry.generate_block, (i8_cfg, tree, i8_p, 6), {}),
        ("handoff", TP, entry.handoff_serve_block,
         (cfg, snapshot, handoff_p, 4), {})])[0])
    out["trained"] = trained
    return out


def test_entry_forward_matches_reference_on_its_params():
    """The port's forward step at the reference's config (vocab 2048, d 256,
    2 layers, 4 heads, d_ff 512, seq 128) on jaxbridge's ``entry()``
    params and tokens gives its logits (4, 128, 2048) within 1e-5."""
    import __graft_entry__
    jfn, (jp, jtok) = __graft_entry__.entry()
    want = np.asarray(jax.jit(jfn)(jp, jtok))
    fn, (params, tokens) = entry.entry(device="cpu")
    cfg = fn.keywords["cfg"]
    assert (cfg.vocab, cfg.d_model, cfg.n_layers, cfg.n_heads, cfg.d_ff,
            cfg.seq, cfg.dtype, cfg.attn) == (2048, 256, 2, 4, 512, 128,
                                              torch.float32, "naive")
    assert tokens.shape == (4, 128) and not tokens.any()
    assert {t.device.type for t in wl.tree_leaves(params)} == {"cpu"}
    with torch.no_grad():
        got = fn(interop.params_from_numpy(_np(jp), cfg, "cpu"),
                 torch.from_numpy(np.array(jtok)).long()).numpy()
    assert got.shape == want.shape == (4, 128, 2048)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=RTOL * np.abs(want).max())
    with torch.no_grad():
        assert fn(params, tokens).shape == (4, 128, 2048)


@pytest.mark.parametrize("n", [8, 4, 6, 2, 3])
def test_dense_mesh_is_the_references(n):
    """n % 8 == 0: dp/fsdp/sp/tp; n % 4 == 0: dp/sp/tp; else the
    reference's ``build_mesh(n)`` (6: dp 3, tp 2; 3: dp 3, tp 1)."""
    if n % 8 == 0:
        want = {"dp": n // 8, "fsdp": 2, "sp": 2, "tp": 2}
    elif n % 4 == 0:
        want = {"dp": n // 4, "sp": 2, "tp": 2}
    else:
        want = dict(jmeshlib.build_mesh(n).shape)
    assert entry.dense_mesh_shape(n) == want
    if n == 6:
        assert want == {"dp": 3, "tp": 2}


def _reference_loss(name):
    """jaxbridge's sharded step's loss on the block's mesh."""
    sizes, jcfg, jp, _, _, tokens = _loss_block(name)
    mesh = jmeshlib.build_named_mesh(sizes)
    if name == "pipeline":
        step, shard, tok = jpipe.make_pipeline_train_step(mesh, jcfg,
                                                          n_micro=2)
        params = jax.device_put((jpipe.stack_layers(jp), jp["embed"],
                                 jp["out"], jp["ln_f"]), shard)
    else:
        step, shard, tok = jwl.make_sharded_train_step(mesh, jcfg)
        params = jax.device_put(jp, shard)
    return float(step(params, jax.device_put(tokens, tok))[1])


@pytest.mark.parametrize("name", list(LOSS_BLOCKS))
def test_loss_blocks_match_reference_mesh_steps(ported, name):
    """The dense (ring-flash on dp/fsdp/sp/tp), MoE (dp/ep/tp) and pipeline
    (pp/dp) blocks' losses within 1e-5 of jaxbridge's steps on the same
    meshes and arrays."""
    assert ported[name]["loss"] == pytest.approx(_reference_loss(name),
                                                 rel=RTOL)


def test_serving_blocks_match_reference(ported):
    """tp-serve, tp-speculative (and its acceptance) and tp-int8kv emit
    jaxbridge's tokens on a tp = 2 mesh of virtual CPU devices."""
    jcfg, _ = _cfgs()
    jp = jwl.init_params(jax.random.PRNGKey(3), jcfg)
    serve_p, spec_p, i8_p, _ = _prompts()
    mesh = jmeshlib.build_named_mesh(TP)

    def served(prompts, new, **kw):
        eng = jserve.ServeEngine(jp, jcfg, slots=2, max_seq=64,
                                 prompt_bucket=16, mesh=mesh, **kw)
        for rid, p in enumerate(prompts):
            eng.submit(jserve.Request(rid=rid, prompt=p, max_new_tokens=new))
        return ({c.rid: np.asarray(c.tokens).tolist()
                 for c in eng.run_until_drained()}, dict(eng.spec_stats))

    assert ported["tp-serve"]["tokens"] == served(serve_p, 4,
                                                  chunk_prefill=5)[0]
    tokens, stats = served(spec_p, 5, draft_params=jp, draft_cfg=jcfg,
                           spec_k=3)
    assert ported["tp-speculative"]["tokens"] == tokens
    assert ported["tp-speculative"]["spec_stats"] == stats
    i8 = dataclasses.replace(jcfg, kv_cache_dtype="int8")
    want = np.asarray(jdec.generate(jp, jnp.asarray(i8_p), i8, steps=6))
    assert ported["tp-int8kv"] == want.tolist()


def test_handoff_block_matches_reference(ported, tmp_path):
    """jaxbridge's train step on {"dp": 2, "tp": 2}, export, tp = 2 load and
    engine: the trained weights within 1e-5 of the port's, and the served
    tokens equal."""
    jcfg, jp, _, _, tokens = _handoff_data()
    mesh = jmeshlib.build_named_mesh(TRAIN)
    step, shard, tok = jwl.make_sharded_train_step(mesh, jcfg)
    trained, _ = step(jax.device_put(jp, shard), jax.device_put(tokens, tok))
    for got, want in zip(jax.tree.leaves(ported["trained"]),
                         jax.tree.leaves(_np(trained))):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=RTOL * np.abs(want).max())
    jckpt.export_for_serving(str(tmp_path), trained, jcfg, step=1)
    s_mesh = jmeshlib.build_named_mesh(TP)
    eng = jserve.ServeEngine(
        jckpt.load_for_serving(str(tmp_path), jcfg, mesh=s_mesh), jcfg,
        slots=2, max_seq=64, prompt_bucket=16, mesh=s_mesh)
    for rid, p in enumerate(_prompts()[3]):
        eng.submit(jserve.Request(rid=rid, prompt=p, max_new_tokens=4))
    want = {c.rid: np.asarray(c.tokens).tolist()
            for c in eng.run_until_drained()}
    assert ported["handoff"]["tokens"] == want


def test_dryrun_prints_the_reference_lines(capsys, tmp_path,
                                           one_thread_ranks):
    """``dryrun_multichip(8)`` on gloo CPU ranks: the reference's seven
    lines, in its order, each ending in OK, the meshes the reference's."""
    out = entry.dryrun_multichip(N, backend="gloo", device="cpu",
                                 workdir=str(tmp_path))
    lines = capsys.readouterr().out.strip().splitlines()
    patterns = [
        r"dense mesh=\{'dp': 1, 'fsdp': 2, 'sp': 2, 'tp': 2\} "
        r"loss=[\d.]+ \(ref [\d.]+\) OK",
        r"moe mesh=\{'dp': 2, 'ep': 2, 'tp': 2\} loss=[\d.]+ "
        r"\(ref [\d.]+\) OK",
        r"pipeline mesh=\{'pp': 2, 'dp': 4\} loss=[\d.]+ \(ref [\d.]+\) OK",
        r"tp-serve mesh=\{'tp': 2\} greedy parity over 3 requests OK",
        r"tp-speculative mesh=\{'tp': 2\} parity over 3 requests "
        r"\(accept 1\.00\) OK",
        r"tp-int8kv mesh=\{'tp': 2\} greedy parity OK",
        r"train→export→serve handoff \(train mesh=\{'dp': 2, 'tp': 2\} → "
        r"serve mesh=\{'tp': 2\}\) greedy parity OK"]
    assert len(lines) == len(patterns)
    for line, pattern in zip(lines, patterns):
        assert re.fullmatch(r"dryrun_multichip\(8\): " + pattern, line), line
    assert list(out) == ["dense", "moe", "pipeline", "tp-serve",
                         "tp-speculative", "tp-int8kv", "handoff"]
    assert [r["sp_index"] for r in out["dense"]["ranks"]] == [0, 0, 1, 1] * 2


def test_a_drifting_loss_raises_the_reference_error():
    """A loss off by more than rtol raises the reference's RuntimeError;
    one within it gives the OK line."""
    with pytest.raises(RuntimeError, match=re.escape(
            "dryrun_multichip(8) dense mesh={'tp': 2}: sharded loss "
            "5.100000 != single-device reference 5.000000 (rtol 0.002)")):
        entry.check_loss(8, "dense mesh={'tp': 2}", 5.1, 5.0, 2e-3)
    assert entry.check_loss(8, "moe", 5.004, 5.0, 1e-3).endswith(
        "moe loss=5.004000 (ref 5.000000) OK")


def test_nccl_needs_a_card_a_rank(monkeypatch):
    """``backend="nccl"`` with fewer cards than ranks raises before any
    rank starts, naming gloo; there is no silent switch."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="backend='gloo'"):
        entry.dryrun_multichip(2, device="cpu")
    with pytest.raises(ValueError, match="'nccl' or 'gloo'"):
        entry.dryrun_multichip(2, backend="mpi", device="cpu")
