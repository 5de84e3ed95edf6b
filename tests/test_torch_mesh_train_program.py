"""The mesh train steps and the GPipe step as chains of CUDA graphs broken
at each collective (``program.Program`` over a mesh), on the CPU.

Two spawns of gloo ranks (``torch_ranks.mesh_train_program_rank``), two
ranks for {"tp": 2}, {"dp": 2} and {"pp": 2}, four for {"fsdp": 2, "sp":
2} and {"dp": 2, "ep": 2}, take three steps of tiny f32 each way from the
same shards:

- through the steps as they run here (their bodies): the losses equal
  jaxbridge's single-program steps on the same weights and batches within
  1e-5 relative (the meshes' parity is the existing tests': these hold
  that the programs did not move it);
- the collectives one body call makes are pinned kind by kind in body
  order: the forward's, the backward's (reached from autograd) and the
  remat recompute's, the ring-flash hops (``shift``) and the GPipe
  hand-offs (``send``, ``recv``, a send's ``wait``) in the order the
  schedule posts them;
- each step's programs built graphed (a recorder stands in for CUDA
  through ``program._cuda``, as in ``test_torch_mesh_program.py``):
  breaks of exactly those kinds, ``segments == warmup_collectives + 1``,
  every segment begun in CUDA's relaxed mode (a cut in a backward ends a
  segment on autograd's thread on the card), and every later call replays
  the segments in order with the breaks run between them.

No JAX runs in the ranks."""
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
from tpusched_torch import mesh as tmesh
from tpusched_torch import workload as wl

torch.set_num_threads(1)

RTOL = 1e-5
LR = 1e-2                    # the SGD and GPipe steps' (torch_ranks)
ADAMW_LR = 1e-3
STEPS = 3
N_MICRO = 2                  # the GPipe step's microbatches; the stacks'
TINY = wl.ModelConfig.tiny()

# name -> (ranks' mesh, step kind, config changes, rows a batch, stack)
CASES = {
    "tp_sgd": ({"tp": 2}, "sgd", dict(attn="flash", remat=True), 2, None),
    "dp_accum": ({"dp": 2}, "accum", dict(attn="flash", remat=True), 2,
                 N_MICRO),
    "pp_gpipe": ({"pp": 2}, "pipeline", dict(n_layers=4), 4, None),
    "fsdp_sp_adamw": ({"fsdp": 2, "sp": 2}, "adamw",
                      dict(attn="ringflash", remat=True), 2, None),
    "dp_ep_sgd": ({"dp": 2, "ep": 2}, "sgd", dict(n_experts=4), 2, None),
}
TWO = ["tp_sgd", "dp_accum", "pp_gpipe"]
FOUR = ["fsdp_sp_adamw", "dp_ep_sgd"]


def _cfgs(name):
    changes = CASES[name][2]
    return (dataclasses.replace(jwl.ModelConfig.tiny(), **changes),
            dataclasses.replace(TINY, **changes))


def _batches(name):
    _, _, _, rows, stack = CASES[name]
    shape = (rows, TINY.seq) if stack is None else (stack, rows, TINY.seq)
    rng = np.random.default_rng(60 + list(CASES).index(name))
    return [rng.integers(0, TINY.vocab, shape, dtype=np.int32)
            for _ in range(STEPS)]


def _tree(name):
    jcfg, _ = _cfgs(name)
    seed = list(CASES).index(name)
    return jax.tree.map(np.asarray,
                        jwl.init_params(jax.random.PRNGKey(seed), jcfg))


def _launch(names, sizes, tmp_path_factory):
    cases = {}
    for name in names:
        mesh, kind, _, _, _ = CASES[name]
        cases[name] = (mesh, kind, _cfgs(name)[1], _tree(name),
                       _batches(name))
    return tmesh.launch(torch_ranks.mesh_train_program_rank, sizes, cases,
                        backend="gloo", device="cpu",
                        workdir=str(tmp_path_factory.mktemp("ranks")))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    two = _launch(TWO, {"tp": 2}, tmp_path_factory)
    four = _launch(FOUR, {"fsdp": 2, "sp": 2}, tmp_path_factory)
    return {name: [r[name] for r in (two if name in TWO else four)]
            for name in CASES}


L = TINY.n_layers


def _pinned(name, index) -> dict:
    """The kinds of the collectives one body call of each of the case's
    programs makes, in order, on the rank at ``index`` (its coordinates)."""
    ag, ar = "all_gather", "all_reduce"
    if name == "tp_sgd":
        # forward: the embedding's gather, each layer's two row-parallel
        # sums, the unembedding's; backward: the unembedding's scatter's
        # gather, then each layer's recompute (stopped after its attention
        # sum, the last output the backward reads) and its two
        # column-parallel gradient sums
        return {"step": [ag] + [ar] * (2 * L + 1) + [ag] + [ar] * (3 * L)}
    if name == "dp_accum":
        # the micro-step's rows split over dp with no collective; the
        # update's one f32 mean of the loss and gradients
        return {"micro": [], "update": [ar]}
    if name == "pp_gpipe":
        m = N_MICRO
        hand = (["send"] * m + ["recv"] * m if index["pp"] == 0
                else ["recv"] * m + ["send"] * m)
        # the hand-offs as the schedule posts them (forward, then the
        # backward in reverse), the sends' waits, the shared leaves' sum
        # over pp and the last stage's loss broadcast
        return {"step": hand + ["wait"] * m + [ar, "broadcast"]}
    if name == "fsdp_sp_adamw":
        layer = [ag] * 7 + ["shift"]          # 7 matrices, one K/V hop
        forward = [ag] + layer * L + [ag]
        # the unembedding's reduce-scatter, then each layer in reverse:
        # its recompute, ring-flash's backward hop and the hop home, its
        # 7 reduce-scatters; the embedding's; the mean's two sums
        backward = ([ar] + (layer + ["shift"] * 2 + [ar] * 7) * L + [ar]
                    + [ar] * 2)
        return {"step": forward + backward}
    if name == "dp_ep_sgd":
        # each MoE layer gathers its rows over dp and sums its experts'
        # outputs over ep; backward, its two copy_to gradients over ep and
        # the gather's reduce-scatter over dp; the mean's sum
        return {"step": [ag, ar] * L + [ar] * (3 * L) + [ar]}
    raise KeyError(name)


def _jax_losses(name):
    """jaxbridge's single-program steps over the same batches (naive
    attention: flash and ring-flash compute the same attention)."""
    jcfg, _ = _cfgs(name)
    jcfg = dataclasses.replace(jcfg, attn="naive")
    _, kind, _, _, _ = CASES[name]
    params = jax.tree.map(jnp.asarray, _tree(name))
    losses = []
    if kind in ("sgd", "pipeline"):
        for toks in _batches(name):
            params, loss = jwl.sgd_train_step(params, jnp.asarray(toks),
                                              jcfg, lr=LR)
            losses.append(float(loss))
        return losses
    mesh = jmeshlib.build_named_mesh({"dp": 1})
    tx = optax.adamw(ADAMW_LR)
    if kind == "adamw":
        step, init, pshard, tshard = jwl.make_optax_train_step(mesh, jcfg,
                                                               tx)
    else:
        step, init, pshard, tshard = jwl.make_accum_train_step(
            mesh, jcfg, tx, accum_steps=N_MICRO)
    params = jax.device_put(params, pshard)
    state = init(params)
    for toks in _batches(name):
        params, state, loss = step(params, state,
                                   jax.device_put(jnp.asarray(toks), tshard))
        losses.append(float(loss))
    return losses


@pytest.mark.parametrize("name", list(CASES))
def test_bodies_losses_match_jaxbridge(ranks, name):
    """Three steps through the bodies: every rank's losses (the global
    mean; the last stage's under pp) within 1e-5 of jaxbridge's."""
    want = _jax_losses(name)
    for r in ranks[name]:
        assert r["losses"] == pytest.approx(want, rel=RTOL)


@pytest.mark.parametrize("name", list(CASES))
def test_collectives_of_one_body_call_are_pinned(ranks, name):
    for r in ranks[name]:
        assert r["counts"] == _pinned(name, r["index"])


@pytest.mark.parametrize("name", list(CASES))
def test_chain_breaks_at_each_collective_in_body_order(ranks, name):
    """N breaks of the body's kinds in its order, N + 1 segments, one more
    than the collectives of the warm-up (the card's check in
    ``chip_smoke.py``), each begun in relaxed mode; the breaks run twice
    a program call after the capturing one."""
    for r in ranks[name]:
        for prog, plan in r["plans"].items():
            kinds = r["counts"][prog]
            n = len(kinds)
            assert plan["breaks"] == kinds
            assert plan["segments"] == plan["warmup_collectives"] + 1 == n + 1
            calls = STEPS if prog != "micro" else STEPS * N_MICRO
            assert plan["breaks_run"] == n * (calls - 1)
        assert r["modes"] == ["relaxed"] * sum(
            p["segments"] for p in r["plans"].values())


@pytest.mark.parametrize("name", [n for n in CASES if n != "dp_accum"])
def test_every_call_runs_its_breaks_between_the_replays(ranks, name):
    """The first call is the warm-up (its collectives run as the body
    makes them; it is the step) and the capture (no collective runs: each
    segment begun after the last one ended, in the first one's pool);
    every later call replays segment 0, then runs each break and replays
    the next segment in turn."""
    for r in ranks[name]:
        kinds = r["counts"]["step"]
        n = len(kinds)
        log = [e for e in r["log"] if e[0] != "register"]
        assert log[:n + 1] == [("run", k) for k in kinds] + [("prepare",)]
        captures = log[n + 1:n + 1 + 2 * (n + 1)]
        assert captures[0::2] == [("begin", 0, None)] + [
            ("begin", i, ("pool of", 0)) for i in range(1, n + 1)]
        assert captures[1::2] == [("end", i) for i in range(n + 1)]
        replay = [("replay", 0)]
        for i, kind in enumerate(kinds):
            replay += [("run", kind), ("replay", i + 1)]
        assert log[n + 1 + 2 * (n + 1):] == replay * (STEPS - 1)


def test_accumulation_replays_its_micro_step_and_update_in_turn(ranks):
    """The accumulation's two programs: the micro-step (no collective, one
    segment) captured at its first call and replayed at the second, then
    the update (one mean, two segments) warmed, captured; each later
    stack replays the micro-step twice and the update with its mean run
    between its segments."""
    for r in ranks["dp_accum"]:
        log = [e for e in r["log"] if e[0] != "register"]
        first = [("prepare",), ("begin", 0, None), ("end", 0), ("replay", 0),
                 ("run", "all_reduce"), ("prepare",), ("begin", 1, None),
                 ("end", 1), ("begin", 2, ("pool of", 1)), ("end", 2)]
        later = [("replay", 0), ("replay", 0), ("replay", 1),
                 ("run", "all_reduce"), ("replay", 2)]
        assert log == first + later * (STEPS - 1)
