"""Programs over a mesh as chains of CUDA graphs broken at each collective
(``program.Program``, ``mesh.capturing``), on the CPU.

One spawn of two gloo ranks (``torch_ranks.mesh_program_rank``) builds a
tiny engine's programs on {"tp": 2}, {"ep": 2} (4 experts) and
{"fsdp": 2}, and ``decode``'s greedy and sampled steps on tp:

- the collectives one body call makes are pinned, kind by kind and in
  order: the card's chains (``chip_smoke.py`` phase 39) have one segment
  more than these counts at full width;
- each program, built graphed, is captured and called twice through the
  seam ``program._cuda``, a recorder standing in for the CUDA graphs, the
  side stream and the capture calls: its breaks come in the body's order
  with the body's kinds, N breaks and N + 1 segments, each segment begun
  and ended in turn in one pool, and every call replays the segments in
  order with a break between two;
- ``shift`` during a capture is a break: a shifting body is two segments
  whose hop runs between the replays, and ``send``, its ``wait``, ``recv``
  and ``shift`` each hand the chain one break of their kind;
- ``generate(tp=)`` and ``sample(tp=)`` replay one step program a token and
  equal the unsharded calls token for token (sampled: every rank's
  generator seeded alike, rank 0's draws broadcast).

No JAX here: the chain's parity with the reference is the existing mesh
tests' (``test_torch_tp_serve.py`` and the rest), whose bodies the chain
runs unchanged."""
from __future__ import annotations

import dataclasses
import types
import warnings

import numpy as np
import pytest
import torch

import torch_ranks
from tpusched_torch import decode, mesh as tmesh, program
from tpusched_torch import workload as wl
from tpusched_torch.program import Program

torch.set_num_threads(1)

DENSE = wl.ModelConfig.tiny()
MOE = dataclasses.replace(DENSE, n_experts=4)
CASES = {"tp": ({"tp": 2}, DENSE), "ep": ({"ep": 2}, MOE),
         "fsdp": ({"fsdp": 2}, DENSE)}
L, K = DENSE.n_layers, 3          # tiny's layers; the engine's spec_k

# one forward's collectives: tp gathers the embedding, sums each layer's
# attention and MLP outputs and the unembedding's; ep gathers each MoE
# layer's expert outputs; fsdp gathers each layer's 7 matrices, the
# embedding and the unembedding
FORWARD = {"tp": ["all_gather"] + ["all_reduce"] * (2 * L + 1),
           "ep": ["all_gather"] * L,
           "fsdp": ["all_gather"] * (7 * L + 2)}
# collectives a body call, by mesh and program: a forward each, the draft
# tick k of them; the sampled step adds its draw's broadcast
PINNED = {"tp": {"decode": 6, "prefill": 6, "chunk": 6, "draft": 18,
                 "verify": 6, "greedy_step": 6, "sampled_step": 7},
          "ep": {"decode": 2, "prefill": 2, "chunk": 2, "draft": 6,
                 "verify": 2},
          "fsdp": {"decode": 16, "prefill": 16, "chunk": 16, "draft": 48,
                   "verify": 16}}
PROGRAMS = [(m, p) for m, ps in PINNED.items() for p in ps]


def _tree(cfg):
    p = wl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return wl.tree_map(lambda t: t.numpy(), p)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = {name: (sizes, cfg, _tree(cfg))
             for name, (sizes, cfg) in CASES.items()}
    return tmesh.launch(torch_ranks.mesh_program_rank, {"tp": 2}, cases,
                        backend="gloo", device="cpu",
                        workdir=str(tmp_path_factory.mktemp("ranks")))


def _kinds(mesh_name, prog):
    forward = FORWARD[mesh_name]
    if prog == "draft":
        return forward * K
    if prog == "sampled_step":
        return forward + ["broadcast"]
    return forward


@pytest.mark.parametrize("mesh_name,prog", PROGRAMS)
def test_collectives_of_one_body_call_are_pinned(ranks, mesh_name, prog):
    for r in ranks:
        kinds = r[mesh_name]["counts"][prog]
        assert len(kinds) == PINNED[mesh_name][prog]
        assert kinds == _kinds(mesh_name, prog)


@pytest.mark.parametrize("mesh_name,prog", PROGRAMS)
def test_chain_breaks_at_each_collective_in_body_order(ranks, mesh_name,
                                                       prog):
    """N breaks of the body's kinds in its order, N + 1 segments, one more
    than the collectives the program counted in its warm-up (the card's
    check in ``chip_smoke.py``): the warm-up runs the body's collectives,
    the capture runs none and begins
    each segment after the last one ended, the engine's programs in the
    pool they were given, the steps (no pool) in their first segment's;
    every call replays segment 0, then runs each break and replays the
    next segment in turn."""
    for r in ranks:
        plan, kinds = r[mesh_name]["plans"][prog], r[mesh_name]["counts"][prog]
        n = len(kinds)
        assert plan["breaks"] == kinds
        assert plan["segments"] == plan["warmup_collectives"] + 1 == n + 1
        assert plan["modes"] == ["relaxed"] * (n + 1)
        log = [e for e in plan["log"] if e[0] != "register"]
        assert log[:n + 1] == [("run", k) for k in kinds] + [("prepare",)]
        captures = log[n + 1:n + 1 + 2 * (n + 1)]
        pools = [e[2] for e in captures[0::2]]
        assert [e[:2] for e in captures[0::2]] == [("begin", i)
                                                    for i in range(n + 1)]
        assert captures[1::2] == [("end", i) for i in range(n + 1)]
        if prog.endswith("_step"):
            assert pools == [None] + [("pool of", 0)] * n
        else:
            assert pools == [("engine pool",)] * (n + 1)
        # the sampled step's first call is its capture's warm-up (advances)
        calls = 1 if prog == "sampled_step" else 2
        replay = [("replay", 0)]
        for i, kind in enumerate(kinds):
            replay += [("run", kind), ("replay", i + 1)]
        assert log[n + 1 + 2 * (n + 1):] == replay * calls
        assert plan["breaks_run"] == n * calls


def test_generator_registered_with_every_segment(ranks):
    """The sampled step's generator is registered with each segment before
    its capture begins."""
    for r in ranks:
        log = r["tp"]["plans"]["sampled_step"]["log"]
        begins = [i for i, e in enumerate(log) if e[0] == "begin"]
        assert len(begins) == PINNED["tp"]["sampled_step"] + 1
        for i in begins:
            assert log[i - 1] == ("register", log[i][1])


def test_shift_during_a_capture_raises_naming_the_program(ranks):
    """The ring hop is a break like any other collective: a body that
    shifts along tp is captured as two segments broken at one ``shift``
    (relaxed mode, as every segment), whose hop runs between the replays on
    every call (none in the capture): each rank receives its neighbour's
    values, where the capture left its receive buffer unfilled. (The hop
    raised during a capture before the hand-offs became breaks.)"""
    for r, rank in enumerate(ranks):
        cap = rank["shift_capture"]
        assert cap["breaks"] == ["shift"] and cap["segments"] == 2
        assert cap["breaks_run"] == 2
        assert cap["modes"] == ["relaxed", "relaxed"]
        assert cap["log"] == [("prepare",), ("begin", 0, None), ("end", 0),
                              ("begin", 1, ("pool of", 0)), ("end", 1),
                              ("replay", 0), ("replay", 1),
                              ("replay", 0), ("replay", 1)]
        other = float(1 - r)
        assert cap["received"] == [other] * 3
        # the recorder runs no kernel: the output is the capture's own run
        # of the body, on the receive buffer before any hop filled it
        assert cap["outputs"][0] == cap["outputs"][1]


@pytest.mark.parametrize("what", ["send", "recv", "shift"])
def test_point_to_point_refused_inside_capturing(what):
    """``send`` (and its ``wait``), ``recv`` and ``shift`` on a live axis
    cut the chain inside ``mesh.capturing``: each hands the chain one
    break of its kind and posts no message (the axis's group is no process
    group: any message would raise), its receive buffer made where the
    call was. (They raised inside a capture before the hand-offs became
    breaks.)"""
    axis = tmesh.Axis("pp", 2, 0, object(), (0, 1))
    breaks = []
    chain = types.SimpleNamespace(name="probe", cut=breaks.append)
    x = torch.arange(2.0)
    with tmesh.capturing(chain):
        if what == "send":
            sent = tmesh.send(x, axis, 1)
            sent.wait()
            got = [("send", sent, {}), ("wait", sent, {})]
        elif what == "recv":
            buf = tmesh.recv(axis, 1, (2,), torch.float32, "cpu")
            got = [("recv", buf, {"src": 1, "group": axis.group})]
        else:
            out = tmesh.shift([x], axis)
            got = [("shift", ([x], out), {"dst": 1, "src": 1,
                                          "group": axis.group})]
    assert tmesh._chain is None
    assert [(b.kind, b.kwargs) for b in breaks] == [(k, kw)
                                                   for k, _, kw in got]
    for brk, (_, tensor, _) in zip(breaks, got):
        if what == "shift":
            (sends, recvs), (want_sends, want_recvs) = brk.tensor, tensor
            assert torch.equal(sends[0], want_sends[0])
            assert recvs[0] is want_recvs[0]
        else:
            assert brk.tensor is tensor


def test_capturing_refuses_a_second_chain():
    outer = types.SimpleNamespace(name="outer", cut=None)
    with tmesh.capturing(outer):
        with pytest.raises(RuntimeError, match="inside the capture of "
                                               "'outer'"):
            with tmesh.capturing(types.SimpleNamespace(name="inner")):
                pass
        assert tmesh._chain is outer
    assert tmesh._chain is None


def test_a_body_with_no_collective_is_one_segment(monkeypatch):
    """One card: a program whose body makes no collective captures one
    segment, with no break, and replays it once a call."""
    recorder = torch_ranks.CaptureRecorder()
    monkeypatch.setattr(program, "_cuda", recorder)
    x = torch.zeros(3)
    prog = Program(lambda: x * 2, {"x": x}, graphed=True)
    assert prog.graph is None
    for i in range(3):
        out = prog(x=np.full(3, float(i)))
    assert len(prog.segments) == 1 and prog.breaks == []
    assert prog.warmup_collectives == 0
    assert prog.graph is prog.segments[0] and prog.breaks_run == 0
    assert recorder.log == [("prepare",), ("begin", 0, None), ("end", 0),
                            ("replay", 0), ("replay", 0), ("replay", 0)]
    # the recorder runs no kernel: the output is the capture's own run
    assert out.tolist() == [0.0, 0.0, 0.0]


class _EmptyGraphs(torch_ranks.CaptureRecorder):
    """A recorder whose every graph warns at ``capture_end`` as CUDA does
    for a graph that recorded no kernel."""

    def graph(self):
        graph = super().graph()
        end = graph.capture_end

        def capture_end():
            end()
            warnings.warn(f"The CUDA Graph is empty. (graph {graph.index})")
        graph.capture_end = capture_end
        return graph


def test_only_a_segment_after_a_collective_hides_an_empty_graph(
        monkeypatch):
    """An empty segment after a break is silent (an f32 sum passed on as
    it is); an empty first or only segment warns, since there it means
    work the capture did not record."""
    monkeypatch.setattr(program, "_cuda", _EmptyGraphs())
    x = torch.zeros(2)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        chain = program._Chain("probe", None, ())
        for _ in range(2):
            chain.cut(tmesh.Collective("all_reduce", None, x, {}))
        chain.end()
        only = program._Chain("only", None, ())
        only.end()
    assert len(chain.segments) == 3 and len(chain.breaks) == 2
    # the chain's segment 0 warns, 1 and 2 (after a break) do not; the
    # only segment of a chain with no break warns
    assert [str(w.message) for w in caught] == [
        "The CUDA Graph is empty. (graph 0)",
        "The CUDA Graph is empty. (graph 3)"]
    assert program._cuda.log == [("begin", 0, None), ("end", 0),
                                 ("begin", 1, ("pool of", 0)), ("end", 1),
                                 ("begin", 2, ("pool of", 0)), ("end", 2),
                                 ("begin", 3, None), ("end", 3)]


def _unsharded(prompt, temperature):
    tree = _tree(DENSE)
    from tpusched_torch import interop
    params = interop.params_from_numpy(tree, DENSE, "cpu")
    if temperature == 0.0:
        return decode.generate(params, prompt, DENSE, 5)
    return decode.sample(params, prompt, DENSE, 5,
                         torch.Generator().manual_seed(7), temperature,
                         top_k=20)


@pytest.mark.parametrize("what", ["generate", "sample"])
def test_decoding_under_tp_equals_unsharded_token_for_token(ranks, what):
    """``generate(tp=)`` (greedy) and ``sample(tp=)`` (T 0.8, top-k 20, one
    seed on every rank) on two ranks: both ranks return the unsharded
    call's tokens, each through 5 calls of its step program."""
    prompt = torch.arange(12).reshape(2, 6) % DENSE.vocab
    want = _unsharded(prompt, 0.0 if what == "generate" else 0.8).tolist()
    for r in ranks:
        assert r["decode"][what] == want
    step = {"generate": "_greedy_step", "sample": "_sampled_step"}[what]
    for r in ranks:
        assert sum(c.startswith(step) for c in r["decode"]["calls"]) == 5
