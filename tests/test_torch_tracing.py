"""tpusched_torch.tracing on the CPU: the spans a tiny engine and the train
steps record, how they nest, the programs' counters, the switch, the
ring, the profiler's annotations and the device phases' reading."""
from __future__ import annotations

import collections
import dataclasses
import gc
import json

import numpy as np
import pytest
import torch

import torch_ranks
from tpusched_torch import optim, program, tracing, workload as wl
from tpusched_torch.program import Program
from tpusched_torch.serve import Request, ServeEngine

torch.set_num_threads(1)

ENGINES = {"plain": {}, "keyed": dict(request_keyed=True, temperature=0.8),
           "flash": {}}


@pytest.fixture(autouse=True)
def fresh():
    tracing.reset()
    tracing.enable(True)
    yield
    tracing.enable(True)
    tracing.reset()


@pytest.fixture(scope="module")
def model():
    cfg = wl.ModelConfig.tiny()
    return cfg, wl.init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _serve(model, kind="plain", n=5, **kw):
    cfg, params = model
    if kind == "flash":
        cfg = dataclasses.replace(cfg, attn="flash")
    eng = ServeEngine(params, cfg, slots=2, max_seq=64, prompt_bucket=(16, 24),
                      device="cpu", **ENGINES[kind], **kw)
    rng = np.random.default_rng(3)
    for i in range(n):
        eng.submit(Request(rid=100 + i, prompt=rng.integers(
            0, cfg.vocab, size=int(rng.integers(3, 20)), dtype=np.int32),
            max_new_tokens=int(rng.integers(1, 6))))
    eng.run_until_drained()
    return eng, tracing.spans()


def _by_id(spans):
    return {s["id"]: s for s in spans}


@pytest.mark.parametrize("kind", list(ENGINES))
def test_serving_spans_nest_as_the_layers_say(model, kind):
    eng, spans = _serve(model, kind)
    ids = _by_id(spans)
    parent = {s["id"]: ids.get(s["parent"], {}).get("name") for s in spans}
    allowed = {"serve.tick": {None}, "serve.queued": {None},
               "serve.admit": {"serve.tick"},
               "serve.sample": {"serve.tick", "serve.admit"},
               "serve.book": {"serve.tick"},
               "program.stage": {"serve.admit", "serve.tick"},
               "program.replay": {"serve.admit", "serve.tick"}}
    names = collections.Counter(s["name"] for s in spans)
    assert set(names) - {"python.gc"} == set(allowed)
    for s in spans:
        if s["name"] != "python.gc":
            assert parent[s["id"]] in allowed[s["name"]], s
        assert s["start_ns"] <= s["end_ns"]
    assert names["serve.tick"] == eng.tick_count
    assert [s["attrs"]["tick"] for s in spans if s["name"] == "serve.tick"] \
        == list(range(eng.tick_count))
    labels = {s["label"] for s in spans if s["name"].startswith("program.")}
    assert labels == {"_build_prefill_slot.<locals>.body",
                      "_build_decode_tick.<locals>.body"}


@pytest.mark.parametrize("kind", list(ENGINES))
def test_admissions_are_the_prefills_and_share_their_request(model, kind):
    eng, spans = _serve(model, kind)
    admits = [s for s in spans if s["name"] == "serve.admit"]
    queued = {s["attrs"]["rid"]: s for s in spans
              if s["name"] == "serve.queued"}
    assert len(admits) == eng.prefills == 5
    assert sorted(queued) == sorted(a["attrs"]["rid"] for a in admits)
    for a in admits:
        q = queued[a["attrs"]["rid"]]
        assert q["start_ns"] <= q["end_ns"] <= a["start_ns"]
        n = a["attrs"]["true_len"]
        assert a["attrs"]["bucket"] == (16 if n <= 16 else 24)
        assert 0 <= a["attrs"]["slot"] < eng.slots


def test_a_ticks_children_lie_inside_it_and_do_not_overlap(model):
    eng, spans = _serve(model, n=6)
    ticks = [s for s in spans if s["name"] == "serve.tick"]
    for t in ticks:
        kids = sorted((s for s in spans if s["parent"] == t["id"]),
                      key=lambda s: s["start_ns"])
        assert kids
        for k in kids:
            assert t["start_ns"] <= k["start_ns"] <= k["end_ns"] <= t["end_ns"]
        for a, b in zip(kids, kids[1:]):
            assert a["end_ns"] <= b["start_ns"]
        tail = [k["name"] for k in kids if k["name"] != "serve.admit"]
        if t["attrs"]["active"]:
            assert tail == ["program.stage", "program.replay",
                            "serve.sample", "serve.book"]
            assert {k["label"] for k in kids if k["name"].startswith(
                "program.")} == {"_build_decode_tick.<locals>.body"}
    finished = sum(s["attrs"]["finished"] for s in spans
                   if s["name"] == "serve.book")
    admitted_done = len(eng.completions) - finished
    assert finished > 0 and admitted_done >= 0


def test_a_chunked_engine_admits_without_a_prefill(model):
    eng, spans = _serve(model, chunk_prefill=8)
    names = collections.Counter(s["name"] for s in spans)
    assert eng.prefills == 0 and names["serve.admit"] == 0
    assert names["serve.queued"] == 5 and names["serve.tick"] == eng.tick_count


def _replayed(graphed, advances, monkeypatch, calls=4):
    if graphed:
        monkeypatch.setattr(program, "_cuda", torch_ranks.CaptureRecorder())
    x = torch.zeros(3)
    state = torch.zeros(3)

    def body():
        state.add_(x)
        return state * 2

    prog = Program(body, {"x": x}, graphed=graphed, advances=advances)
    if graphed and not advances:
        prog.capture()
    for i in range(calls):
        prog(x=np.full(3, float(i)))
    return prog


@pytest.mark.parametrize("graphed,advances,replays,captures", [
    (True, True, 3, 1), (True, False, 4, 1), (False, True, 4, 0),
    (False, False, 4, 0)])
def test_programs_count_replays_and_captures(graphed, advances, replays,
                                             captures, monkeypatch):
    """Four calls: an advancing program's first call is its capture and no
    replay (its warm-up was that call's step); one captured up front
    replays every call; an ungraphed one runs its body every call."""
    prog = _replayed(graphed, advances, monkeypatch)
    assert (prog.replays, prog.captures) == (replays, captures)
    names = collections.Counter(s["name"] for s in tracing.spans())
    assert names["program.stage"] == 4
    assert names["program.replay"] == replays
    assert names["program.warmup"] == names["program.capture"] == captures
    got = tracing.counters()["programs"][prog.name]
    assert got == {"replays": replays, "captures": captures, "breaks_run": 0}


def test_stage_counts_the_bytes_it_copies(monkeypatch):
    _replayed(False, False, monkeypatch, calls=1)
    stage = [s for s in tracing.spans() if s["name"] == "program.stage"]
    assert [s["attrs"]["bytes"] for s in stage] == [3 * 4]


def test_switched_off_records_nothing_and_counters_still_count(
        model, monkeypatch):
    tracing.enable(False)
    eng, spans = _serve(model)
    prog = _replayed(True, True, monkeypatch)
    gc.collect()
    assert spans == [] and tracing.spans() == []
    assert eng.prefills == 5 and prog.replays == 3
    tracing.enable(True)
    gc.collect()
    assert [s["name"] for s in tracing.spans()] == ["python.gc"]


def test_the_ring_drops_the_oldest_span_and_counts_it():
    rec = tracing.Recorder(size=4)
    for i in range(6):
        rec.end(rec.begin("serve.tick", i))
    assert rec.dropped == 2
    assert [s["attrs"]["tick"] for s in rec.spans()] == [2, 3, 4, 5]
    outer = rec.begin("serve.tick", 9)
    for _ in range(4):
        rec.end(rec.begin("serve.book"))
    rec.end(outer)                  # its record was overwritten: not kept
    assert rec.dropped == 7
    assert [s["name"] for s in rec.spans()] == ["serve.book"] * 4
    assert rec.stack == []


def test_an_unclosed_span_is_closed_by_its_parent():
    rec = tracing.Recorder(size=8)
    outer = rec.begin("serve.tick")
    rec.begin("serve.sample")        # left open, as an exception would
    rec.end(outer)
    assert rec.stack == [] and [s["name"] for s in rec.spans()] == [
        "serve.tick"]


def test_under_the_profiler_spans_are_annotations_nested_in_the_caller(
        model, tmp_path):
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        with torch.profiler.record_function("outer.call"):
            eng, spans = _serve(model, n=2)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation" and e.get("ph") == "X"]
    outer = [e for e in events if e["name"] == "outer.call"]
    assert len(outer) == 1
    lo, hi = outer[0]["ts"], outer[0]["ts"] + outer[0]["dur"]
    got = collections.Counter(e["name"] for e in events
                              if lo <= e["ts"] and e["ts"] + e["dur"] <= hi)
    want = collections.Counter(s["name"] for s in spans
                               if s["name"] not in ("serve.queued",
                                                    "python.gc"))
    assert {k: got[k] for k in want} == want
    # no profiler, no annotation object
    tracing.end(tracing.begin("serve.tick"))
    assert tracing._rec.annotations == []


def _train(kind, model, steps=2):
    cfg, params = model
    params = wl.tree_map(torch.clone, params)
    tokens = torch.randint(0, cfg.vocab, (2, 16),
                           generator=torch.Generator().manual_seed(4))
    if kind == "sgd":
        step, _, _ = wl.make_sharded_train_step(None, cfg, lr=1e-2)
        for _ in range(steps):
            params, _ = step(params, tokens)
        return
    tx = optim.adamw(1e-3)
    if kind == "adamw":
        step, init, _, _ = wl.make_optax_train_step(None, cfg, tx)
    else:
        step, init, _, _ = wl.make_accum_train_step(None, cfg, tx, 2)
        tokens = torch.stack([tokens, tokens.flip(0)])
    state = init(params)
    for _ in range(steps):
        params, state, _ = step(params, state, tokens)


@pytest.mark.parametrize("kind,forwards", [("adamw", 1), ("accum", 2),
                                           ("sgd", 1)])
def test_a_train_step_records_its_phases_in_order(model, kind, forwards):
    _train(kind, model)
    spans = tracing.spans()
    ids = _by_id(spans)
    steps = [s for s in spans if s["name"] == "train.step"]
    assert [s["attrs"]["step"] for s in steps] == [1, 2]

    def under(step):
        out = []
        for s in spans:
            up = ids.get(s["parent"])
            while up is not None and up is not step:
                up = ids.get(up["parent"])
            if up is step:
                out.append(s)
        return out

    for st in steps:
        kids = under(st)
        phases = [s["name"] for s in sorted(kids, key=lambda s: s["start_ns"])
                  if s["name"].split(".")[1] in ("forward", "backward",
                                                 "optimizer")]
        assert phases == (["train.forward", "train.backward"] * forwards
                          + ["train.optimizer"])
        assert all(s["attrs"]["step"] == st["attrs"]["step"] for s in kids
                   if s["name"] in ("train.forward", "train.optimizer"))
        assert all(s["device_ns"] is None for s in kids)
        for s in kids:
            assert st["start_ns"] <= s["start_ns"] <= s["end_ns"] \
                <= st["end_ns"]


class _Event:
    """Stands in for a CUDA timing event: done or not, at a time in ms."""

    def __init__(self, ms, done=True):
        self.ms, self.done = ms, done

    def query(self):
        return self.done

    def elapsed_time(self, other):
        return other.ms - self.ms


def _launch(rec, timed, n):
    """One replay of a program whose capture recorded ``timed``, inside
    train step ``n``, as ``Program.__call__`` makes it."""
    outer = rec.begin("train.step", n)
    replay = rec.begin("program.replay", label="prog")
    rec.launching(timed)
    rec.replayed(timed)
    rec.end(replay)
    rec.end(outer)
    return replay


def test_device_phases_are_read_without_a_wait_or_counted_unread():
    rec = tracing.Recorder(size=32)
    pairs = [("train.forward", _Event(1.0), _Event(3.5)),
             ("train.backward", _Event(3.5), _Event(9.0))]
    timed = tracing.Timed(pairs)
    replay = _launch(rec, timed, 7)
    rec.poll()                               # the step's next call
    got = [s for s in rec.spans() if s["device_ns"] is not None]
    assert [(s["name"], s["device_ns"], s["attrs"], s["parent"])
            for s in got] == [
        ("train.forward", 2_500_000, {"step": 7, "unread": 0}, replay),
        ("train.backward", 5_500_000, {"step": 7, "unread": 0}, replay)]
    assert rec.armed == []
    _launch(rec, timed, 8)
    pairs[1][2].done = False                 # still running at the next call
    _launch(rec, timed, 9)                   # step 8's reading skipped
    assert rec.device_unread == 2
    pairs[1][2].done = True
    assert [s["attrs"]["step"] for s in rec.spans()
            if s["device_ns"] is not None] == [7, 7, 9, 9]
    assert [(s["name"], s["attrs"]) for s in rec.spans()
            if s["attrs"].get("unread")] == [
        ("train.forward", {"step": 8, "unread": 1}),
        ("train.backward", {"step": 8, "unread": 1})]
    # a collection keeps what has not completed; the next call skips it
    _launch(rec, timed, 10)
    pairs[0][2].done = False
    assert len(rec.spans()) == 14 and len(rec.armed) == 1
    rec.poll()
    assert rec.device_unread == 4 and rec.armed == []


def test_a_program_replayed_twice_between_polls_reads_each_replay_it_can():
    """The accumulation step's micro-step program: its next launch records
    the events anew, so the last replay's phases are read before it, or
    written unread when the card has not run them yet; never read after
    the launch as the new replay's."""
    rec = tracing.Recorder(size=32)
    fwd = (_Event(0.0), _Event(2.0))
    timed = tracing.Timed([("train.forward", *fwd)])
    outer = rec.begin("train.step", 3)

    def micro(ms, done_before_next):
        replay = rec.begin("program.replay", label="micro")
        rec.launching(timed)
        fwd[1].ms, fwd[1].done = ms, False   # the launch records it anew
        rec.replayed(timed)
        rec.end(replay)
        fwd[1].done = done_before_next

    micro(2.0, True)          # had run on the card before the next launch
    micro(4.0, False)         # had not
    micro(6.0, True)          # the last: read at the step's next call
    rec.end(outer)
    rec.poll()
    got = [(s["device_ns"], s["attrs"]) for s in rec.spans()
           if s["name"] == "train.forward"]
    assert got == [(2_000_000, {"step": 3, "unread": 0}),
                   (None, {"step": 3, "unread": 1}),
                   (6_000_000, {"step": 3, "unread": 0})]
    assert rec.device_unread == 1 and rec.armed == []
    assert not timed.armed


@pytest.mark.parametrize("where", ["tick", "train step", "program"])
def test_a_raise_leaves_no_span_open(model, monkeypatch, where):
    """An exception inside a tick, a train step or a program's call closes
    its spans; the next one is a root span again."""
    cfg, params = model

    def boom(*a, **k):
        raise RuntimeError("boom")

    if where == "tick":
        eng = ServeEngine(params, cfg, slots=2, max_seq=64,
                          prompt_bucket=(16,), device="cpu")
        eng.submit(Request(rid=1, prompt=np.arange(1, 6, dtype=np.int32),
                           max_new_tokens=3))
        monkeypatch.setattr(eng, "_sample", boom)
        go = eng.tick
    elif where == "train step":
        tx = optim.adamw(1e-3)
        step, init, _, _ = wl.make_optax_train_step(None, cfg, tx)
        tokens = torch.randint(0, cfg.vocab, (2, 16))
        state = init(params)
        monkeypatch.setattr(type(tx), "advance_", boom)

        def go():
            step(params, state, tokens)
    else:
        def go():
            Program(lambda: boom(), {"x": torch.zeros(2)},
                    graphed=False)(x=np.ones(2))
    with pytest.raises(RuntimeError, match="boom"):
        go()
    assert tracing._rec.stack == [] and tracing._rec.annotations == []
    outer = {"tick": "serve.tick", "train step": "train.step",
             "program": "program.replay"}[where]
    closed = [s for s in tracing.spans() if s["name"] == outer]
    assert len(closed) == 1 and closed[0]["end_ns"] >= closed[0]["start_ns"]
    tracing.end(tracing.begin("serve.book"))
    assert tracing.spans()[-1]["parent"] == -1


def test_a_collection_is_a_span_with_its_generation():
    gc.collect()
    got = [s for s in tracing.spans() if s["name"] == "python.gc"]
    assert got and got[-1]["attrs"]["generation"] == 2


def test_counters_read_the_port_where_it_counts(model):
    from tpusched_torch import attention, mesh
    eng, _ = _serve(model, "flash", n=3)
    c = tracing.counters()
    assert c["flash_fwd_launches"] == attention.FLASH_FWD_LAUNCHES
    assert c["collectives_run"] == mesh.COLLECTIVES_RUN
    assert c["spans_dropped"] == 0 and c["device_unread"] == 0
    decode = c["programs"]["_build_decode_tick.<locals>.body"]
    assert decode == {"replays": eng.tick_count, "captures": 0,
                      "breaks_run": 0}
