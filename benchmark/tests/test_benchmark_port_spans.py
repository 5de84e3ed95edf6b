"""The readers of the port's own spans (``port_spans`` and the metrics that
use it) on hand-built records: a synthetic trace, the benchmark's ticks
and steps, and port spans whose host clock lies a known offset from the
trace's. Each reader gives the value worked out by hand, and None when
the port recorded nothing or has no recorder."""
import json
import pathlib
import sys

import pytest

from benchmark import port_spans
from benchmark.harness import Bench
from benchmark.trace import Trace

REPO = pathlib.Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NEW = ["stage_idle_ms.chat", "stage_idle_ms.batch", "engine_idle_ms.chat",
       "engine_idle_ms.batch", "first_token_hold_ms.chat", "forward_ms.train", "backward_ms.train",
       "optimizer_ms.train", "capture_s.serve", "capture_s.train"]
H = 5000.0          # host clock = trace clock + H


def _trace(tmp_path, spans, kernels):
    """A chrome trace of ``spans`` (name -> (start, end)) and kernels, in
    seconds on the trace's clock."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a * 1e6,
           "dur": (b - a) * 1e6} for n, (a, b) in spans.items()]
    ev += [{"ph": "X", "cat": "kernel", "name": "k", "ts": a * 1e6,
            "dur": (b - a) * 1e6, "args": {}} for a, b in kernels]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return Trace(str(path))


def _span(sid, name, a, b, parent=-1, device_ns=None, **attrs):
    return {"id": sid, "name": name, "label": None,
            "start_ns": round(a * 1e9), "end_ns": round(b * 1e9),
            "parent": parent, "attrs": attrs, "device_ns": device_ns}


def _serving(tmp_path):
    tr = _trace(tmp_path, {"bench.window": (0.0, 1.0),
                           "bench.tick#0": (0.100, 0.300),
                           "bench.tick#1": (0.400, 0.500)},
                [(0.115, 0.118), (0.121, 0.195), (0.206, 0.280),
                 (0.405, 0.485)])
    ticks = [
        {"t0": H + 0.100, "t1": H + 0.300, "admits": [(20, 32)],
         "traced": True, "idx": 0},
        {"t0": H + 0.400, "t1": H + 0.500, "admits": [], "traced": True,
         "idx": 1},
        {"t0": H + 1.0, "t1": H + 1.2, "admits": [(20, 32), (9, 32)],
         "traced": False, "idx": 2},
        {"t0": H + 6.0, "t1": H + 6.2, "admits": [(5, 32)], "traced": False,
         "idx": 3},
    ]
    spans = [
        _span(0, "program.warmup", H - 3.0, H - 2.0),
        _span(1, "program.capture", H - 2.0, H - 1.5),
        _span(2, "serve.tick", H + 0.105, H + 0.290, tick=0, active=3),
        _span(3, "program.stage", H + 0.110, H + 0.120, 2, bytes=8),
        _span(4, "program.stage", H + 0.200, H + 0.205, 2, bytes=8),
        _span(5, "serve.tick", H + 0.402, H + 0.490, tick=1, active=3),
        _span(6, "program.stage", H + 0.403, H + 0.404, 5, bytes=8),
        _span(7, "program.capture", H + 0.5, H + 0.6),
        _span(8, "serve.tick", H + 1.01, H + 1.19, tick=2, active=4),
        _span(9, "serve.queued", H + 0.99, H + 1.02, rid=7),
        _span(10, "serve.admit", H + 1.02, H + 1.05, 8, rid=7),
        _span(11, "serve.queued", H + 0.995, H + 1.05, rid=8),
        _span(12, "serve.admit", H + 1.05, H + 1.08, 8, rid=8),
        _span(13, "serve.tick", H + 6.01, H + 6.19, tick=3, active=4),
        _span(14, "serve.queued", H + 5.5, H + 6.02, rid=9),
        _span(15, "serve.admit", H + 6.02, H + 6.05, 13, rid=9),
    ]
    records = {"ticks": ticks, "window": (H, H + 10.0),
               "trace_started": H + 5.0, "trace": tr}
    return records, spans


def _training(tmp_path):
    tr = _trace(tmp_path, {"bench.window": (0.0, 1.0)}, [])
    steps = [{"t0": H + 1.0, "t1": H + 1.7, "traced": False, "idx": 0},
             {"t0": H + 1.7, "t1": H + 2.4, "traced": False, "idx": 1},
             {"t0": H + 6.0, "t1": H + 6.7, "traced": True, "idx": 2}]
    spans = [_span(0, "program.warmup", H - 9.0, H - 2.0),
             _span(1, "program.capture", H - 2.0, H - 1.0)]
    phases = [(120, 350, 200), (130, 360, 210), (999, 999, 999)]
    for i, (st, ms) in enumerate(zip(steps, phases)):
        base = 10 * (i + 1)
        spans.append(_span(base, "train.step", st["t0"] + 0.001,
                           st["t1"] - 0.01, step=i + 1))
        spans.append(_span(base + 1, "program.replay", st["t0"] + 0.002,
                           st["t0"] + 0.003, base))
        for j, name in enumerate(("train.forward", "train.backward",
                                  "train.optimizer")):
            spans.append(_span(base + 2 + j, name, st["t0"] + 0.003,
                               st["t0"] + 0.003, base + 1,
                               device_ns=ms[j] * 10**6, step=i + 1))
    # a second forward in step 1 (an accumulation step) adds to it
    spans.append(_span(15, "train.forward", H + 1.003, H + 1.003, 11,
                       device_ns=10 * 10**6, step=1))
    records = {"steps": steps, "window": (H, H + 10.0),
               "trace_started": H + 5.0, "trace": tr}
    return records, spans


@pytest.fixture
def recorded(monkeypatch):
    """Stand the hand-built spans in for the port's recorder."""
    from tpusched_torch import tracing
    box = []
    monkeypatch.setattr(tracing, "spans",
                        lambda: [dict(s) for s in box[0]])
    return box


def _read(name, records):
    return Bench(REPO).reader(name).read(records)


def test_idle_splits_each_traced_tick_three_ways(tmp_path, recorded):
    records, spans = _serving(tmp_path)
    recorded.append(spans)
    rows = port_spans.tick_idle(records)
    assert [round(r["offset"], 9) for r in rows] == [-H, -H]
    want = [(0.049, 0.012, 0.022, 0.015), (0.020, 0.001, 0.007, 0.012)]
    for r, (whole, stage, engine, outside) in zip(rows, want):
        assert r["whole"] == pytest.approx(whole, abs=1e-9)
        assert r["stage"] == pytest.approx(stage, abs=1e-9)
        assert r["engine"] == pytest.approx(engine, abs=1e-9)
        assert r["outside"] == pytest.approx(outside, abs=1e-9)
        # the parts close on the idle inside bench.tick#i
        assert r["stage"] + r["engine"] + r["outside"] == pytest.approx(
            r["whole"], abs=1e-12)
    for cell in ("chat", "batch"):
        assert _read(f"stage_idle_ms.{cell}", records) == pytest.approx(6.5)
        assert _read(f"engine_idle_ms.{cell}", records) == pytest.approx(14.5)


def test_a_ticks_offset_places_the_port_on_the_trace(tmp_path, recorded):
    """A tick whose host clock lies 2 ms off the other's still closes: each
    tick's spans take that tick's own offset."""
    records, spans = _serving(tmp_path)
    records["ticks"][1] = dict(records["ticks"][1], t0=H + 0.402,
                               t1=H + 0.502)
    for s in spans:
        if s["id"] in (5, 6):
            s["start_ns"] += 2_000_000
            s["end_ns"] += 2_000_000
    recorded.append(spans)
    rows = port_spans.tick_idle(records)
    assert rows[1]["offset"] == pytest.approx(-H - 0.002)
    assert rows[1]["stage"] == pytest.approx(0.001, abs=1e-9)
    assert rows[1]["engine"] == pytest.approx(0.007, abs=1e-9)


def test_first_token_hold_over_the_window_admissions(tmp_path, recorded):
    records, spans = _serving(tmp_path)
    recorded.append(spans)
    got = port_spans.admissions(records)
    # the admission after the profiler started (rid 9) is left out
    assert [adm["attrs"]["rid"] for adm, _ in got] == [7, 8]
    # the tick ends 140 and 110 ms after each first token
    assert _read("first_token_hold_ms.chat", records) == pytest.approx(125.0)


def test_capture_seconds_before_the_window(tmp_path, recorded):
    records, spans = _serving(tmp_path)
    recorded.append(spans)
    assert _read("capture_s.serve", records) == pytest.approx(1.5)
    records, spans = _training(tmp_path)
    recorded[0] = spans
    assert _read("capture_s.train", records) == pytest.approx(8.0)


@pytest.mark.parametrize("name,ms", [("forward_ms.train", (130 + 130) / 2),
                                     ("backward_ms.train", (350 + 360) / 2),
                                     ("optimizer_ms.train", (200 + 210) / 2)])
def test_train_phases_over_the_window_steps(tmp_path, recorded, name, ms):
    records, spans = _training(tmp_path)
    recorded.append(spans)
    assert _read(name, records) == pytest.approx(ms)


@pytest.mark.parametrize("name,ms", [("forward_ms.train", 130),
                                     ("backward_ms.train", 360),
                                     ("optimizer_ms.train", 210)])
def test_a_step_with_an_unread_phase_is_left_out(tmp_path, recorded, name,
                                                 ms):
    """Step 1's first micro-step was launched over before it was read: the
    port wrote its phases unread, so step 1 holds a part of its time and
    only step 2 is averaged."""
    records, spans = _training(tmp_path)
    for j, phase in enumerate(("train.forward", "train.backward")):
        spans.append(_span(16 + j, phase, H + 1.0025, H + 1.0025, 11,
                           step=1, unread=1))
    recorded.append(spans)
    if name == "optimizer_ms.train":
        ms = (200 + 210) / 2        # its one reading a step arrived
    assert _read(name, records) == pytest.approx(ms)


def test_host_timed_phases_are_not_read_as_device_time(tmp_path, recorded):
    records, spans = _training(tmp_path)
    recorded.append([dict(s, device_ns=None) for s in spans])
    assert _read("forward_ms.train", records) is None


@pytest.mark.parametrize("name", NEW)
def test_each_reader_gives_none_without_the_recorder(name, tmp_path,
                                                     monkeypatch):
    """The parent of this benchmark has no ``tpusched_torch.tracing``."""
    records, _ = (_training if name.endswith("train") else _serving)(
        tmp_path)
    monkeypatch.setitem(sys.modules, "tpusched_torch.tracing", None)
    assert _read(name, records) is None


@pytest.mark.parametrize("name", NEW)
def test_each_reader_gives_none_when_nothing_was_recorded(name, tmp_path,
                                                          recorded):
    records, _ = (_training if name.endswith("train") else _serving)(
        tmp_path)
    recorded.append([])
    assert _read(name, records) is None


def test_the_new_metrics_are_entries_of_the_spec():
    got = {m["name"]: m for m in SPEC["per_layer"]}
    assert all(n in got for n in NEW)
    assert [m["name"] for m in SPEC["per_layer"]][-len(NEW):] == NEW
