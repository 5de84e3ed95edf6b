"""The harness end to end on the CPU at a tiny size: the result line, the
check failing under planted faults, a cell added from files alone, and
the refusals of the command line."""
import json
import pathlib
import shutil
import subprocess
import sys
import time

import pytest

from benchmark import harness
from benchmark.tests.conftest import (TINY_CELL, TINY_MIX, tiny_conf,
                                      tiny_overrides)

REPO = pathlib.Path(__file__).resolve().parents[2]
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
SERVING = [c for c in CELLS if not c.endswith("train-4k")]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def tiny_run(cell, trace=False, root=None, seconds=1.0, seed=2**31 + 77):
    return harness.run_cell(cell, seed, seconds, trace, time.perf_counter(),
                            device="cpu", root=root,
                            conf_override=tiny_conf("mixtral" in cell),
                            **tiny_overrides(cell))


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell):
    r = tiny_run(cell)
    assert all(k in r for k in KEYS)
    assert list(r)[-1] == "compared"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    want = {m["name"] for m in SPEC["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}
    assert set(r["metrics"]) == want and "setup_s" in want
    assert all(m["value"] > 0 for m in r["metrics"].values())
    json.loads(json.dumps(r))


def _altered_token(monkeypatch):
    from tpusched_torch import serve
    real = serve.sample_token

    def plus_one(logits, *a, **k):
        return (real(logits, *a, **k) + 1) % logits.shape[-1]

    monkeypatch.setattr(serve, "sample_token", plus_one)


def _state_unchanged(monkeypatch):
    from tpusched_torch import decode
    monkeypatch.setattr(decode, "cache_update", lambda c, *a, **k: c)


@pytest.mark.parametrize("fault", [_altered_token, _state_unchanged],
                         ids=["token_altered", "state_unchanged"])
@pytest.mark.parametrize("cell", SERVING)
def test_planted_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = tiny_run(cell)
    assert r["correct"] is False
    assert (r["compared"]["max_logit_gap"]["value"]
            > r["compared"]["max_logit_gap"]["limit"])


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_the_programs_place_is_not_correct(cell):
    """The control (the fp8 reference) judged by the cell's own check and
    limits comes out not correct, beside a correct program; in an MoE cell
    the routing look finds the f32 program routing as the reference does."""
    r = harness.run_cell(cell, 2**31 + 78, 1.0, False, time.perf_counter(),
                         device="cpu", control=True,
                         conf_override=tiny_conf("mixtral" in cell),
                         **tiny_overrides(cell))
    look = r["notes"]["gaps"]
    assert r["correct"] is True and look["control_correct"] is False
    assert any(c["value"] > c["limit"]
               for c in look["control_compared"].values())
    if "mixtral" in cell:
        assert look["routing"]["flip_share"] == 0.0
        assert look["routing"]["forced"] == look["routing"]["free"]


def _optimizer_unapplied(monkeypatch):
    from tpusched_torch import optim
    monkeypatch.setattr(optim.AdamW, "apply_", lambda *a, **k: None)


def _half_batch(monkeypatch):
    from tpusched_torch import workload
    real = workload.TrainShardings.local
    monkeypatch.setattr(workload.TrainShardings, "local",
                        lambda self, t: real(self, t)[: t.shape[0] // 2])


@pytest.mark.parametrize("fault,number", [
    (_optimizer_unapplied, "change_norm_gap"),
    (_half_batch, "grad_norm_gap")], ids=["state_unchanged", "half_batch"])
def test_planted_train_fault_is_not_correct(fault, number, monkeypatch):
    fault(monkeypatch)
    r = tiny_run("mistral-7b.train-4k")
    assert r["correct"] is False
    assert r["compared"][number]["value"] > r["compared"][number]["limit"]


def test_new_cell_from_files_alone(tmp_path):
    """A configuration, a traffic mix, a cell and a per-layer metric added
    as new files and entries, no existing file of the benchmark edited."""
    root = tmp_path / "checkout"
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    b = root / "benchmark"
    conf = json.loads((b / "configs" / "mistral-7b.json").read_text())
    conf["num_hidden_layers"] = 3
    (b / "configs" / "dummy.json").write_text(json.dumps(conf))
    mix = json.loads((b / "traffic" / "chat.json").read_text())
    mix["why"] = "a dummy mix"
    (b / "traffic" / "dummy-mix.json").write_text(json.dumps(mix))
    (b / "cells" / "dummy.dummy-mix.json").write_text(json.dumps(TINY_CELL))
    (b / "metrics" / "ticks.dummy.py").write_text(
        'def read(records):\n    return len(records["ticks"]) or None\n')
    spec["configs"].append({"name": "dummy", "source": "https://example.org",
                            "file": "benchmark/configs/dummy.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "dummy.dummy-mix", "config": "dummy",
                              "traffic": "dummy-mix", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"]:
        if "ttft_p95_s" == m["name"] or "itl_p95_s" == m["name"]:
            m["workloads"].append("dummy.dummy-mix")
    spec["per_layer"].append({"name": "ticks.dummy", "unit": "ticks",
                              "better": "higher", "source": "program_counter",
                              "layer": "serve", "moves": "ttft_p95_s",
                              "workloads": ["dummy.dummy-mix"]})
    # a variant with no file of its own is read by its quantity's reader
    spec["per_layer"].append({"name": "decode_tick_ms.dummy", "unit": "ms",
                              "better": "lower", "source": "host_clock",
                              "layer": "serve", "moves": "itl_p95_s",
                              "workloads": ["dummy.dummy-mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    r = harness.run_cell("dummy.dummy-mix", 9, 1.0, True, time.perf_counter(),
                         device="cpu", root=root,
                         conf_override=dict(tiny_conf(), num_hidden_layers=3),
                         cell_override=TINY_CELL, mix_override=TINY_MIX)
    assert r["correct"] is True
    assert r["metrics"]["ticks.dummy"]["value"] > 0
    assert not (b / "metrics" / "decode_tick_ms.dummy.py").exists()
    assert r["metrics"]["decode_tick_ms.dummy"]["value"] > 0
    r0 = tiny_run("mistral-7b.chat", root=root)
    assert set(r0["metrics"]) == {"ttft_p95_s", "itl_p95_s", "setup_s"}


def test_command_without_a_card_prints_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "mistral-7b.chat", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""


def test_bare_checkout_prints_no_result(tmp_path):
    """Only BENCHMARK.json and the benchmark's files: the program is
    missing, so the run fails before any result."""
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    code = ("import time, sys; from benchmark import harness; "
            "harness.run_cell('mistral-7b.chat', 1, 1.0, False, "
            "time.perf_counter(), device='cpu')")
    p = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
    assert "tpusched_torch" in p.stderr
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        "mistral-7b.chat", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout == ""
