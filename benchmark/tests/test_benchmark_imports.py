"""Nothing the benchmark runs imports JAX, flax or the JAX package
``tpusched`` (top-level names compared whole: ``tpusched_torch`` is not
``tpusched``), and the reference imports nothing of ``tpusched_torch``."""
import json
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[2]

RUN_ALL = r'''
import importlib, importlib.util, json, pathlib, sys, time
sys.path.insert(0, {repo!r})
from benchmark import harness
from benchmark.tests.conftest import tiny_conf, tiny_overrides
root = pathlib.Path({repo!r}) / "benchmark"
for p in sorted(root.rglob("*.py")):
    if "tests" in p.parts:
        continue
    rel = p.relative_to(root.parent).with_suffix("")
    if p.parent.name == "metrics" and p.stem != "__init__":
        spec = importlib.util.spec_from_file_location("m_" + p.stem.replace(".", "_"), p)
        spec.loader.exec_module(importlib.util.module_from_spec(spec))
    else:
        importlib.import_module(".".join(rel.parts).removesuffix(".__init__"))
for cell in [w["name"] for w in harness.Bench(root.parent).spec["workloads"]]:
    for trace in (False, True):
        harness.run_cell(cell, 3, 0.5, trace, time.perf_counter(), device="cpu",
                         conf_override=tiny_conf("mixtral" in cell),
                         **tiny_overrides(cell))
print(json.dumps({{"forbidden": harness.forbidden_modules(),
                  "torch_port": "tpusched_torch" in sys.modules}}))
'''

REFERENCE_ONLY = r'''
import json, sys
sys.path.insert(0, {repo!r})
import benchmark.reference.model, benchmark.reference.judge
import benchmark.reference.mistral, benchmark.reference.mixtral
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}}
                        & {{"jax", "jaxlib", "flax", "tpusched", "tpusched_torch"}})))
'''


def _run(code: str):
    p = subprocess.run([sys.executable, "-c", code.format(repo=str(REPO))],
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_every_module_and_cell_leaves_jax_unloaded():
    out = _run(RUN_ALL)
    assert out == {"forbidden": [], "torch_port": True}


def test_reference_imports_nothing_of_the_port():
    assert _run(REFERENCE_ONLY) == []


def test_forbidden_names_compared_whole(monkeypatch):
    from benchmark import harness
    monkeypatch.setitem(sys.modules, "tpusched_torchx", sys)
    assert "tpusched" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpusched.sub", sys)
    assert harness.forbidden_modules() == ["tpusched"]
