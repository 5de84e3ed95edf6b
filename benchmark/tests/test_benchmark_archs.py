"""Architectures found by a configuration's ``model_type``: the two that the
cells run give, number for number and bit for bit, what the harness gave
before its architecture-specific parts moved into ``archs/`` and
``reference/<model_type>.py`` (the constants below were computed with that
harness); a new architecture joins as new files alone; layers may differ;
and no other module of the benchmark reads a key that describes the block.
"""
import ast
import hashlib
import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import flops, model
from benchmark.harness import Bench
from benchmark.reference import model as ref
from benchmark.tests.conftest import TINY, TINY_CELL, TINY_MIX
from benchmark.trace import Trace

REPO = pathlib.Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"
CTX64 = [(37 * i * i + 11 * i) % 3000 for i in range(64)]
CONTEXTS = {"mistral-7b": CTX64, "mixtral-8x7b": CTX64[:48]}
BLOCK_KEYS = ("hidden_size", "intermediate_size", "head_dim",
              "num_attention_heads", "num_key_value_heads",
              "num_local_experts", "num_experts_per_tok", "rms_norm_eps",
              "rope_theta")
GOLDEN = {
    "mistral-7b": {
        "prefill": [14221312000, 3590921912320, 29687612964864],
        "decode_flops": 954153828352, "decode_bytes": 25227698176,
        "train": 187942400163840},
    "mixtral-8x7b": {
        "prefill": [12879921152, 3238969475072, 26390957129728],
        "decode_flops": 634501726208, "decode_bytes": 50773762048,
        "train": 164863930269696, "decode_bytes_routed": 31043756032},
}
# (operations, bytes) of K1 at the buckets 256-2048, and of K1, K2, K3 at
# the train cell's (1, 4096): the same in both configurations
K1_BUCKETS = [[538968064, 5275648], [2151677952, 10551296],
              [8598323200, 21102592], [34376515584, 42205184]]
TRAIN_FLASH = [[137472507904, 84410368], [274945015808, 101711872],
               [206208761856, 118489088]]
READINGS = {
    "mistral-7b": {"k1_roofline": 5.717723027884036,
                   "admit_mfu": 14.205803638524825,
                   "decode_hbm_roofline": 10.040874895920396,
                   "mfu": 54.295074437047525,
                   "flash_roofline": 16.663216776697308},
    "mixtral-8x7b": {"k1_roofline": 6.00768679474979,
                     "admit_mfu": 12.58767358746634,
                     "decode_hbm_roofline": 20.208462506666663,
                     "mfu": 47.627886832210315,
                     "flash_roofline": 17.019331828024846},
}
WEIGHTS = {
    ("dense", "float32"):
        "75778f7f4b171b5ecf014f139d0ffeeac0c544874203f08790054ca5e22eefaf",
    ("dense", "bfloat16"):
        "44ca880365b5ddbf2bfaad7966c6664bb1aaa4734a6a0f9db2f5febd2dd2b598",
    ("moe", "float32"):
        "6cf07f9cae954aa2d68188d727a1e5359ac1e12f9093c590e479ebbd9c89c339",
    ("moe", "bfloat16"):
        "abdace0b86aab32b3d1e6c8188d8638ea6e14e3ec033a0acdb369e492c87f93d",
}
LOGITS = {
    ("dense", None):
        "6182ef396da101f62c918e960574cbdd1f0987fce18aa4a95a5a3ed219b9fc5f",
    ("dense", "fp8"):
        "67d444d1a902addf74a61621ec537e09d332905e573785f139f6af59dd3ea050",
    ("moe", None):
        "e4b0cb5a0d380a59d60069d9c943e5499c00247156c2e144bc82d21597a09522",
    ("moe", "fp8"):
        "ac715f77c094d568355a4d2930ca45dab952ed4fda07e6445ea085303fac792e",
}


def _tiny(kind: str, dtype: str = "float32") -> dict:
    conf = model.load_config("mixtral-8x7b" if kind == "moe"
                             else "mistral-7b")
    return dict(conf, **dict(TINY, torch_dtype=dtype),
                **({"num_local_experts": 4} if kind == "moe" else {}))


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_counts_equal_the_golden_numbers(name):
    conf = model.load_config(name)
    c = model.arch(conf).counts(conf)
    g, ctx = GOLDEN[name], CONTEXTS[name]
    assert [flops.prefill_flops(c, n) for n in (1, 256, 2048)] == g["prefill"]
    assert flops.decode_flops(c, ctx) == g["decode_flops"]
    assert flops.decode_bytes(c, ctx) == g["decode_bytes"]
    assert flops.train_step_flops(c, 1, 4096) == g["train"]
    assert len(c.flash_layers) == conf["num_hidden_layers"]
    for layer in c.flash_layers:
        assert [list(c.flash_call("K1", layer, 1, s))
                for s in (256, 512, 1024, 2048)] == K1_BUCKETS
        assert [list(c.flash_call(k, layer, 1, 4096))
                for k in ("K1", "K2", "K3")] == TRAIN_FLASH
    if "decode_bytes_routed" in g:
        routed = [(i % 8) + 1 for i in range(len(c.layers))]
        assert (flops.decode_bytes(c, ctx, experts_routed=routed)
                == g["decode_bytes_routed"])


def _synthetic_trace(tmp_path, n_layers: int) -> Trace:
    """An admit tick of two prefills (one K1 call a layer each), a decode
    tick and a train step (K1 twice a layer under remat, K2 and K3 once)."""
    kern = []
    t = 0.0101
    for i in range(2 * n_layers):
        kern.append(("flash_fwd_sm90", t, t + 0.0003 + 1e-6 * i))
        t += 0.0007
    kern += [("gemm", 0.01, 0.2), ("gemm", 0.31, 0.37), ("gemm", 0.375, 0.39)]
    t = 0.61
    for k, n in (("flash_fwd_sm90", 2 * n_layers),
                 ("flash_bwd_dkdv_sm90", n_layers),
                 ("flash_bwd_dq_sm90", n_layers)):
        for i in range(n):
            kern.append((k, t, t + 0.0011 + 2e-6 * i))
            t += 0.0013
    spans = {"bench.window": (0.0, 1.0), "bench.tick#0": (0.01, 0.25),
             "bench.tick#1": (0.3, 0.4), "bench.step#0": (0.6, 0.95)}
    ev = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a * 1e6,
           "dur": (b - a) * 1e6} for n, (a, b) in spans.items()]
    ev += [{"ph": "X", "cat": "kernel", "name": k, "ts": a * 1e6,
            "dur": (b - a) * 1e6, "args": {}} for k, a, b in kern]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return Trace(str(path))


@pytest.mark.parametrize("name", sorted(READINGS))
def test_readings_equal_the_golden_numbers(name, tmp_path):
    conf = model.load_config(name)
    ctx = CONTEXTS[name]
    records = {
        "conf": conf, "counts": model.arch(conf).counts(conf),
        "peak": flops.peaks("NVIDIA H100 80GB HBM3"), "window": (0.0, 1.0),
        "trace": _synthetic_trace(tmp_path, conf["num_hidden_layers"]),
        "trace_started": None, "e2e": {},
        "ticks": [{"t0": 0.01, "t1": 0.25,
                   "admits": [(300, 512), (1500, 2048)],
                   "contexts": ctx, "traced": True, "idx": 0},
                  {"t0": 0.3, "t1": 0.4, "admits": [], "contexts": ctx,
                   "traced": True, "idx": 1}],
        "steps": [{"t0": 0.6, "t1": 0.95, "idx": 0, "traced": True}],
        "span_s": 0.35, "batch": 1, "seq": 4096}
    bench = Bench(REPO)
    assert {m: bench.reader(m).read(records)
            for m in READINGS[name]} == READINGS[name]


def _tree_hash(w: dict) -> str:
    h = hashlib.sha256()
    leaves = [(("embed",), w["embed"]), (("out",), w["out"]),
              (("ln_f",), w["ln_f"])]
    for i, layer in enumerate(w["layers"]):
        leaves += [(("layers", i, k), v) for k, v in sorted(layer.items())]
    for path, v in leaves:
        h.update(repr((path, tuple(v.shape), str(v.dtype))).encode())
        h.update(v.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("kind,dtype", sorted(WEIGHTS))
def test_weights_equal_the_golden_hashes(kind, dtype, monkeypatch):
    monkeypatch.setattr(model, "CHUNK", 1000)
    w = model.make_weights(_tiny(kind, dtype), 2**31 + 11, "cpu")
    assert _tree_hash(w) == WEIGHTS[(kind, dtype)]


@pytest.mark.parametrize("kind,quant", sorted(LOGITS, key=str),
                         ids=lambda x: str(x))
def test_reference_logits_equal_the_golden_hashes(kind, quant, monkeypatch):
    """One thread: a float32 product's summation order, and so its last
    bit, follows the threads that compute it."""
    monkeypatch.setattr(model, "CHUNK", 1000)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        conf = _tiny(kind)
        w = model.make_weights(conf, 2**31 + 11, "cpu")
        lg = ref.logits(w, conf, torch.arange(40) * 7 % 256, torch.arange(40),
                        quant=quant)
    finally:
        torch.set_num_threads(threads)
    assert hashlib.sha256(lg.numpy().tobytes()).hexdigest() == LOGITS[
        (kind, quant)]


LLAMA_ARCH = '''"""Llama (``model_type`` "llama"): Mistral's layer, which the
port runs as it runs Mistral's."""
from benchmark.archs.mistral import (counts, experts_per_token,  # noqa: F401
                                     leaves, port_config)
'''
LLAMA_REFERENCE = '''"""Llama's layer in the plain reference: Mistral's."""
from .mistral import block, head  # noqa: F401
'''
RUN_NEW_ARCH = '''
import json, pathlib, time
from benchmark import harness, model
from benchmark.tests.conftest import TINY_CELL, TINY_MIX
r = harness.run_cell("toy-llama.chat", 9, 1.0, True, time.perf_counter(),
                     device="cpu", root=pathlib.Path("."),
                     cell_override=TINY_CELL, mix_override=TINY_MIX)
conf = model.load_config("toy-llama")
print(json.dumps({"correct": r["correct"], "metrics": r["metrics"],
                  "arch": model.arch(conf).__file__}))
'''


def test_new_architecture_joins_as_new_files(tmp_path):
    """A copy of the benchmark, given a new ``model_type`` by new files in
    ``archs/``, ``reference/``, ``configs/`` and ``cells/`` and by entries
    appended to BENCHMARK.json, runs its cell to ``correct`` with its
    per-layer readers; run from the copy's root as the command is, so the
    copy's own files are the ones found."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    b = root / "benchmark"
    (b / "archs" / "llama.py").write_text(LLAMA_ARCH)
    (b / "reference" / "llama.py").write_text(LLAMA_REFERENCE)
    conf = json.loads((b / "configs" / "mistral-7b.json").read_text())
    conf.update(TINY, model_type="llama", num_hidden_layers=3)
    (b / "configs" / "toy-llama.json").write_text(json.dumps(conf))
    (b / "cells" / "toy-llama.chat.json").write_text(json.dumps(TINY_CELL))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "toy-llama",
                            "source": "https://example.org",
                            "file": "benchmark/configs/toy-llama.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "toy-llama.chat", "config": "toy-llama",
                              "traffic": "chat", "chips": 1, "why": "test"})
    readers = ("decode_tick_ms.chat", "admit_tick_ms.chat", "admit_mfu.chat",
               "k1_roofline.chat", "idle_share.chat")
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("ttft_p95_s", "itl_p95_s") + readers:
            m["workloads"].append("toy-llama.chat")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=str(REPO))
    p = subprocess.run([sys.executable, "-c", RUN_NEW_ARCH], cwd=root,
                       env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert pathlib.Path(out["arch"]).resolve() == (b / "archs" / "llama.py")
    # a CPU run has no trace: the host-clock readers read, the others not
    assert out["metrics"]["decode_tick_ms.chat"]["value"] > 0
    assert out["metrics"]["admit_tick_ms.chat"]["value"] > 0
    assert "k1_roofline.chat" not in out["metrics"]
    assert all(p.read_bytes() == data for p, data in before.items())


UNEVEN_ARCH = '''
import torch
from benchmark import flops, model
from benchmark.archs import mistral


def _attention(conf):
    d, dt = conf["hidden_size"], model.dtype_of(conf)
    h, kv, hd = (conf["num_attention_heads"], conf["num_key_value_heads"],
                 conf["head_dim"])
    return {"wq": ((d, h * hd), dt), "wk": ((d, kv * hd), dt),
            "wv": ((d, kv * hd), dt), "wo": ((h * hd, d), dt),
            "ln_attn": ((d,), dt), "ln_mlp": ((d,), dt)}


def _dense(conf, i):
    return i < conf["first_dense"]


def leaves(conf):
    d, dt = conf["hidden_size"], model.dtype_of(conf)

    def layer(i):
        if _dense(conf, i):
            f = conf["dense_size"]
            return dict(_attention(conf), w_gate=((d, f), dt),
                        w_up=((d, f), dt), w_down=((f, d), dt))
        e, f = conf["experts"], conf["expert_size"]
        return dict(_attention(conf), router=((d, e), torch.float32),
                    w_gate=((e, d, f), dt), w_up=((e, d, f), dt),
                    w_down=((e, f, d), dt), shared=((d, f), dt))
    return mistral.decoder_leaves(conf, layer)


def counts(conf):
    d, item = conf["hidden_size"], 4
    h, kv, hd = (conf["num_attention_heads"], conf["num_key_value_heads"],
                 conf["head_dim"])
    attn = 2 * d * h * hd + 2 * d * kv * hd

    def layer(i):
        window = None if i % 2 == 0 else conf["window"]
        if _dense(conf, i):
            mlp = 3 * d * conf["dense_size"]
            return flops.Layer(attn + mlp, 4 * h * hd, window,
                               (attn + 2 * d + mlp) * item, 0, 0,
                               2 * kv * hd * item, (h, kv, hd))
        e, f = conf["experts"], conf["expert_size"]
        return flops.Layer(attn + d * e + (conf["top_k"] * 3 + 1) * d * f,
                           4 * h * hd, window,
                           (attn + 2 * d + d * f) * item + d * e * 4,
                           3 * d * f * item, e, 2 * kv * hd * item,
                           (h, kv, hd))
    return mistral.decoder_counts(conf, layer)


def experts_per_token(conf):
    return conf["top_k"]
'''
UNEVEN = dict(TINY, model_type="uneven", head_dim=32, first_dense=1,
              dense_size=96, experts=4, expert_size=24, top_k=2, window=8,
              num_hidden_layers=3)


@pytest.fixture
def uneven(tmp_path, monkeypatch):
    import importlib.util
    path = tmp_path / "uneven.py"
    path.write_text(UNEVEN_ARCH)
    spec = importlib.util.spec_from_file_location("benchmark.archs.uneven",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setitem(sys.modules, "benchmark.archs.uneven", mod)
    return mod


def test_layers_that_differ_round_trip(uneven, monkeypatch):
    """A leading dense layer, then MoE layers with a leaf more, and
    head_dim 32 at hidden 64 over 4 heads: every leaf made again alone is
    the leaf of the whole tree, in its shape and dtype."""
    monkeypatch.setattr(model, "CHUNK", 1000)
    w = model.make_weights(UNEVEN, 2**40 + 3, "cpu")
    assert "router" not in w["layers"][0] and "shared" in w["layers"][1]
    assert w["layers"][0]["w_gate"].shape == (64, 96)
    assert w["layers"][2]["w_down"].shape == (4, 24, 64)
    assert w["layers"][1]["router"].dtype == torch.float32
    assert w["layers"][0]["wq"].shape == (64, 128)
    for leaf in uneven.leaves(UNEVEN):
        t = (w[leaf.path[0]] if len(leaf.path) == 1
             else w["layers"][leaf.path[1]][leaf.path[2]])
        assert t.shape == leaf.shape and t.dtype == leaf.dtype
        assert torch.equal(model.initial_leaf(UNEVEN, 2**40 + 3, leaf.path,
                                              "cpu"), t)


def test_layers_that_differ_sum_per_layer(uneven):
    c = uneven.counts(UNEVEN)
    attn = 2 * 64 * 128 + 2 * 64 * 64
    dense, moe = attn + 3 * 64 * 96, attn + 64 * 4 + 7 * 64 * 24
    pair = 4 * 4 * 32
    n = 20
    windowed = 8 * 9 // 2 + (n - 8) * 8
    assert flops.prefill_flops(c, n) == (
        2 * n * (dense + 2 * moe) + pair * (2 * (n * (n + 1) // 2) + windowed)
        + 2 * 64 * 256)
    ctx = [3, 15]
    assert flops.decode_flops(c, ctx) == (
        2 * (2 * (dense + 2 * moe) + 2 * 64 * 256)
        + pair * (2 * (4 + 16) + (4 + 8)))
    assert flops.train_step_flops(c, 2, n) == 3 * 2 * (
        2 * n * (dense + 2 * moe) + pair * (2 * (n * (n + 1) // 2) + windowed)
        + 2 * 64 * 256 * n)
    kv_row = 2 * 2 * 32 * 4
    fixed = (attn + 128) * 4
    static = (64 * 256 + 64) * 4 + 2 * 64 * 4
    expected = (static + fixed + 3 * 64 * 96 * 4
                + 2 * (fixed + 64 * 24 * 4 + 64 * 4 * 4)
                + kv_row * (2 * (4 + 16) + (4 + 8)))
    assert flops.decode_bytes(c, ctx) == expected + 2 * 4 * 3 * 64 * 24 * 4
    assert flops.decode_bytes(c, ctx, experts_routed=[0, 1, 2]) == (
        expected + 3 * 3 * 64 * 24 * 4)
    assert [x.window for x in c.flash_layers] == [None, 8, None]
    ops, _ = c.flash_call("K1", c.layers[1], 1, n)
    assert ops == 4 * windowed * 4 * 32


def _block_keys_read(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    return sorted({n.value for n in ast.walk(tree)
                   if isinstance(n, ast.Constant) and n.value in BLOCK_KEYS})


def test_only_the_architectures_read_the_block():
    """Outside ``archs/`` and ``reference/<model_type>.py``, no module of
    the benchmark names a key that describes the block."""
    arch_names = {p.stem for p in (BENCH / "archs").glob("*.py")}
    assert {"mistral", "mixtral"} <= arch_names
    found = {}
    for p in sorted(BENCH.rglob("*.py")):
        rel = p.relative_to(BENCH)
        if rel.parts[0] in ("archs", "tests") or (
                rel.parts[0] == "reference" and p.stem in arch_names):
            continue
        keys = _block_keys_read(p)
        if keys:
            found[str(rel)] = keys
    assert found == {}
    assert _block_keys_read(BENCH / "archs" / "mistral.py")


def test_refusals_stay_with_the_architecture():
    conf = model.load_config("mixtral-8x7b")
    for key, value in (("rope_theta", 1e6), ("rms_norm_eps", 1e-5),
                       ("hidden_act", "gelu"), ("head_dim", 64)):
        with pytest.raises(ValueError):
            model.arch(conf).port_config(dict(conf, **{key: value}))
