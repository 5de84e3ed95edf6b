"""The PyTorch port stands alone: no module of tpusched_torch (mesh.py
included), and not chip_smoke.py, imports JAX, optax, orbax or anything of
the tpusched package (the machine with the card has none of them); the
programs (``program``, and their chains over a mesh), the serving,
speculative, tensor-parallel, fsdp×sp, expert-parallel and pipelined
paths, the checkpoints, the token stream, the budget, the
goodput reporter and the runner of the reference's on-chip lines
(``tpusched_torch.bench``) run with all of them refused."""
from __future__ import annotations

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "tpusched_torch"
MODULES = sorted(p.stem for p in PACKAGE.glob("*.py") if p.stem != "__init__")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top.startswith("jax") or top in ("tpusched", "optax", "orbax")


def test_every_module_imports_without_jax_or_tpusched():
    prog = (
        "import importlib, sys\n"
        f"for m in {['tpusched_torch'] + ['tpusched_torch.' + m for m in MODULES]!r}:\n"
        "    importlib.import_module(m)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('tpusched', 'optax', 'orbax') or m.split('.')[0].startswith('jax')))\n")
    r = subprocess.run([sys.executable, "-c", prog], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_serving_paths_run_with_jax_unimportable():
    """With jax, optax and tpusched refused at import, the engine serves on
    the CPU through chunked prefill with a registered prefix and through an
    int8 arena, and measure_serving_slo runs."""
    prog = (
        "import importlib.abc, sys\n"
        "class Refuse(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        top = name.split('.')[0]\n"
        "        if top.startswith('jax') or top in ('tpusched', 'optax'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "import dataclasses, numpy as np, torch\n"
        "from tpusched_torch import serve, workload as wl\n"
        "cfg = wl.ModelConfig.tiny()\n"
        "p = wl.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
        "reqs = [serve.Request(rid=i, prompt=np.arange(3 + i, dtype=np.int32),"
        " max_new_tokens=3) for i in range(3)]\n"
        "eng = serve.ServeEngine(p, cfg, slots=2, max_seq=32, prompt_bucket=8,"
        " chunk_prefill=4, device='cpu')\n"
        "eng.register_prefix('sys', np.arange(5, dtype=np.int32))\n"
        "for r in reqs:\n"
        "    eng.submit(dataclasses.replace(r, prefix_id='sys'))\n"
        "assert len(eng.run_until_drained()) == 3\n"
        "i8 = dataclasses.replace(cfg, kv_cache_dtype='int8')\n"
        "eng = serve.ServeEngine(p, i8, slots=2, max_seq=32, prompt_bucket=8,"
        " device='cpu')\n"
        "for r in reqs:\n"
        "    eng.submit(r)\n"
        "assert len(eng.run_until_drained()) == 3\n"
        "out = serve.measure_serving_slo(cfg, p, reqs, [0, 1, 2], slots=2,"
        " max_seq=32, prompt_bucket=8, chunk_prefill=4, device='cpu')\n"
        "assert out['tokens'] == 9.0\n"
        "print('served')\n")
    r = subprocess.run([sys.executable, "-c", prog], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "served"


def test_programs_run_with_jax_unimportable():
    """With jax, optax and tpusched refused at import, greedy ``generate``
    replays its step program and an engine warms and runs its programs on
    the CPU."""
    prog = (
        "import importlib.abc, sys\n"
        "class Refuse(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        top = name.split('.')[0]\n"
        "        if top.startswith('jax') or top in ('tpusched', 'optax'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "import numpy as np, torch\n"
        "from tpusched_torch import decode, program, serve, workload as wl\n"
        "cfg = wl.ModelConfig.tiny()\n"
        "p = wl.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
        "out = decode.generate(p, torch.arange(4)[None], cfg, steps=3)\n"
        "assert out.shape == (1, 4)\n"
        "eng = serve.ServeEngine(p, cfg, slots=2, max_seq=32, prompt_bucket=8,"
        " device='cpu')\n"
        "eng.warmup()\n"
        "assert all(isinstance(x, program.Program)"
        " for x in eng._programs.values())\n"
        "eng.submit(serve.Request(rid=0, prompt=np.arange(5, dtype=np.int32),"
        " max_new_tokens=3))\n"
        "assert len(eng.run_until_drained()) == 1\n"
        "print('programs')\n")
    r = subprocess.run([sys.executable, "-c", prog], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "programs"


def test_speculative_paths_run_with_jax_unimportable():
    """With jax, optax and tpusched refused at import, solo greedy and
    sampled speculation, the keyed sampler, and greedy, request-keyed and
    sampled speculative serving run on the CPU."""
    prog = (
        "import importlib.abc, sys\n"
        "class Refuse(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        top = name.split('.')[0]\n"
        "        if top.startswith('jax') or top in ('tpusched', 'optax'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "import dataclasses, numpy as np, torch\n"
        "from tpusched_torch import decode, serve, spec_decode, workload as wl\n"
        "cfg = wl.ModelConfig.tiny()\n"
        "p = wl.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
        "d = dataclasses.replace(cfg, n_layers=1)\n"
        "dp = {**p, 'layers': p['layers'][:1]}\n"
        "prompt = torch.arange(5)[None]\n"
        "toks, st = spec_decode.speculative_generate(p, cfg, dp, d, prompt, 6,"
        " k=3)\n"
        "assert toks.shape == (1, 7) and st['plain_calls'] == 7\n"
        "toks, st = spec_decode.speculative_sample(p, cfg, dp, d, prompt, 6, 9,"
        " k=3, temperature=0.8)\n"
        "assert toks.shape == (1, 7)\n"
        "assert decode.sample_position_keyed(p, prompt, cfg, 6, 9).shape == "
        "(1, 7)\n"
        "reqs = [serve.Request(rid=i, prompt=np.arange(3 + i, dtype=np.int32),"
        " max_new_tokens=4) for i in range(3)]\n"
        "for kw in (dict(), dict(temperature=0.8, request_keyed=True)):\n"
        "    for draft in (dict(), dict(draft_params=dp, draft_cfg=d,"
        " spec_k=3)):\n"
        "        eng = serve.ServeEngine(p, cfg, slots=2, max_seq=32,"
        " prompt_bucket=8, device='cpu', **kw, **draft)\n"
        "        for r in reqs:\n"
        "            eng.submit(r)\n"
        "        assert len(eng.run_until_drained()) == 3\n"
        "out = serve.measure_serving(cfg, p, reqs, slots=2, max_seq=32,"
        " prompt_bucket=8, draft_params=dp, draft_cfg=d, spec_k=3,"
        " device='cpu')\n"
        "assert out['tokens'] == 12.0 and out['spec_rounds'] > 0\n"
        "print('speculated')\n")
    r = subprocess.run([sys.executable, "-c", prog], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "speculated"


REFUSE = (
    "import importlib.abc, sys\n"
    "class Refuse(importlib.abc.MetaPathFinder):\n"
    "    def find_spec(self, name, path=None, target=None):\n"
    "        top = name.split('.')[0]\n"
    "        if top.startswith('jax') or top in ('tpusched', 'optax'):\n"
    "            raise ImportError(name)\n"
    "sys.meta_path.insert(0, Refuse())\n")

RANKS = REFUSE + (
    "import numpy as np, torch\n"
    "from tpusched_torch import optim, serve, workload as wl\n"
    "def rank(mesh):\n"
    "    torch.set_num_threads(1)\n"
    "    cfg = wl.ModelConfig.tiny()\n"
    "    p = wl.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
    "    eng = serve.ServeEngine(p, cfg, slots=2, max_seq=32,"
    " prompt_bucket=8, mesh=mesh, device='cpu')\n"
    "    for i in range(3):\n"
    "        eng.submit(serve.Request(rid=i, prompt=np.arange(3 + i,"
    " dtype=np.int32), max_new_tokens=3))\n"
    "    done = {c.rid: c.tokens.tolist() for c in eng.run_until_drained()}\n"
    "    step, init_opt, _, _ = wl.make_optax_train_step(mesh, cfg,"
    " optim.adamw(1e-3))\n"
    "    shards = wl.shard_params(p, cfg, mesh)\n"
    "    toks = torch.arange(2 * cfg.seq).reshape(2, cfg.seq) % cfg.vocab\n"
    "    _, _, loss = step(shards, init_opt(shards), toks)\n"
    "    bad = sorted(m for m in sys.modules if m.split('.')[0] in"
    " ('tpusched', 'optax') or m.split('.')[0].startswith('jax'))\n"
    "    return done, float(loss), bad\n"
    "def fsdp_sp_rank(mesh):\n"
    "    torch.set_num_threads(1)\n"
    "    import dataclasses\n"
    "    out = []\n"
    "    for attn in ('ring', 'ringflash'):\n"
    "        cfg = dataclasses.replace(wl.ModelConfig.tiny(), attn=attn,"
    " remat=True)\n"
    "        p = wl.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
    "        step, init_opt, _, _ = wl.make_optax_train_step(mesh, cfg,"
    " optim.adamw(1e-3))\n"
    "        shards = wl.shard_params(p, cfg, mesh)\n"
    "        toks = torch.arange(2 * cfg.seq).reshape(2, cfg.seq) % cfg.vocab\n"
    "        out.append(float(step(shards, init_opt(shards), toks)[2]))\n"
    "    bad = sorted(m for m in sys.modules if m.split('.')[0] in"
    " ('tpusched', 'optax') or m.split('.')[0].startswith('jax'))\n"
    "    return out, bad\n"
    "def ep_pp_rank(mesh):\n"
    "    torch.set_num_threads(1)\n"
    "    import dataclasses\n"
    "    from tpusched_torch import mesh as tmesh, pipeline\n"
    "    cfg = dataclasses.replace(wl.ModelConfig.tiny(), n_experts=4,"
    " n_layers=4)\n"
    "    p = wl.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
    "    toks = torch.arange(4 * cfg.seq).reshape(4, cfg.seq) % cfg.vocab\n"
    "    step, _, _ = wl.make_sharded_train_step(mesh, cfg)\n"
    "    out = [float(step(wl.shard_params(p, cfg, mesh), toks)[1])]\n"
    "    ep = tmesh.build_named_mesh({'ep': 2, 'tp': 2}, 'gloo', 'cpu')\n"
    "    eng = serve.ServeEngine(p, cfg, slots=2, max_seq=32,"
    " prompt_bucket=8, mesh=ep, device='cpu')\n"
    "    eng.submit(serve.Request(rid=0, prompt=np.arange(5, dtype=np.int32),"
    " max_new_tokens=3))\n"
    "    out.append(eng.run_until_drained()[0].tokens.tolist())\n"
    "    pp = tmesh.build_named_mesh({'pp': 2, 'ep': 2}, 'gloo', 'cpu')\n"
    "    step, _, _ = pipeline.make_pipeline_train_step(pp, cfg, 2)\n"
    "    whole = (pipeline.stack_layers(p), p['embed'], p['out'], p['ln_f'])\n"
    "    shards = pipeline.shard_pipeline_params(whole, cfg, pp)\n"
    "    out.append(float(step(shards, toks)[1]))\n"
    "    bad = sorted(m for m in sys.modules if m.split('.')[0] in"
    " ('tpusched', 'optax') or m.split('.')[0].startswith('jax'))\n"
    "    return out, bad\n"
    "class Graph:\n"
    "    def __init__(self, log): self.log = log\n"
    "    def register_generator_state(self, gen): pass\n"
    "    def capture_begin(self, pool=None, capture_error_mode=None):"
    " self.log.append('begin')\n"
    "    def capture_end(self): self.log.append('end')\n"
    "    def pool(self): return 'pool'\n"
    "    def replay(self): self.log.append('replay')\n"
    "class Recorder:\n"
    "    def __init__(self): self.log = []\n"
    "    def side_stream(self): return None\n"
    "    def on(self, stream):\n"
    "        import contextlib\n"
    "        return contextlib.nullcontext()\n"
    "    def prepare(self): pass\n"
    "    def graph(self): return Graph(self.log)\n"
    "    def join(self, stream): pass\n"
    "def chain_rank(mesh):\n"
    "    torch.set_num_threads(1)\n"
    "    from tpusched_torch import decode, program\n"
    "    cfg = wl.ModelConfig.tiny()\n"
    "    p = wl.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
    "    eng = serve.ServeEngine(p, cfg, slots=2, max_seq=32,"
    " prompt_bucket=8, mesh=mesh, device='cpu')\n"
    "    tick = serve._build_decode_tick(eng._weights, eng.cache, cfg, 2,"
    " (eng._tp, None, None), lambda body, inputs: program.Program(body,"
    " inputs, graphed=True))\n"
    "    real, program._cuda = program._cuda, Recorder()\n"
    "    try:\n"
    "        for _ in range(2):\n"
    "            tick(tokens=np.array([1, 2]), pos=np.array([3, 4]))\n"
    "        log = program._cuda.log\n"
    "    finally:\n"
    "        program._cuda = real\n"
    "    shards = wl.shard_params(p, cfg, mesh)\n"
    "    prompt = torch.arange(8).reshape(2, 4)\n"
    "    toks = [decode.generate(shards, prompt, cfg, 3, tp=mesh.tp).tolist(),"
    " decode.sample(shards, prompt, cfg, 3, torch.Generator().manual_seed(1),"
    " 0.8, tp=mesh.tp).tolist()]\n"
    "    bad = sorted(m for m in sys.modules if m.split('.')[0] in"
    " ('tpusched', 'optax') or m.split('.')[0].startswith('jax'))\n"
    "    return len(tick.segments), tick.breaks_run, log.count('replay'),"
    " toks, bad\n"
    "def train_chain_rank(mesh):\n"
    "    torch.set_num_threads(1)\n"
    "    import dataclasses\n"
    "    from tpusched_torch import pipeline, program\n"
    "    cfg = dataclasses.replace(wl.ModelConfig.tiny(), n_layers=4)\n"
    "    p = wl.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
    "    step, _, _ = pipeline.make_pipeline_train_step(mesh, cfg, 2)\n"
    "    build = step._programs.build\n"
    "    step._programs.build = lambda *a, graphed: build(*a, graphed=True)\n"
    "    whole = (pipeline.stack_layers(p), p['embed'], p['out'], p['ln_f'])\n"
    "    shards = pipeline.shard_pipeline_params(whole, cfg, mesh)\n"
    "    toks = torch.arange(4 * cfg.seq).reshape(4, cfg.seq) % cfg.vocab\n"
    "    real, program._cuda = program._cuda, Recorder()\n"
    "    try:\n"
    "        for _ in range(2):\n"
    "            step(shards, toks)\n"
    "        log = program._cuda.log\n"
    "    finally:\n"
    "        program._cuda = real\n"
    "    prog = step._programs.programs\n"
    "    bad = sorted(m for m in sys.modules if m.split('.')[0] in"
    " ('tpusched', 'optax') or m.split('.')[0].startswith('jax'))\n"
    "    return (mesh.pp.index, [b.kind for b in prog.breaks],"
    " len(prog.segments), prog.breaks_run, log.count('replay'), bad)\n")


def test_tp_paths_run_with_jax_unimportable(tmp_path):
    """With jax, optax and tpusched refused at import in the launcher and
    in each rank (the ranks' module refuses them before it imports the
    port), two gloo ranks serve a tiny model at tp = 2 and take an AdamW
    step on a tp mesh; no rank has loaded any of them."""
    (tmp_path / "refusing_ranks.py").write_text(RANKS)
    prog = REFUSE + (
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        "import refusing_ranks\n"
        "from tpusched_torch import mesh\n"
        "out = mesh.launch(refusing_ranks.rank, {'tp': 2}, backend='gloo',"
        f" device='cpu', workdir={str(tmp_path)!r})\n"
        "assert out[0] == out[1], out\n"
        "assert len(out[0][0]) == 3 and out[0][2] == [], out\n"
        "print('sharded')\n")
    r = subprocess.run([sys.executable, "-c", prog], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "sharded"


def test_mesh_program_chains_run_with_jax_unimportable(tmp_path):
    """As above, two gloo ranks capture a tiny tp = 2 decode tick as a
    chain of graphs broken at its 6 collectives (a recorder standing in
    for CUDA through ``program._cuda``) and call it twice, then run
    ``generate(tp=)`` and ``sample(tp=)`` through their step programs; the
    ranks agree and none has loaded JAX, optax or tpusched."""
    (tmp_path / "refusing_ranks.py").write_text(RANKS)
    prog = REFUSE + (
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        "import refusing_ranks\n"
        "from tpusched_torch import mesh\n"
        "out = mesh.launch(refusing_ranks.chain_rank, {'tp': 2},"
        f" backend='gloo', device='cpu', workdir={str(tmp_path)!r})\n"
        "assert out[0] == out[1], out\n"
        "assert out[0][:3] == (7, 12, 14) and out[0][4] == [], out\n"
        "print('chained')\n")
    r = subprocess.run([sys.executable, "-c", prog], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "chained"


def test_mesh_train_chain_runs_with_jax_unimportable(tmp_path):
    """As above, two gloo ranks capture the GPipe step on {"pp": 2} as a
    chain of graphs (a recorder standing in for CUDA) broken at its
    hand-offs, the sends' waits and its two collectives, and call it
    twice; none has loaded JAX, optax or tpusched."""
    (tmp_path / "refusing_ranks.py").write_text(RANKS)
    prog = REFUSE + (
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        "import refusing_ranks\n"
        "from tpusched_torch import mesh\n"
        "out = mesh.launch(refusing_ranks.train_chain_rank, {'pp': 2},"
        f" backend='gloo', device='cpu', workdir={str(tmp_path)!r})\n"
        "tail = ['wait', 'wait', 'all_reduce', 'broadcast']\n"
        "assert out[0][1] == ['send', 'send', 'recv', 'recv'] + tail, out\n"
        "assert out[1][1] == ['recv', 'recv', 'send', 'send'] + tail, out\n"
        "assert all(o[2:] == (9, 8, 9, []) for o in out), out\n"
        "print('trained')\n")
    r = subprocess.run([sys.executable, "-c", prog], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "trained"


def test_fsdp_sp_paths_run_with_jax_unimportable(tmp_path):
    """As above, four gloo ranks on {"fsdp": 2, "sp": 2} take an AdamW step
    with the ring and with ring-flash attention (remat on); the ranks agree
    on the losses and none has loaded JAX, optax or tpusched."""
    (tmp_path / "refusing_ranks.py").write_text(RANKS)
    prog = REFUSE + (
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        "import refusing_ranks\n"
        "from tpusched_torch import mesh\n"
        "out = mesh.launch(refusing_ranks.fsdp_sp_rank, {'fsdp': 2, 'sp': 2},"
        f" backend='gloo', device='cpu', workdir={str(tmp_path)!r})\n"
        "assert all(o == out[0] for o in out) and out[0][1] == [], out\n"
        "assert abs(out[0][0][0] - out[0][0][1]) < 1e-5, out\n"
        "print('sequence-parallel')\n")
    r = subprocess.run([sys.executable, "-c", prog], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "sequence-parallel"


def _imports(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", [ROOT / "chip_smoke.py"]
                         + sorted(PACKAGE.glob("*.py")),
                         ids=lambda p: p.name)
def test_source_names_no_jax_or_tpusched_import(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"


def test_chip_smoke_imports_the_port():
    assert any(m.split(".")[0] == "tpusched_torch"
               for m in _imports(ROOT / "chip_smoke.py"))


def test_ep_pp_paths_run_with_jax_unimportable(tmp_path):
    """As above, four gloo ranks take an MoE SGD step on {"dp": 2, "ep":
    2}, serve an MoE model on {"ep": 2, "tp": 2} and take a pipelined MoE
    step on {"pp": 2, "ep": 2}; the ranks agree and none has loaded JAX,
    optax or tpusched."""
    (tmp_path / "refusing_ranks.py").write_text(RANKS)
    prog = REFUSE + (
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        "import refusing_ranks\n"
        "from tpusched_torch import mesh\n"
        "out = mesh.launch(refusing_ranks.ep_pp_rank, {'dp': 2, 'ep': 2},"
        f" backend='gloo', device='cpu', workdir={str(tmp_path)!r})\n"
        "assert all(o == out[0] for o in out) and out[0][1] == [], out\n"
        "assert len(out[0][0][1]) == 3, out\n"
        "print('expert-parallel and pipelined')\n")
    r = subprocess.run([sys.executable, "-c", prog], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == ("expert-parallel and "
                                                 "pipelined")


REFUSE_ORBAX = REFUSE.replace("('tpusched', 'optax')",
                              "('tpusched', 'optax', 'orbax')")
LOADED = ("sorted(m for m in sys.modules if m.split('.')[0] in ('tpusched',"
          " 'optax', 'orbax') or m.split('.')[0].startswith('jax'))")

CHECKPOINT_RANKS = REFUSE_ORBAX + (
    "import torch\n"
    "from tpusched_torch import checkpoint, mesh as tmesh, optim\n"
    "from tpusched_torch import workload as wl\n"
    "def rank(mesh, directory):\n"
    "    torch.set_num_threads(1)\n"
    "    cfg = wl.ModelConfig.tiny()\n"
    "    p = wl.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
    "    specs = wl.param_specs(cfg, mesh)\n"
    "    checkpoint.save(directory, wl.shard_params(p, cfg, mesh), 1,"
    " mesh=mesh, specs=specs)\n"
    "    dp = tmesh.build_named_mesh({'dp': 2}, 'gloo', 'cpu')\n"
    "    got, step = checkpoint.restore(directory, checkpoint.abstract_state("
    "checkpoint.param_skeleton(cfg), wl.param_specs(cfg, dp), dp), mesh=dp)\n"
    "    same = all(torch.equal(a, b) for a, b in zip(wl.tree_leaves(got),"
    " wl.tree_leaves(p)))\n"
    f"    return step, same, {LOADED}\n")


def test_checkpoint_data_budget_run_with_jax_unimportable(tmp_path):
    """With jax, optax, orbax and tpusched refused at import: a checkpoint
    with AdamW state saved and restored in one process, a serving snapshot
    exported and loaded, the token stream, the budget, the goodput reporter
    and calibrate; then two gloo ranks save on {"tp": 2} and restore onto
    {"dp": 2} (whole leaves, equal to the saved weights). Nothing refused
    is loaded anywhere."""
    (tmp_path / "ckpt_ranks.py").write_text(CHECKPOINT_RANKS)
    prog = REFUSE_ORBAX + (
        f"sys.path.insert(0, {str(tmp_path)!r})\n"
        "import itertools, torch\n"
        "from tpusched_torch import budget, checkpoint, data, measure, mesh,"
        " optim, workload as wl\n"
        "import ckpt_ranks\n"
        "cfg = wl.ModelConfig.tiny()\n"
        "p = wl.init_params(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
        "tx = optim.adamw(1e-3)\n"
        "st = tx.init(p)\n"
        f"d = {str(tmp_path / 'one')!r}\n"
        "checkpoint.save(d, p, 4, extra=st)\n"
        "got, step, ex = checkpoint.restore(d, checkpoint.abstract_state("
        "checkpoint.param_skeleton(cfg)), device='cpu',"
        " abstract_extra=checkpoint.abstract_like(tx.init(p)))\n"
        "assert step == 4 and ex.count == 0\n"
        "checkpoint.export_for_serving(d, p, cfg, step=4)\n"
        "assert checkpoint.load_for_serving(d, cfg, device='cpu')['embed']"
        ".equal(p['embed'])\n"
        "b = list(itertools.islice(data.TokenBatcher(cfg, 2, device='cpu'),"
        " 2))\n"
        "assert b[0].shape == (2, cfg.seq)\n"
        "assert budget.train_hbm_breakdown(cfg, 1, accelerator='h100-80gb')"
        ".fits\n"
        "class C:\n"
        "    def report_status(self, r):\n"
        "        self.r = r\n"
        "rep = measure.GoodputReporter(C(), 'default/x-0')\n"
        "rep.observe_step(1, 0.5, items=10)\n"
        "assert rep.flush()\n"
        "assert measure.calibrate(n=32, k1=2, k2=8, device='cpu') != 0\n"
        "out = mesh.launch(ckpt_ranks.rank, {'tp': 2},"
        f" {str(tmp_path / 'two')!r}, backend='gloo', device='cpu',"
        f" workdir={str(tmp_path)!r})\n"
        "assert out == [(1, True, [])] * 2, out\n"
        f"assert {LOADED} == [], {LOADED}\n"
        "print('checkpointed')\n")
    r = subprocess.run([sys.executable, "-c", prog], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "checkpointed"


def test_entry_points_run_with_jax_unimportable(tmp_path):
    """With jax, optax, orbax and tpusched refused at import,
    ``tpusched_torch.entry``'s command line on 2 gloo CPU ranks prints the
    forward's shape and the dense, tp-serve, tp-speculative, tp-int8kv and
    hand-off lines, each OK, and has loaded none of them."""
    prog = REFUSE_ORBAX + (
        "from tpusched_torch import entry\n"
        "assert entry.main(['--device', 'cpu', '--backend', 'gloo', '2']) "
        "== 0\n"
        f"print({LOADED})\n")
    r = subprocess.run([sys.executable, "-c", prog], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "TMPDIR": str(tmp_path),
                            "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert lines[0] == "entry forward: (4, 128, 2048)"
    assert [line.split(": ")[1].split(" ")[0] for line in lines[1:-1]] == [
        "dense", "tp-serve", "tp-speculative", "tp-int8kv",
        "train→export→serve"]
    assert all(line.endswith("OK") for line in lines[1:-1])
    assert lines[-1] == "[]"


def test_bench_command_line_runs_with_jax_unimportable():
    """With jax, optax, orbax and tpusched refused at import, the runner's
    command line (``tpusched_torch.bench.main``, ``--device cpu``) runs its
    line groups on the CPU at the tests' tiny sizes, each line a JSON
    object with the reference's ``emit`` keys first, and has loaded none
    of them."""
    prog = REFUSE_ORBAX + (
        "import functools\n"
        "from tpusched_torch import bench\n"
        "bench.context = functools.partial(bench.context, tiny=True)\n"
        "assert bench.main(['--device', 'cpu', '--lines',"
        " 'adamw_xl,decode,spec_solo,slo']) == 0\n"
        f"print({LOADED})\n")
    r = subprocess.run([sys.executable, "-c", prog], cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert lines[-1] == "[]"
    recs = [json.loads(line) for line in lines[:-1]]
    assert [rec["line"] for rec in recs] == [
        "adamw_xl", "decode", "spec_solo", "slo", "slo"]
    assert all(list(rec)[:4] == ["metric", "value", "unit", "vs_baseline"]
               for rec in recs)
