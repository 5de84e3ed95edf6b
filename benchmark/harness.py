"""One run of one cell: the cell's files found by its name, the weights
made from the seed, the driver of its traffic mix run, the served tokens
judged against the plain reference, and the result as one JSON line.

What a cell is made of, each found by name and none edited to add another:
``BENCHMARK.json``'s entry (config, traffic, chips), ``configs/<config>
.json`` and its architecture's two files (its ``model_type`` names
``archs/<model_type>.py`` and ``reference/<model_type>.py``),
``traffic/<mix>.json`` (its ``driver`` names ``drivers/<driver>.py``),
``cells/<cell>.json`` (the engine's geometry, the offered rate, the
limits of the check) and, for each per-layer metric
whose ``workloads`` list the cell, its reader in ``metrics/`` (one a
quantity, shared by the metric's variants; ``Bench.reader``).
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import pathlib
import sys
import time
import types
from typing import Optional

import torch

from . import flops, model

PACKAGE = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpusched")


class Bench:
    """The benchmark as the files under ``root`` describe it."""

    def __init__(self, root: pathlib.Path):
        self.root = pathlib.Path(root)
        self.spec = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "benchmark"

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def data(self, kind: str, name: str) -> dict:
        return json.loads((self.dir / kind / f"{name}.json").read_text())

    def metrics(self, section: str, cell: str):
        """The metrics of ``section`` that ``cell`` reports."""
        return [m for m in self.spec[section]
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, name: str):
        """The reader of metric ``name``: ``metrics/<name>.py``, else the
        reader of its quantity, ``metrics/<name up to its first dot>.py``
        (``admit_tick_ms.chat`` and ``admit_tick_ms.moe`` share one)."""
        path = self.dir / "metrics" / f"{name}.py"
        if not path.exists():
            path = self.dir / "metrics" / f"{name.split('.')[0]}.py"
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{name.replace('.', '_').replace('-', '_')}",
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def forbidden_modules():
    """The loaded modules whose top-level name, whole, is JAX's, flax's or
    the JAX package's (``tpusched_torch`` is not ``tpusched``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _sync(device: torch.device):
    return torch.cuda.synchronize if device.type == "cuda" else (lambda: None)


def _records(out: dict, conf: dict, device_name: Optional[str]) -> dict:
    """What a per-layer metric reads (``readers``): the driver's records
    (``ticks`` of a serving cell, ``steps`` of a train cell) and these."""
    return dict(out.get("records", {}), conf=conf,
                counts=model.arch(conf).counts(conf),
                peak=flops.peaks(device_name) if device_name else None,
                window=out["window"], trace=out["trace"], e2e=out["e2e"])


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device="cuda", root: Optional[pathlib.Path] = None,
             conf_override: Optional[dict] = None,
             cell_override: Optional[dict] = None,
             mix_override: Optional[dict] = None, control: bool = False,
             check: bool = True) -> dict:
    """Run cell ``name`` once and return its result. The overrides
    replace keys of the cell's files (the CPU tests' tiny sizes);
    ``control`` and ``check`` serve ``benchmark.calibrate`` and
    ``benchmark.sweep``."""
    bench = Bench(root or PACKAGE.parent)
    w = bench.workload(name)
    conf = dict(bench.data("configs", w["config"]), **(conf_override or {}))
    mix = dict(bench.data("traffic", w["traffic"]), **(mix_override or {}))
    cell = dict(bench.data("cells", name), **(cell_override or {}))
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    ctx = types.SimpleNamespace(
        conf=conf, cfg=model.arch(conf).port_config(conf), mix=mix,
        cell=cell, seed=seed, seconds=seconds, trace=trace, device=device,
        on_card=on_card, t_start=t_start, sync=_sync(device),
        weights=model.make_weights(conf, seed, device))
    ctx.sync()
    ctx.parts = {"start_to_weights_s": t - t_start,
                 "weights_s": time.perf_counter() - t}
    driver = importlib.import_module(f"benchmark.drivers.{mix['driver']}")
    out = driver.run(ctx)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    if out.get("loop") is not None:
        out["loop"].eng = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    verdict = (driver.check(out, ctx, control) if check
               else {"correct": False, "compared": {}, "stats": {}})
    device_name = torch.cuda.get_device_name(device) if on_card else None
    dev = {"platform": "gpu" if on_card else device.type,
           "kind": device_name or device.type, "count": w["chips"],
           "memory_peak_bytes": peak}
    metrics = {}
    result = {"correct": verdict["correct"], "attempted": out["attempted"],
              "failed": out["failed"]}
    if trace:
        records = _records(out, conf, device_name)
        for m in bench.metrics("per_layer", name):
            value = bench.reader(m["name"]).read(records)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        tr = out["trace"]
        if tr is not None:
            dev["busy_s"] = tr.busy_s
            dev["window_s"] = tr.window_s
            result["breakdown"] = tr.breakdown()
    else:
        e2e = dict(out["e2e"], setup_s=out["setup_s"])
        for m in bench.metrics("end_to_end", name):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = dev
    result["notes"] = dict(out["notes"], **({"gaps": verdict["stats"]}
                                            if verdict.get("stats") else {}))
    result["compared"] = verdict["compared"]
    return result
