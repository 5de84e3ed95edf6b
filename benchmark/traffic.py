"""The one traffic generator: a mix file (``traffic/<mix>.json``) and a
cell file (``cells/<cell>.json``) in, the run's requests out.

Every seed gets the same multiset of prompt lengths, output lengths and
gaps between arrivals: the lengths are the distribution's quantiles at
(i + 0.5) / n, clipped, and the gaps the exponential's quantiles over the
cell's rate. The seed shuffles each, uniformly and on its own, and draws
the prompts' token ids. A uniform shuffle of n quantiles is n independent
draws held to their typical order statistics: short gaps still come in
runs and long prompts side by side, as under Poisson arrivals, while every
seed offers the same requests and tokens, so two seeds do the same work.
An offline mix, whose window works through only the head of its queue,
may ask for a stratified order instead (``strata``, ``arrange``), so that
every seed's window meets the same lengths.
"""
from __future__ import annotations

import json
import math
import pathlib
import statistics
from typing import List

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent


def load(kind: str, name: str) -> dict:
    """A data file of the benchmark: ``traffic/<name>.json`` or
    ``cells/<name>.json``."""
    return json.loads((ROOT / kind / f"{name}.json").read_text())


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([int(seed) % (1 << 64), stream]))


def quantile_lengths(spec: dict, n: int) -> np.ndarray:
    """n lengths at the quantiles (i + 0.5) / n of ``spec``'s lognormal
    (``median``, ``sigma``), rounded and clipped to [``min``, ``max``]."""
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    z = statistics.NormalDist()
    out = [spec["median"] * math.exp(spec["sigma"] * z.inv_cdf((i + 0.5) / n))
           for i in range(n)]
    return np.clip(np.rint(out), spec["min"], spec["max"]).astype(np.int64)


def quantile_gaps(rate: float, n: int) -> np.ndarray:
    """n gaps at the exponential's quantiles (i + 0.5) / n, mean 1 / rate."""
    u = (np.arange(n) + 0.5) / n
    return -np.log1p(-u) / rate


def request_count(mix: dict, cell: dict, seconds: float) -> int:
    """Open loop: the cell's ``preload`` (queued before the arrivals
    begin, so the window opens on a loaded engine) and the arrivals of the
    pre-roll and the window; offline: the mix's ``requests``."""
    if mix["driver"] == "open_loop":
        return cell.get("preload", 0) + int(math.ceil(
            cell["rate_per_s"] * (mix["warm_s"] + seconds)))
    return int(mix["requests"])


def arrange(lengths: np.ndarray, gen: np.random.Generator,
            strata: int = 0) -> np.ndarray:
    """``lengths`` in the run's order: a uniform shuffle or, with
    ``strata``, a stratified one: the sorted lengths cut into ``strata``
    runs of neighbouring quantiles (sizes differing by one at most), and
    each block of ``strata`` consecutive requests holding one length of
    each (the last block one of each of the larger strata), every stratum
    and every block shuffled on its own. A queue worked through from its
    head then meets the same lengths on every seed, up to a stratum's
    width."""
    if not strata:
        return gen.permutation(lengths)
    rows = [gen.permutation(row)
            for row in np.array_split(np.sort(lengths), strata)]
    blocks = [[row[i] for row in rows if i < len(row)]
              for i in range(len(rows[0]))]
    return np.concatenate([gen.permutation(block) for block in blocks])


def generate(mix: dict, cell: dict, seed: int, seconds: float,
             vocab: int) -> List[dict]:
    """The run's requests in order of arrival: ``rid``, ``due_s`` (seconds
    after the arrivals begin; 0 for a preloaded request and for every
    request of an offline mix),
    ``prompt`` (int32 token ids) and ``max_new`` (the output length; no
    EOS, so a request emits exactly that many tokens). The lengths are in
    the order ``arrange`` gives, stratified where the mix names
    ``strata``."""
    n = request_count(mix, cell, seconds)
    strata = mix.get("strata", 0)
    prompts = arrange(quantile_lengths(mix["prompt"], n), rng(seed, 1), strata)
    outputs = arrange(quantile_lengths(mix["output"], n), rng(seed, 2), strata)
    if mix["driver"] == "open_loop":
        if mix["arrivals"] != "poisson":
            raise ValueError(f"unknown arrivals {mix['arrivals']!r}")
        k = cell.get("preload", 0)
        due = np.concatenate([np.zeros(k), np.cumsum(rng(seed, 3).permutation(
            quantile_gaps(cell["rate_per_s"], n - k)))])
    else:
        due = np.zeros(n)
    toks = rng(seed, 4)
    return [{"rid": i, "due_s": float(due[i]),
             "prompt": toks.integers(0, vocab, size=int(prompts[i]),
                                     dtype=np.int32),
             "max_new": int(outputs[i])}
            for i in range(n)]
