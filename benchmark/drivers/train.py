"""Training: the port's one-card train step, ``tpusched_torch.workload.
make_optax_train_step`` with AdamW (``optim.adamw``, the mix's moment
dtype), fed by ``data.TokenBatcher``.

Set-up builds the step once and drives it through the mix's first
``warm_steps`` steps, which capture its program; the window then steps the
same object until it closes. ``train_tokens_per_s``: the tokens of every
step begun in the window over the time from the window's start to the
end of the last of them (each step ends in ``torch.cuda.synchronize()``).

What the check compares, read in set-up: the first ``followed_steps``
losses, each leaf's first gradient as the optimizer got it (its first
moment after step 1 over 1 - b1, as that moment's dtype rounds it), and
each leaf's change over the followed steps (the weights then, less the
initial ones, each made again from the seed, ``model.initial_leaf``). The
reference follows the same steps after the window (``reference.train``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import model, trace


def expected_batch(seed: int, step: int, batch: int, seq: int,
                   vocab: int) -> np.ndarray:
    """Batch ``step`` of the stream ``data.TokenBatcher`` documents: a
    numpy generator seeded by ``SeedSequence((seed, step))``."""
    rng = np.random.default_rng(np.random.SeedSequence((seed, step)))
    return rng.integers(0, vocab, size=(batch, seq), dtype=np.int32)


def _leaves(tree):
    out = [((k,), tree[k]) for k in ("embed", "out", "ln_f")]
    for i, layer in enumerate(tree["layers"]):
        out += [(("layers", i, k), v) for k, v in layer.items()]
    return out


def run(ctx) -> dict:
    from tpusched_torch import data, optim
    from tpusched_torch.workload import make_optax_train_step
    mix = ctx.mix
    parts = {}
    t = time.perf_counter()
    cfg = model.arch(ctx.conf).port_config(ctx.conf, seq=mix["seq"],
                                          remat=mix["remat"])
    tx = optim.adamw(mix["lr"], mu_dtype=getattr(torch, mix["mu_dtype"]))
    step, init_opt, _, _ = make_optax_train_step(None, cfg, tx)
    params = ctx.weights
    state = init_opt(params)
    batches = iter(data.TokenBatcher(cfg, mix["batch"], seed=ctx.seed,
                                     device=ctx.device))
    seen, losses = [], []
    grad_norms, change_norms = {}, {}
    k = mix["followed_steps"]
    b1 = float(torch.tensor(1 - optim.B1, dtype=getattr(torch,
                                                        mix["mu_dtype"])))
    parts["optimizer_state_s"] = time.perf_counter() - t
    for i in range(mix["warm_steps"]):
        t = time.perf_counter()
        tokens = next(batches)
        if i < k:
            seen.append(tokens.cpu().numpy())
        params, state, loss = step(params, state, tokens)
        ctx.sync()
        if i < k:
            losses.append(float(loss))
        if i == 0:
            grad_norms = {path: float(mu.double().norm()) / b1 for path, mu
                          in _leaves(state.mu)}
        if i == k - 1:
            change_norms = {
                path: float((t.double() - model.initial_leaf(
                    ctx.conf, ctx.seed, path, ctx.device).double()).norm())
                for path, t in _leaves(params)}
        parts[f"step{i + 1}_s"] = time.perf_counter() - t
    tr = mix["trace"]
    start = time.perf_counter()
    window = (start, start + ctx.seconds)
    prof = trace.Profiled(window[0] + tr["at"] * ctx.seconds,
                          tr["seconds"], ctx.trace and ctx.on_card)
    steps = []
    while True:
        now = time.perf_counter()
        prof.poll(now)
        if now >= window[1]:
            break
        idx = len(steps)
        traced = prof.active()
        with prof.span(f"bench.step#{idx}"):
            params, state, loss = step(params, state, next(batches))
            ctx.sync()
        steps.append({"t0": now, "t1": time.perf_counter(), "idx": idx,
                      "traced": traced})
    prof.stop()
    # every step begun in the window, each counted whole, over the time
    # from the window's start to the end of the last: a count of finished
    # steps over the nominal seconds would move in whole steps
    span = steps[-1]["t1"] - window[0]
    tokens = len(steps) * mix["batch"] * mix["seq"]
    return {
        "setup_s": window[0] - ctx.t_start,
        "e2e": {"train_tokens_per_s": tokens / span},
        "attempted": len(steps), "failed": 0,
        "records": {"steps": steps, "span_s": span, "batch": mix["batch"],
                    "seq": mix["seq"], "trace_started": prof.started_at},
        "window": window, "trace": prof.trace,
        "program": {"losses": losses, "grad_norms": grad_norms,
                    "change_norms": change_norms, "batches": seen,
                    "last_loss": float(loss)},
        "notes": {"setup_parts_s": dict(ctx.parts, **parts),
                  "profiler_s": prof.timings, "steps": len(steps),
                  "span_s": span,
                  "losses": losses, "last_loss": float(loss)},
    }


def check(out: dict, ctx, control: bool = False) -> dict:
    """The followed steps against the float32 reference, after the
    program's state is freed; the initial weights made again from the
    seed. The numbers the cell's ``limits`` name are compared; the others
    are reported under ``notes``. ``control`` (``benchmark.calibrate``)
    also puts the fp8 reference's two steps in the program's place, judged
    by the same limits (``control_correct``)."""
    from ..reference import train as ref
    mix, prog = ctx.mix, out["program"]
    ctx.weights = None
    out.pop("state", None)
    torch.cuda.empty_cache() if ctx.on_card else None
    k = mix["followed_steps"]
    want = [expected_batch(ctx.seed, i, mix["batch"], mix["seq"],
                           ctx.conf["vocab_size"]) for i in range(k)]
    fed_right = all(np.array_equal(a, b) for a, b in zip(prog["batches"],
                                                         want))
    weights = model.make_weights(ctx.conf, ctx.seed, ctx.device)
    batches = [torch.as_tensor(b, dtype=torch.long, device=ctx.device)
               for b in want]
    store = model.dtype_of(ctx.conf)
    r = ref.follow_two_steps(weights, ctx.conf, batches, mix["lr"], store)
    moved = {p for p, g in r["grad_norms"].items()
             if g >= 1e-3 * sorted(r["grad_norms"].values())[
                 len(r["grad_norms"]) // 2]}
    limits = ctx.cell["limits"]

    def gaps(pr, rr):
        return {"loss_gap": max(abs(a - b) for a, b in zip(pr["losses"],
                                                           rr["losses"])),
                "grad_norm_gap": ref.worst_leaf_gap(pr["grad_norms"],
                                                    rr["grad_norms"]),
                "change_norm_gap": ref.worst_leaf_gap(
                    pr["change_norms"], rr["change_norms"], moved)}

    got = gaps(prog, r)
    verdict = judge(got, fed_right, limits)
    if control:
        c = ref.follow_two_steps(weights, ctx.conf, batches, mix["lr"],
                                 store, quant="fp8")
        as_program = judge(gaps(c, r), fed_right, limits)
        verdict["stats"] = {"program": got, "control": gaps(c, r),
                            "control_correct": as_program["correct"],
                            "control_compared": as_program["compared"],
                            "reference_losses": r["losses"]}
    out["notes"]["readings"] = got
    return verdict


def judge(got: dict, fed_right: bool, limits: dict) -> dict:
    """``correct`` and the numbers compared, each beside its limit: the
    readings that ``limits`` name, and whether the batches were fed as
    documented."""
    compared = {name: {"value": v, "limit": limits[name]}
                for name, v in got.items() if name in limits}
    compared["batches_as_documented"] = {"value": int(not fed_right),
                                         "limit": 0}
    correct = fed_right and len(compared) > 1 and all(
        c["value"] <= c["limit"] for c in compared.values())
    return {"correct": correct, "compared": compared, "stats": {}}
