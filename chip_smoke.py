#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/H100 port, ``tpusched_torch``.

Run from the repository root on a machine with one CUDA card and ``nvcc``:

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   the time to build the kernels from ``tpusched_torch/csrc`` and each
   kernel's registers and spills as ``ptxas`` reports them; it fails if a
   Hopper kernel (wgmma, TMA) spills, ``ptxas`` ignored ``setmaxnreg`` or
   serialized a kernel's ``wgmma``, or a kernel's ``setmaxnreg`` split asks
   for more registers than its launch holds;
2. every kernel against its plain PyTorch version on the card: the flash
   forward (K1), then the backward's dK/dV (K2) and dQ (K3) kernels, whose
   gradients must also come out bitwise equal when run twice; then K4,
   single-token attention over the arena, at the serving cells' arenas and
   the tp ranks' (cursors 0, max_seq - 1, parked past the arena, random),
   its worst error against the plain version in f32 at most 1.25x the
   plain version's own in bf16, bitwise equal inside a CUDA graph, two
   launches a call, timed over 50 launches in a graph beside its bound,
   the plain version, today's einsum and SDPA (``phase_decode_attention``);
3. the serving path: ``llama_like_big`` at full width and depth (random
   bf16 weights from a seeded generator) served by ``ServeEngine`` and by
   ``measure_serving`` over 16 seeded requests, with the flash kernel's
   launch count held to 12 per slot prefill;
4. engine == solo greedy generation, token for token, on ``tiny`` f32 with
   flash attention (TF32 off), with the kernel's launches counted for the
   engine and for each solo run;
5. gradients on ``tiny`` f32 (flash, remat) through the kernels against
   the same run through naive attention, launches counted;
6. the training path: ``llama_like_big(seq=4096)``, batch 1, five AdamW
   steps (a captured program: the first step captures it, the rest
   replay) with launches counted per step and a falling loss, then
   ``measure.measure_adamw_train_step`` (step time, tokens/s, MFU; its
   warm runs capture, every timed run replays one graph);
7. kernel timing with CUDA events, K1 at the serving shape (also inside a
   CUDA graph, which leaves out the host's enqueue time) and K1, K2, K3 at
   the training shape, beside the plain versions, one PyTorch library call
   and the card's bound, and K2 then K3 together beside the library's whole
   backward; K2's schedule balance at the training shape;
8. the MoE serving path: ``mixtral_like`` at full width and depth served as
   in phase 3; its attention is naive, so the flash kernel must not launch;
9. engine == solo as in phase 4 on ``tiny`` f32 with 4 experts, naive and
   flash (launches counted);
10. the MoE training path: ``mixtral_like(seq=1024)``, batch 1, five SGD
    steps (``make_sharded_train_step``, captured) with a falling loss and
    a positive aux loss, then
    ``measure.measure_train_step``; tiny f32 MoE gradients on the card
    against the CPU's;
11. MoE decode: ``measure.measure_decode`` on ``mixtral_like(seq=512)`` at
    batch 8, with its HBM bandwidth utilization;
12. chunked serving: ``llama_like_big`` as in phase 3 with
    ``chunk_prefill=256`` (the flash kernel must not launch: chunks attend
    through the cached attention), printed beside phase 3's monolithic
    numbers; one tick mid-drain is traced with ``torch.profiler``;
13. the SLO harness: ``measure_serving_slo`` on 32 requests arriving by
    tick with a 300-token shared prefix, monolithic, chunked on full
    prompts, and chunked with the prefix registered (kernel launches
    counted for each: 34 prefills, none, the registration's);
14. the int8 arena: phase 3's requests served with
    ``kv_cache_dtype="int8"`` (arena bytes, launches per prefill, first
    tokens equal to phase 3's exact engine's), then phase 11's decode with
    an int8 cache;
15. engine == solo on ``tiny`` f32 as in phase 4, chunked (5 rows), with a
    registered prefix and mixed tenants, with an int8 arena, and with 4
    experts chunked;
16. ``torch.profiler`` traces of one ``mixtral_like(seq=512)`` decode step
    at batch 8 and one ``mixtral_like(seq=1024)`` SGD step: launches,
    host-to-device copies, synchronizations, device-busy against wall time
    and the five longest device operations (phase 12 prints the same for
    its tick; the traces go to ``build/torch_kernels/traces/``);
17. solo speculation at full width: ``llama_like_big`` from a 64-token
    prompt, 127 steps, k = 4, through ``decode.generate`` and
    ``speculative_generate`` with a self-draft and with ``llama_like`` as
    the draft (launches counted, tokens/s, accept rates), then a sampled
    self-draft run twice with one key (identical tokens);
18. speculative serving at full width: phase 3's requests with spec_k = 4,
    a self-draft (fewer rounds than phase 3's ticks) and a ``llama_like``
    draft, as a user drives the engine and through ``measure_serving``
    (launches per target and draft prefill), then request-keyed sampled
    speculative serving drained twice (identical tokens). The greedy
    streams of phases 17 and 18 equal plain decoding's, or differ first
    where the plain stream's two top logits lie within 1/32 (a near tie);
19. speculation on ``tiny`` f32 (flash, TF32 off), exact: the speculative
    engine == the plain engine == solo ``speculative_generate`` for random,
    truncated and self drafts on an exact and an int8 target arena;
    request-keyed and sampled speculative engines == their solo samplers;
20. tensor-parallel serving at full width: ranks spawned by
    ``mesh.launch`` (a ``FileStore`` under ``build/``) with
    ``backend="gloo"``, every rank on the one card: ``llama_like_big`` at
    tp = 2, then tp = 4, phase 3's requests, geometry and weights; every
    rank's completions equal, and equal phase 3's or differing first at a
    near tie; 216 flash launches a rank; then ``mixtral_like`` at tp = 2
    (no flash launch); peak memory a rank beside the unsharded engine's;
21. tiny f32 (d_model 128, 4 heads over 2, flash, TF32 off) at tp = 2,
    exact: the engine == the unsharded engine == solo for plain, chunked,
    prefix, int8, self-draft speculative and request-keyed serving, and
    with 4 experts;
22. dp×tp training: phase 6's steps at tp = 2 (24/12/12 launches a rank a
    step, a falling loss, each step's loss within 2e-2 of phase 6's, peak
    memory a rank beside phase 6's), then tiny f32 on a dp2×tp2 mesh of
    four ranks, three AdamW steps within 1e-5 of the whole model, and the
    vocab-parallel loss equal to the replicated one. Then the kernels at
    the ranks' shapes are timed as in phase 7. The times of phases 20-22
    are those of gloo through the host with every rank on one card: they
    say nothing of NCCL or NVLink;
23. the kernels in the ring's way: K2 and K3 non-causal at the ring's
    chunk (1, 4096, 16, 4, 128) bf16 with the lse and D of a two-chunk
    ring, not the pair's own, against their plain version and bitwise
    repeatable; ring-flash on two gloo ranks at that chunk against the
    plain version of the whole causal sequence (out, dq, dk, dv; rank r
    launches K1, K2 and K3 1 + r times); the masked-outlier input (second
    half's keys ×100, tiny f32) with finite gradients equal to the plain
    version's;
24. fully-sharded and sequence-parallel training at full width:
    ``llama_like_big(seq=8192)`` with ring-flash attention (remat on) on
    {"fsdp": 2, "sp": 2}, four gloo ranks, a global batch of 2 seeded rows,
    three AdamW steps, against the same weights and batch on one process
    with whole-sequence flash: losses within 2e-2 and falling, per rank and
    step K1 2·12·(1 + sp index) and K2 = K3 = 12·(1 + sp index), every fsdp
    leaf a rank holds half its whole size; peak memory a rank and step
    times printed;
25. tiny f32 on the reference's dryrun mesh {"fsdp": 2, "sp": 2, "tp": 2},
    eight gloo ranks, one SGD step with the ring and with ring-flash, each
    loss within 1e-5 of the whole model's with naive attention, K1
    launches a rank as in phase 24 at tiny's 2 layers. Then K1, K2 and K3
    non-causal at the ring's chunk are timed as in phase 7 (bounds: whole
    (s, s, d) products). Phases 23-25 run gloo through the host too;
26. expert parallelism at full width: ``mixtral_like(seq=1024)`` on
    {"dp": 2, "ep": 2} (four gloo ranks), a seeded global batch of 2 rows,
    three SGD steps at phase 10's lr, against one process on the same
    weights and batch: losses within 2e-2 and falling, a positive aux, 4
    of the 8 experts a rank, no flash launch; then ``mixtral_like`` served
    on {"ep": 2} with phase 8's traffic and geometry: the ranks agree, each
    stream equals phase 8's or first differs at a near tie, no flash
    launch; peak memory a rank and step times printed;
27. the GPipe pipeline at full width: ``llama_like_big(seq=4096)`` on
    {"pp": 2}, a seeded global batch of 4, 4 microbatches, three SGD steps:
    K1 = K2 = K3 = 6·4 = 24 a stage a step (no remat inside a stage), the
    first loss within 2e-2 of one process's ``loss_fn`` on the same
    weights and batch, falling losses; peak memory a stage and step times
    printed;
28. tiny f32 (TF32 off) on the reference dryrun's meshes: MoE (4 experts,
    top-2) on {"dp": 2, "ep": 2, "tp": 2} at capacity factors 1.25 and 0.5
    (drops present) and tiny on {"pp": 2, "dp": 4} with 2 microbatches,
    each loss within 1e-5 relative of the whole model's; a tiny flash
    pipeline on {"pp": 2}: (L/pp)·n_micro launches of each kernel a stage
    and every gradient within 1e-5 of the naive pipeline's. The times of
    phases 26-28 are gloo through the host with every rank on one card;
29. checkpoint and resume at full width: phase 6's ``llama_like_big(seq=
    4096)`` AdamW (mu f32, flash, remat) fed by ``data.TokenBatcher(seed=
    0)``, two steps, ``checkpoint.save`` of params and optimizer state
    under the git-ignored ``.chipwork/`` (seconds and bytes on disk), two
    more steps (the uninterrupted run), then the trained state freed (the
    captured step holds it only by weak references),
    ``checkpoint.restore`` into fresh tensors and two steps on
    ``TokenBatcher(seed=0, start_step=2)`` (the captured step, called with
    the restored tensors, captures anew for them): the resumed losses within
    1e-6 relative of the uninterrupted ones (bitwise equality printed), the
    AdamW count 2, the two streams' batches 2-3 identical, K1/K2/K3 24/12/12
    every step; the training peak and the resumed run's (restore and steps)
    beside phase 6's, and the restore's seconds. Then
    tiny f32 on four gloo ranks sharing the card: SGD saved on {"dp": 2,
    "tp": 2} and restored onto {"fsdp": 2, "tp": 2}, and MoE (4 experts)
    saved on {"dp": 2, "ep": 2} and restored onto {"ep": 4} (one expert a
    rank), each continuation within 1e-5 of the uninterrupted run;
30. train -> export -> serve: ``checkpoint.export_for_serving`` of phase
    29's trained params (snapshot bytes), ``load_for_serving`` (seconds) and
    phase 3's 16 requests and geometry served from it: completions equal an
    engine's on the params in memory exactly, K1 once a layer a prefill;
    then the snapshot read as shards by ``load_for_serving(mesh=)`` on
    {"tp": 2} gloo ranks and served: every leaf at its shard's shape, the
    ranks agree, each stream equals the one-card stream or first differs
    at a near tie; then a ``measure.GoodputReporter`` with an in-process
    recording client on ``measure_serving`` and ``measure_serving_slo``
    over phase 13's traffic (monolithic): one report a harness, its
    throughput the harness's tokens/s within 1e-6 relative, its step the
    ticks, the SLO report's TTFT ``ttft_s_p50``;
31. ``measure.calibrate()`` (a chain of 4096 x 4096 bf16 matmuls timed by
    the slope of 16 and 64 links) must read above 0 and below 989 TFLOP/s,
    printed beside ``device_peak_tflops`` and beside one fenced 16-link
    chain's wall time against its matmuls at that rate (the share of the
    chain the card is busy, which says whether a graph could help it); then ``budget``'s HBM model on
    ``h100-80gb`` for phase 6's training, phase 22's at tp 2, phase 3's
    serving, phase 20's at tp 2 and phase 14's int8 arena, beside the peak
    each of those phases measured in this run (phase 6's also as reserved
    memory, which holds its graph's pool) and their ratio (printed, not
    held: the reference's model counts nu in f32 and has no ep or pp
    factor), and the card's ``total_memory``;
32. serving over fully-sharded weights at full width: ``llama_like_big``
    on {"fsdp": 2}, two gloo ranks, the first 8 of phase 3's requests
    (one arena's worth), each cut to its first 16 new tokens, at phase 3's
    geometry and weights: the ranks agree, K1 12 x the engine's prefills a
    rank (12 x (8 + 2) = 120), every matrix, embed and out half its size
    on a rank, each stream equal to the start of phase 3's or first
    differing at a near tie; then the same weights
    exported and read back as fsdp shards by ``load_for_serving(mesh=)``,
    served through the engine's programs' bodies (the in-memory engine
    runs its captured chains, phase 39): the same launches and the
    in-memory engine's streams exactly; peak memory a rank beside phase
    3's, drain and load seconds;
33. phase 27's GPipe step on {"pp": 2, "fsdp": 2}, four gloo ranks, two
    steps: K1 = K2 = K3 = 24 a stage a step, every leaf over fsdp half its
    stage's size, the first loss within 1e-6 relative of phase 27's; peak
    memory a rank beside phase 27's a stage;
34. the entry points (``tpusched_torch.entry``): ``entry()``'s forward
    (4, 128, 2048) on the card within 1e-5 relative of the same weights'
    forward on the CPU (TF32 off), then ``dryrun_multichip(8)`` and
    ``dryrun_multichip(6)`` with every rank a gloo rank on the card: the
    reference's seven and five lines, each OK; at 8 the dense block's
    ring-flash K1 = K2 = K3 = L·(1 + sp index) a rank. Phases 32-34 run
    gloo through the host too. Every train step of phases 22 and 24-34
    over a mesh runs as a chain of graphs (phase 40);
35. the compiled programs (``tpusched_torch.program``): an engine with no
    mesh replays its decode tick, slot prefills and greedy round as CUDA
    graphs, and greedy ``generate`` one captured step a token, so phases 3,
    4, 8, 9, 11-15, 17-19 and 30 run through them. Here each program's
    replay is held against its body called directly on the same arena
    (bitwise, or the max |err| printed and the argmax equal): the decode
    tick and both prefill buckets of ``llama_like_big``, of its int8 arena
    and of ``mixtral_like``, with the pool memory the programs hold; 32
    decode-tick replays under ``torch.cuda.set_sync_debug_mode("error")``;
    phase 3's 16 requests drained by a graphed engine and by one whose
    programs call their bodies (a private hook, ``_graphs``), both giving
    phase 3's streams, K1 12 a slot prefill, tick 10 of each traced; phase
    18's ``llama_like``-draft engine graphed and eager, the draft tick and
    verify span replay == body, equal streams and stats, round 10 of each
    traced; one ``mixtral_like(seq=512)`` batch-8 decode step as
    ``generate``'s step program and as its body, traced and timed with
    CUDA events; then phase 11's ``measure_decode`` step beside its bound;
36. the chunk, prefix and sampled-round programs and solo speculation's
    rounds, which phases 12, 13, 17-19 now also run captured: on a
    chunked engine serving 6 of phase 3's requests, the chunk program's
    replay == its body at offsets 0, 256 and 768 of slots 1 and 6, phase
    13's 300-token prefix registered (K1 12 through the K/V program's
    replay) with its K/V program and, at a tenant's admission, its insert
    program replay == body, then 32 chunk and 32 insert replays under
    ``set_sync_debug_mode("error")``; phase 12's drain and phase 13's
    three SLO runs through the engines' bodies, every stream equal to the
    graphed run's (K1 0 and 408 / 0 / 12), the chunked tick traced as
    phase 12 traced it; the request-keyed sampled speculative engine
    (phase 18's sampling, k 4, phase 3's first 8 requests) with
    ``llama_like`` and with a self-draft, graphed and through its bodies:
    the draft ingest, step and verify span replay == body, identical
    streams and stats, round 10 of each traced; solo speculation
    (``llama_like`` draft, phase 17's prompt, 63 steps): each round
    program replay == body, and ``speculative_generate`` and
    ``speculative_sample`` graphed == through their bodies (the private
    ``spec_decode._program_factory`` swapped for one that builds
    programs with ``graphed=False``); chunked tokens/s (phase 12) printed
    beside plain (phase 3);
37. the train steps, sampled ``sample`` and the request-keyed tick as
    captured programs, which phases 6, 10 and 29 (and every one-card
    train step) now also run: ``llama_like_big(seq=4096)`` batch 1 AdamW,
    five steps graphed against five through the step's body (the private
    hook ``step._programs.graphs = False``) from the same seeded init,
    losses and every leaf
    of params, mu and nu bitwise equal (else the first leaf that differs
    and the largest difference, and losses within 2e-2), K1/K2/K3
    24/12/12 every step through replays; an accumulation step of 2 x (1,
    4096), twice each way (48/24/24 a step); ``mixtral_like(seq=1024)``
    SGD, three steps each way, no flash launch; each step's replays under
    ``torch.cuda.set_sync_debug_mode("error")``, its time, one traced
    step each way and peak memory, allocated and reserved (the graph's
    pool); sampled ``sample`` on ``llama_like_big`` at batch 8 (128-token
    prompts, T 0.8, top-p 0.95), 64 tokens under one seed: the public
    call == the loop graphed (replays sync-free) == through its body, its
    last steps traced each way, and seconds a token beside ``sample`` at
    top-p 1 and greedy ``generate``; phase 3's 16 requests request-keyed
    (phase 18's sampling) drained by the graphed engine, whose decode tick
    draws on the card, and by an engine running its bodies with every draw
    made on the host (``keyed_categorical``): equal streams, the smallest
    distance of a host uniform from its CDF edges, 32 keyed-tick replays
    sync-free, tokens/s beside phase 3's greedy engine;
38. the runner of the reference's on-chip lines
    (``tpusched_torch.bench``) in this process at full width: its
    ``decode`` and ``spec_solo`` line groups, each printed line parsed back
    and held to the reference's ``emit`` keys, the runner's card (the
    ``nvidia-smi`` line of phase 1) and its peak memory, a decode rate
    with an HBM bandwidth share in (0, 1), and a speculative stream with
    fewer target streams than plain decoding and no more proposals
    accepted than drafted, equal to plain greedy decoding's (timed on
    programs captured by a warm call) or the reference's divergence line
    at a near tie; then the runner's xl gate,
    three pure-bf16 AdamW steps (mu and nu bf16) of full-width
    ``llama_like_xl(seq=4096)`` with a finite, falling loss and finite
    moments, K1/K2/K3 40/20/20 a step through the captured step's replays,
    peak memory beside the budget's total; then K1, K2 and K3 timed at its
    shape (1, 4096, 20, 5, 128) as in phase 7 (phase 2 holds them against
    their plain versions there, and at (8, 2048, 8, 2, 128) and (2, 8192, 8,
    2, 128), the runner's other training shapes). The whole runner runs in
    a call of its own: ``python -m tpusched_torch.bench``;
39. the engine, ``generate(tp=)`` and ``sample(tp=)`` over a mesh as
    chains of CUDA graphs broken at each collective, which the serving
    of phases 20, 21, 26, 30, 32 and 34 now also runs (phases 20, 26 and
    32 hold each program's segments to its collectives + 1): on two gloo
    ranks sharing the card, full-width ``llama_like_big`` on {"tp": 2}
    with phase 3's requests, weights and geometry, run graphed and
    drained through its bodies (the private hook ``_graphs``), the decode
    tick and
    both prefill buckets replay == body bitwise after three ticks, the
    graphed engine run to tick 24 (phase 20 drains it whole, K1 216 a rank
    through the replays), the bodies' drain K1 216 a rank and its streams
    equal to phase 20's and to the graphed run's so far, tick 10 traced
    each way on rank 0, the ticks' mean and median ms printed; the greedy
    round with a self-draft (the target's weights propose, so drafts are
    accepted and rejected; a random ``llama_like`` draft accepts none) on
    phase 3's 16 whole requests drained both ways, untraced: the draft
    tick and verify span replay == body bitwise, the two drains' streams
    equal whole, their rounds and stats equal, some draft accepted, K1 12
    a target or draft prefill, the streams equal to plain decoding's
    counted (a bf16 near tie may flip them); tiny f32 (TF32
    off) on {"tp": 2}: chunked, prefix, int8, request-keyed and
    sampled-round engines, ``generate(tp=)`` and ``sample(tp=)`` graphed ==
    through their bodies; ``mixtral_like`` on {"ep": 2} with phase 26's
    traffic through its bodies, equal to phase 26's graphed drain (phase
    32 holds fsdp's chains against its bodies). Every captured program's
    segments are held to the collectives its warm-up ran + 1 (a program
    counts them; ``tests/test_torch_mesh_program.py`` pins each program's
    collectives on the CPU). Gloo through the host: these times say
    nothing of NCCL or NVLink;
40. the mesh train steps and the GPipe step as chains of CUDA graphs
    broken at each collective, the backward's (cut on autograd's device
    thread), the ring hops and the hand-offs included, which the training
    of phases 22, 24-28, 33 and 34 now also runs: one group a case, three
    steps chained and three through the bodies (``step._programs.graphs =
    False``) from the same initial shards at full width: phase 22's
    ``llama_like_big`` AdamW on {"tp": 2}, phase 24's ring-flash AdamW on
    {"fsdp": 2, "sp": 2}, phase 26's ``mixtral_like`` SGD on {"dp": 2,
    "ep": 2}, phase 27's GPipe step on {"pp": 2} and tiny f32 accumulation
    (2 microbatches) on {"dp": 2, "tp": 2}: losses and every shard after
    each step bitwise equal, every program's segments its warm-up's
    collectives + 1 (break kinds printed), K1/K2/K3 a step through the
    replays equal to the bodies' (24/12/12 a rank at tp 2; 24/12/12 and
    48/24/24 by sp index; 0 under ep; 24 each a stage under pp), cuts on
    autograd's thread counted, step times each way and peak memory a
    rank; last, on the tp 2 ranks a collective past the mesh's hook in a
    capture's forward and on the tiny ranks one in its backward must make
    the capture raise (``tests/test_torch_mesh_train_program.py`` pins
    the breaks on the CPU).

Phases 20-34, 39 and 40 run together after phase 19. First, alone on the
card, the work whose numbers a check or a table reads: the kernels timed
at the ranks' and the ring's shapes, the one-process references of
phases 23, 24, 26 and 27, the one-process card work of phases 29 and 30
and phase 31's calibrate. Then every phase's rank groups run side by side
(:func:`run_side_by_side`): each group is a ``tmesh.launch`` in a worker
thread, started once the card's free memory covers its ranks' peaks (a
table of each group's measured peak a rank) plus a CUDA context a rank
and a margin; the phases' checks run in phase order as their groups end,
so that phase 33 reads phase 27's results and phase 39 phases 20's and
26's; phase 31's budget, which reads phase 20's peaks, after them. A
``rank_groups`` line gives each group's ranks, start and end second, the
groups it overlapped and its ranks' peak memory, and each line of gloo
times names the groups that overlapped its own. Phases 35-38 follow,
alone. Each part prints its seconds (``phases_s``, ``phases_12_16_s``,
``phases_17_19_s``, ``phases_20_34_s`` with ``alone_s`` and
``side_by_side_s``, ``phases_35_38_s``) and the script its own
(``script_s``).

The second-to-last line is the ``kernels`` JSON object (each kernel also
with ``ring_launches`` from phase 24, ``ring_shape`` times,
``pp_launches`` from phases 27 and 28, ``ckpt_launches`` from phase 29,
``pp_fsdp_launches`` from phase 33, ``dryrun_launches`` from phase 34,
``graphed_train_launches`` from phase 37 and ``xl_shape`` from phase 38,
``mesh_graphed_train_launches`` from phase 40,
K1 ``mesh_graphed_launches`` from phase 39, ``handoff_launches``
from phase 30, ``fsdp_serving_launches`` from phase 32 and
``graphed_launches`` from phases 13, 35 and 36), the last line the
``ok`` JSON object. Imports neither JAX nor
the JAX package.

    python3 chip_smoke.py --ab DIR

instead times the flash kernels of another tree's ``tpusched_torch`` (under
DIR) and of this one in turns on the card (:func:`ab`) and runs no phase.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import io
import itertools
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}   # H100 SXM, dense
PEAK_BYTES_PER_S = 3.35e12
SERVE_BUCKETS = (256, 1024)
SERVE_GEOMETRY = dict(slots=8, max_seq=2048, prompt_bucket=SERVE_BUCKETS)
CHUNK = 256          # worst chunk-aligned span 1024 <= max_seq 2048
TRACE_DIR = (pathlib.Path(__file__).resolve().parent / "build" / "torch_kernels"
             / "traces")
# the kernels redesigned for Hopper (wgmma, TMA, setmaxnreg), bf16 d=128,
# each with its setmaxnreg split: (consumer, producer) registers a thread,
# two consumer warpgroups and one producer warpgroup of 128 threads
HOPPER_KERNELS = {"flash_fwd_sm90": (240, 24), "flash_bwd_dkdv_sm90": (232, 40),
                  "flash_bwd_dq_sm90": (240, 24)}
# llama_like_xl's training shape (b, s, h, kv, d): 20 heads over 5
XL_SHAPE = (1, 4096, 20, 5, 128)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def rand_qkv(gen, b, s, h, kv, d, dtype, pad=0):
    """Random q, k, v; with ``pad`` each is a view that skips ``pad``
    elements after every head row, so its strides are not the contiguous
    ones."""
    def r(heads):
        x = torch.randn((b, s, heads, d + pad), generator=gen,
                        device="cuda").to(dtype)
        return x[..., :d]
    return r(h), r(kv), r(kv)


def graph_launch_ms(fn, launches: int = 20, replays: int = 10) -> float:
    """Device time per call of ``fn``: ``launches`` calls captured in one
    CUDA graph, replayed, timed with CUDA events; unlike :func:`cuda_ms`
    it leaves out the host's time to enqueue each call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                # warm outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def cuda_ms(fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_environment(build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    print(smi)
    t0 = time.perf_counter()
    built = build.build_all()
    build_s = time.perf_counter() - t0
    logs = build.build_logs()
    usage = ptxas_usage(logs)
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device": torch.cuda.get_device_name(0),
                      "kernel_build_s": build_s, "built": sorted(built),
                      "registers_spill_stores": usage}))
    for name, (consumer, producer) in HOPPER_KERNELS.items():
        check(name in usage, f"ptxas reported nothing for {name}")
        check(usage[name][1] == 0, f"{name} spills: {usage[name]}")
        # setmaxnreg moves only the registers the block got at launch; a
        # split over them leaves setmaxnreg.inc waiting forever
        check((2 * consumer + producer) * 128 <= 3 * 128 * usage[name][0],
              f"{name}: setmaxnreg split {consumer}/{producer} exceeds the "
              f"384 x {usage[name][0]} registers of its launch")
    text = "\n".join(logs.values())
    check("C7508" not in text and "setmaxnreg ignored" not in text,
          "ptxas ignored setmaxnreg")
    serialized = [line for line in text.splitlines()
                  if "wgmma.mma_async instructions are serialized" in line]
    check(not serialized, f"ptxas serialized wgmma: {serialized}")
    return smi


def ptxas_usage(logs) -> dict:
    """{"kernel<head_dim>" or "kernel": [registers, spill store bytes]} from
    the ``-Xptxas -v`` lines of the build logs. Registers are those the
    kernel starts with; a Hopper kernel's consumer warpgroups then take more
    through setmaxnreg (:data:`HOPPER_KERNELS`)."""
    usage, name = {}, None
    for line in "\n".join(logs.values()).splitlines():
        m = re.search(r"\d((?:flash|decode_attn)_\w+?)(?:ILi(\d+)E|E)",
                      line)
        if "Compiling entry function" in line and m:
            name = m[1] + (f"<{m[2]}>" if m[2] else "")
            usage[name] = [None, None]
        elif name and (m := re.search(r"(\d+) bytes spill stores", line)):
            usage[name][1] = int(m[1])
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            usage[name][0] = int(m[1])
    return usage


def tile_rel_l2(out, ref, tile: int = 64, floor: float = 0.0) -> float:
    """Worst relative L2 error over tiles of ``tile`` query rows: each tile
    of O is held to its own norm, so late causal rows, whose values are
    small, are held to their scale and not to that of the first rows. A
    tile whose norm per element is below ``floor`` is held to the floor (a
    gradient that is zero in exact arithmetic, as dq and dk at s = 1)."""
    b, s = ref.shape[:2]
    n = -(-s // tile)

    def per_tile(x):
        rows = x.float().pow(2).reshape(b, s, -1).sum(dim=(0, 2))
        return torch.nn.functional.pad(rows, (0, n * tile - s)).reshape(
            n, tile).sum(dim=1)
    size = per_tile(torch.ones_like(ref, dtype=torch.float32))
    den = torch.maximum(per_tile(ref), floor ** 2 * size)
    return (per_tile(out.float() - ref.float()) / den).sqrt().max().item()


def phase_kernel_vs_plain(attention):
    """Flash kernel vs its plain version. O: the worst 64-row tile's
    relative L2 error within 1e-2 in bf16 and 1e-4 in f32, and the max
    error within 2e-2 (bf16) or 1e-4 (f32) of max|plain|; lse within 1e-3
    absolute. Returns the main-path (s=1024) case's max abs error of O."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (b, s, h, kv, d, dtype, causal, pad)
        (1, 256, 16, 4, 128, bf16, True, 0),     # main path, small bucket
        (1, 1024, 16, 4, 128, bf16, True, 0),    # main path, large bucket
        (2, 1024, 8, 8, 128, bf16, True, 0),     # MHA
        (2, 2048, 8, 2, 128, bf16, True, 0),     # GQA 4:1
        (2, 1024, 8, 2, 128, bf16, True, 0),     # GQA
        (2, 512, 4, 1, 128, bf16, True, 0),      # MQA
        (2, 4096, 4, 4, 128, bf16, True, 0),     # long MHA
        (1, 1000, 16, 4, 128, bf16, True, 0),    # ragged last tile
        (1, 1024, 16, 4, 128, bf16, False, 0),   # non-causal
        (1, 129, 16, 4, 128, bf16, True, 0),     # ragged at a 128-row tile
        (1, 1, 16, 4, 128, bf16, True, 0),       # s below one tile
        (1, 17, 16, 4, 128, bf16, True, 0),
        (1, 1024, 8, 1, 128, bf16, True, 0),     # MQA 8:1
        (2, 512, 8, 2, 128, bf16, True, 8),      # strided, 16-byte aligned
        (1, 4096, 16, 4, 128, bf16, False, 0),   # non-causal, training shape
        (2, 200, 4, 2, 64, bf16, True, 0),       # head_dim 64, ragged
        (1, 96, 2, 2, 32, bf16, False, 0),       # tiny's head_dim
        (2, 300, 4, 2, 64, f32, True, 0),        # f32, ragged
        (1, 64, 2, 2, 32, f32, False, 3),        # f32, strided
        (1, 300, 16, 4, 128, bf16, True, 0),     # phase 13's prefix
        (1, 64, 16, 4, 128, bf16, True, 0),      # phase 17's prompt
        # phase 20's per-rank prefills at tp = 2 and tp = 4, both buckets
        (1, 256, 8, 2, 128, bf16, True, 0),
        (1, 1024, 8, 2, 128, bf16, True, 0),
        (1, 256, 4, 1, 128, bf16, True, 0),
        (1, 1024, 4, 1, 128, bf16, True, 0),
        (1, 4096, 8, 2, 128, bf16, True, 0),     # phase 22's per-rank forward
        (1, 8192, 16, 4, 128, bf16, True, 0),    # phase 24's one process
        # the runner's training lines (tpusched_torch.bench): xl's 20 heads
        # over 5, llama_like at seq 2048 b8 and at seq 8192 b2
        XL_SHAPE + (bf16, True, 0),
        (8, 2048, 8, 2, 128, bf16, True, 0),
        (2, 8192, 8, 2, 128, bf16, True, 0),
    ] + [  # every length the tiny f32 phases prefill: prompts 4-13, the
           # bucket 16, phase 15's 12-token prefix and prefix + suffix 16-25;
           # phase 19's drafts (one and two layers of tiny's heads) too, and
           # phase 21's GQA variant whole and at tp = 2 (its heads per rank)
        (1, s, h, kv, 32, f32, True, 0) for s in range(4, 26)
        for h, kv in ((2, 2), (4, 2), (2, 1))] + [
        (4, 32, 4, 2, 32, f32, True, 0),         # phase 22's tiny, whole
        (2, 32, 2, 1, 32, f32, True, 0)]         # and on a dp2xtp2 rank
    main_err = None
    for b, s, h, kv, d, dtype, causal, pad in cases:
        q, k, v = rand_qkv(gen, b, s, h, kv, d, dtype, pad)
        out, lse = attention.flash_forward(q, k, v, causal)
        torch.cuda.synchronize()
        ref, ref_lse = attention.flash_attention_plain(q, k, v, causal)
        err = (out.float() - ref.float()).abs().max().item()
        rel = err / ref.float().abs().max().item()
        l2 = tile_rel_l2(out, ref)
        rms = ref.float().pow(2).mean().sqrt().item()
        lse_err = (lse - ref_lse).abs().max().item()
        tol_l2, tol = (1e-2, 2e-2) if dtype == bf16 else (1e-4, 1e-4)
        print(f"kernel vs plain b={b} s={s} h={h} kv={kv} d={d} "
              f"{str(dtype)[6:]} causal={causal} pad={pad}: worst-tile "
              f"rel L2 {l2:.3e} (tol {tol_l2}), max|err| {err:.3e} = "
              f"{rel:.3e} of max|plain| (tol {tol}), rms(plain) {rms:.3e}, "
              f"lse {lse_err:.3e} (tol 1e-3)")
        check(out.shape == q.shape and lse.shape == (b * h, s, 1),
              "flash output shapes")
        check(l2 < tol_l2 and rel < tol and lse_err < 1e-3,
              f"flash kernel disagrees with its plain version at "
              f"{(b, s, h, kv, d, dtype, causal, pad)}")
        if (b, s, h, kv, d, dtype, causal, pad) == (1, 1024, 16, 4, 128,
                                                    bf16, True, 0):
            main_err = err
    # the bf16 kernel's 16-byte loads: an unaligned view is refused
    q, k, v = rand_qkv(gen, 1, 64, 2, 2, 64, bf16, pad=2)
    try:
        attention.flash_forward(q, k, v, True)
    except ValueError:
        pass
    else:
        raise RuntimeError("flash kernel took unaligned bf16 rows")
    return main_err


def phase_backward_vs_plain(attention):
    """K2 (dk, dv) and K3 (dq) vs their plain version: for each gradient
    the worst 64-row tile's relative L2 error within 2e-2 in bf16 and 1e-4
    in f32 (a tile below 1e-3 per element held to that floor). Run twice on
    the same inputs, both kernels give bitwise equal dq, dk and dv. The
    case with a given D hands in one that is not Σ dO∘O: both versions
    must use it. Returns the max abs errors (dq, max of dk and dv) at the
    training shape and at :data:`XL_SHAPE`."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [  # (b, s, h, kv, d, dtype, causal, pad, given dd)
        (1, 4096, 16, 4, 128, bf16, True, 0, False),   # the training shape
        (1, 1024, 16, 4, 128, bf16, True, 0, False),
        (2, 1024, 8, 8, 128, bf16, True, 0, False),    # MHA
        (2, 512, 4, 1, 128, bf16, True, 0, False),     # MQA
        (1, 1000, 16, 4, 128, bf16, True, 0, False),   # ragged last tile
        (1, 1024, 16, 4, 128, bf16, False, 0, False),  # ring-flash pairs
        (1, 129, 16, 4, 128, bf16, True, 0, False),    # ragged past 128 rows
        (1, 1, 16, 4, 128, bf16, True, 0, False),      # s below one tile
        (1, 17, 16, 4, 128, bf16, True, 0, False),
        (1, 1024, 8, 1, 128, bf16, True, 0, False),    # MQA 8:1
        (2, 512, 8, 2, 128, bf16, True, 8, False),     # strided, 16-byte aligned
        (1, 4096, 16, 4, 128, bf16, False, 0, False),  # non-causal, training shape
        (1, 192, 16, 4, 128, bf16, True, 0, False),    # 64-row tiles, not 128
        (2, 320, 8, 2, 128, bf16, False, 0, False),    # the same, non-causal
        (2, 200, 4, 2, 64, bf16, True, 0, False),      # head_dim 64, ragged
        (1, 32, 2, 2, 32, f32, True, 0, False),        # tiny's shape
        (2, 300, 4, 2, 64, f32, True, 0, False),       # f32, ragged
        (1, 64, 2, 2, 32, f32, False, 3, False),       # f32, strided
        (1, 512, 8, 2, 128, bf16, True, 0, True),      # caller's D
        (1, 4096, 8, 2, 128, bf16, True, 0, False),    # phase 22's per rank
        (1, 8192, 16, 4, 128, bf16, True, 0, False),   # phase 24's one process
        (2, 32, 2, 1, 32, f32, True, 0, False),        # phase 22's tiny rank
        (4, 32, 4, 2, 32, f32, True, 0, False),        # and its whole model
        # the runner's training lines, as in phase 2
        XL_SHAPE + (bf16, True, 0, False),
        (8, 2048, 8, 2, 128, bf16, True, 0, False),
        (2, 8192, 8, 2, 128, bf16, True, 0, False),
    ]
    main_err, xl_err = None, None
    for b, s, h, kv, d, dtype, causal, pad, given_dd in cases:
        q, k, v = rand_qkv(gen, b, s, h, kv, d, dtype, pad)
        do = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
        out, lse = attention.flash_forward(q, k, v, causal)
        dd = None
        if given_dd:
            dd = attention._to_bh((do.float() * out.float()).sum(
                dim=-1, keepdim=True)) + torch.randn(
                    (b * h, s, 1), generator=gen, device="cuda")
        got = attention._flash_backward(q, k, v, out, lse, do, causal, dd)
        again = attention._flash_backward(q, k, v, out, lse, do, causal, dd)
        torch.cuda.synchronize()
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"flash backward is not bitwise repeatable at "
              f"{(b, s, h, kv, d, dtype, causal, pad)}")
        del again
        ref = attention.flash_backward_plain(q, k, v, out, lse, do, causal,
                                             dd)
        tol = 2e-2 if dtype == bf16 else 1e-4
        errs = []
        for name, x, y in zip(("dq", "dk", "dv"), got, ref):
            check(x.shape == y.shape and x.dtype == y.dtype,
                  f"{name} shape/dtype")
            l2 = tile_rel_l2(x, y, floor=1e-3)
            err = (x.float() - y.float()).abs().max().item()
            rms = y.float().pow(2).mean().sqrt().item()
            errs.append(err)
            print(f"backward vs plain b={b} s={s} h={h} kv={kv} d={d} "
                  f"{str(dtype)[6:]} causal={causal} pad={pad} "
                  f"dd={'given' if given_dd else 'derived'} {name}: "
                  f"worst-tile rel L2 {l2:.3e} (tol {tol}), max|err| "
                  f"{err:.3e}, rms(plain) {rms:.3e}, bitwise repeatable")
            check(l2 < tol, f"flash backward {name} disagrees with its "
                  f"plain version at {(b, s, h, kv, d, dtype, causal)}")
        if main_err is None:
            main_err = (errs[0], max(errs[1:]))
        if (b, s, h, kv, d) == XL_SHAPE:
            xl_err = (errs[0], max(errs[1:]))
    # a dO the kernels cannot take is refused, not run
    q, k, v = rand_qkv(gen, 1, 64, 2, 2, 64, bf16)
    out, lse = attention.flash_forward(q, k, v, True)
    try:
        attention._flash_backward(q, k, v, out, lse, out.float(), True)
    except ValueError:
        pass
    else:
        raise RuntimeError("flash backward took a dO of another dtype")
    return main_err, xl_err


# (b, max_seq, kv, n_rep): mistral-7b's and mixtral-8x7b's arenas (hd 128),
# a tp-2 and a tp-4 rank's, and one group of 20 heads (two blocks of 16)
DECODE_ARENAS = [(64, 4096, 8, 4), (48, 4096, 8, 4), (64, 4096, 4, 4),
                 (64, 4096, 2, 4), (6, 1000, 1, 20)]
DECODE_TOL = 1.25    # K4's worst error over the bf16 plain version's


def decode_cursors(gen, b, max_seq):
    """Random cursors with the edges: row 0 alone, the arena's last row, an
    idle slot parked past the arena, and the 64- and 512-row boundaries."""
    pos = torch.randint(0, max_seq, (b,), generator=gen, device="cuda")
    edges = [0, max_seq - 1, max_seq + 5, 63, 64, 511, 512, 513]
    pos[:len(edges)] = torch.tensor(edges[:b], device="cuda")
    return pos


def decode_operands(gen, b, max_seq, kv, n_rep, dtype, q_pad=0):
    q = torch.randn((b, 1, kv * n_rep, 128 + q_pad), generator=gen,
                    device="cuda").to(dtype)[..., :128]
    ck, cv = (torch.randn((b, max_seq, kv, 128), generator=gen,
                          device="cuda").to(dtype) for _ in range(2))
    return q, ck, cv


def phase_decode_attention(attention, decode) -> dict:
    """K4 against its plain version at the cells' arena shapes: the worst
    element error against the plain version run in f32 at most
    ``DECODE_TOL`` times the plain version's own in bf16 (both round O to
    bf16; the einsum's error beside them); two runs and a CUDA graph's
    replay bitwise equal; two launches a call. Then timed at mistral-7b's
    arena over 50 launches inside a CUDA graph, with random cursors and
    with every slot full. Returns the timings."""
    usage = {k: u for k, u in ptxas_usage(
        attention._build.build_logs()).items() if k.startswith("decode_attn")}
    check(len(usage) == 4 and all(u[1] == 0 for u in usage.values()),
          f"K4's kernels (split and combine, bf16 and fp16) spill or are "
          f"missing: {usage}")
    gen = torch.Generator(device="cuda").manual_seed(11)
    bf16 = torch.bfloat16
    cases = [(shape, bf16, "vector", 0) for shape in DECODE_ARENAS] + [
        ((64, 4096, 8, 4), bf16, "0-d", 0),
        ((16, 2048, 8, 4), torch.float16, "vector", 0),
        ((16, 2048, 8, 4), bf16, "vector", 8),        # a strided q
        ((8, 700, 8, 1), bf16, "vector", 0)]
    for (b, max_seq, kv, n_rep), dtype, form, q_pad in cases:
        q, ck, cv = decode_operands(gen, b, max_seq, kv, n_rep, dtype, q_pad)
        pos = decode_cursors(gen, b, max_seq)
        if form == "0-d":
            pos = pos[1]
        before = attention.DECODE_ATTN_LAUNCHES
        out = attention.decode_attention(q, ck, cv, pos, n_rep)
        again = attention.decode_attention(q, ck, cv, pos, n_rep)
        torch.cuda.synchronize()
        check(attention.DECODE_ATTN_LAUNCHES - before == 4,
              "K4 launches two kernels a call")
        check(torch.equal(out, again), "K4 is not bitwise repeatable")
        ref = attention.decode_attention_plain(q.float(), ck.float(),
                                               cv.float(), pos, n_rep)
        plain = attention.decode_attention_plain(q, ck, cv, pos, n_rep)
        einsum = decode._einsum_attention(q, ck, cv, pos, n_rep)
        err = (out.float() - ref).abs().max().item()
        plain_err = (plain.float() - ref).abs().max().item()
        einsum_err = (einsum.float() - ref).abs().max().item()
        line = {"decode_attn_vs_plain": [b, max_seq, kv, n_rep, 128],
                "dtype": str(dtype)[6:], "pos": form, "q_pad": q_pad,
                "chunk": attention.decode_chunk(b, max_seq, kv, n_rep),
                "max_abs_err": err, "plain_bf16_err": plain_err,
                "einsum_err": einsum_err, "ratio": err / plain_err,
                "max_abs_ref": ref.abs().max().item()}
        print(json.dumps(line))
        check(out.shape == q.shape and out.dtype == dtype, "K4 output")
        check(bool(torch.isfinite(out).all()), "K4 output not finite")
        check(err <= DECODE_TOL * plain_err,
              f"K4 disagrees with its plain version: {line}")
        del q, ck, cv, out, again, ref, plain, einsum
    # inside a graph: the cursor read on the device, replay == eager
    b, max_seq, kv, n_rep = DECODE_ARENAS[0]
    q, ck, cv = decode_operands(gen, b, max_seq, kv, n_rep, bf16)
    pos = decode_cursors(gen, b, max_seq)
    eager = attention.decode_attention(q, ck, cv, pos, n_rep)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        attention.decode_attention(q, ck, cv, pos, n_rep)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = attention.decode_attention(q, ck, cv, pos, n_rep)
    graph.replay()
    torch.cuda.synchronize()
    check(torch.equal(captured, eager), "K4 replayed != K4 eager")
    pos.copy_(decode_cursors(gen, b, max_seq))       # new cursors, same graph
    graph.replay()
    eager = attention.decode_attention(q, ck, cv, pos, n_rep)
    torch.cuda.synchronize()
    check(torch.equal(captured, eager),
          "K4 replayed at new cursors != K4 eager")
    del graph, captured, eager
    timings = {}
    for label, full in (("random", False), ("full", True)):
        if full:
            pos.fill_(max_seq - 1)
        else:
            pos.copy_(decode_cursors(gen, b, max_seq))
        counted = attention.DECODE_ATTN_LAUNCHES
        graph_ms = graph_launch_ms(
            lambda: attention.decode_attention(q, ck, cv, pos, n_rep),
            launches=50, replays=4)
        attention.DECODE_ATTN_LAUNCHES = counted    # timing is not counted
        plain_ms = cuda_ms(lambda: attention.decode_attention_plain(
            q, ck, cv, pos, n_rep), iters=5)
        einsum_ms = cuda_ms(lambda: decode._einsum_attention(
            q, ck, cv, pos, n_rep), iters=10)
        qt = q.transpose(1, 2)
        kt, vt = ck.transpose(1, 2), cv.transpose(1, 2)
        mask = (torch.arange(max_seq, device="cuda")[None, :]
                <= pos.clamp(max=max_seq - 1)[:, None])[:, None, None, :]
        try:
            library_ms = cuda_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True), iters=10)
        except RuntimeError as e:              # a yardstick, never the port's
            library_ms = f"refused: {e}"[:200]
        rows = int((pos.clamp(max=max_seq - 1) + 1).sum().item())
        live_kv = rows * kv * 128 * 2 * ck.element_size()
        nbytes = live_kv + 2 * q.numel() * q.element_size()
        bound_ms = nbytes / PEAK_BYTES_PER_S * 1e3
        timings[label] = dict(
            shape=[b, max_seq, kv, n_rep, 128], live_rows=rows,
            live_kv_bytes=live_kv, bytes=nbytes, bound_ms=bound_ms,
            graph_ms=graph_ms, plain_ms=plain_ms, einsum_ms=einsum_ms,
            library_ms=library_ms,
            live_kv_hbm_share=live_kv / (graph_ms * 1e-3) / PEAK_BYTES_PER_S)
        print(json.dumps({"timing": "decode_attn", "cursors": label,
                          **timings[label]}))
    return timings


def grad_rel_err(got, ref) -> float:
    """Worst relative L2 error over the leaves of two gradient trees."""
    return max(((a.float() - b.float()).norm() / b.float().norm()).item()
               for a, b in zip(got, ref))


def bwd_counts(attention):
    return (attention.FLASH_FWD_LAUNCHES, attention.FLASH_BWD_DKDV_LAUNCHES,
            attention.FLASH_BWD_DQ_LAUNCHES)


def zero_counts(attention):
    attention.FLASH_FWD_LAUNCHES = 0
    attention.FLASH_BWD_DKDV_LAUNCHES = 0
    attention.FLASH_BWD_DQ_LAUNCHES = 0


def phase_grad_parity(attention, workload):
    """loss_fn and its gradients on tiny f32 (flash, remat, TF32 off)
    through the kernels against the same run through naive attention,
    within 1e-4 relative; one step launches K1 twice per layer (the remat
    recompute) and K2 and K3 once each."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(workload.ModelConfig.tiny(), attn="flash",
                              remat=True)
    params = workload.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab, (2, cfg.seq)), device="cuda")
    zero_counts(attention)
    loss, grads = workload.value_and_grad(params, tokens, cfg)
    torch.cuda.synchronize()
    counts = bwd_counts(attention)
    want = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    check(counts == want, f"tiny train step launched (K1, K2, K3) = "
          f"{counts}, wanted {want}")
    ref_loss, ref_grads = workload.value_and_grad(
        params, tokens, cfg, attn_fn=attention.naive_attention)
    loss_err = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    g_err = grad_rel_err(workload.tree_leaves(grads),
                         workload.tree_leaves(ref_grads))
    print(f"tiny f32 flash+remat vs naive: loss {loss.item():.6f} rel err "
          f"{loss_err:.3e}, worst grad rel L2 {g_err:.3e} (tol 1e-4), "
          f"launches (K1, K2, K3) {counts}")
    check(loss_err < 1e-4 and g_err < 1e-4,
          "flash gradients disagree with naive attention's")


def make_requests(cfg, serve):
    rng = np.random.default_rng(0)
    return [serve.Request(
        rid=i,
        prompt=rng.integers(0, cfg.vocab, size=int(rng.integers(64, 1025)),
                            dtype=np.int32),
        max_new_tokens=int(rng.integers(16, 129)))
        for i in range(16)]


def seeded_params(workload, cfg, device="cuda", seed=0):
    """Random weights for ``cfg`` from a generator on ``device`` seeded
    ``seed`` (0 unless a phase needs a second model): the same weights in
    every phase that asks for the same shapes."""
    return workload.init_params(
        cfg, torch.Generator(device=device).manual_seed(seed), device)


def check_completions(done, reqs, vocab, what):
    check(sorted(c.rid for c in done) == list(range(len(reqs))),
          f"{what}: not every request completed")
    for c in done:
        want = reqs[c.rid].max_new_tokens
        check(len(c.tokens) == want, f"{what}: request {c.rid}: "
              f"{len(c.tokens)} tokens, wanted {want}")
        check(bool(((c.tokens >= 0) & (c.tokens < vocab)).all()),
              f"{what}: request {c.rid}: token outside the vocabulary")


def phase_serving(attention, serve, workload, name="llama_like_big"):
    """Full-width serving of the preset ``name``: the flash kernel launches
    once per layer and slot prefill where the preset's attention is flash
    (llama_like_big), never where it is naive (mixtral_like). Returns the
    flash launches of the main path run, measure_serving's numbers, the
    peak memory and each request's tokens."""
    cfg = getattr(workload.ModelConfig, name)()
    per_prefill = cfg.n_layers if cfg.attn == "flash" else 0
    params = seeded_params(workload, cfg)
    reqs = make_requests(cfg, serve)
    want_tokens = sum(r.max_new_tokens for r in reqs)
    geometry = SERVE_GEOMETRY
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # the main path as a user drives it: engine, warmup, submit, drain
    attention.FLASH_FWD_LAUNCHES = 0
    attention.DECODE_ATTN_LAUNCHES = 0
    eng = serve.ServeEngine(params, cfg, device="cuda", **geometry)
    eng.warmup()
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    launches = attention.FLASH_FWD_LAUNCHES
    if per_prefill:
        check(launches > 0, "the serving path launched no flash kernel")
    check(launches == per_prefill * eng.prefills,
          f"{name}: {launches} flash launches for {eng.prefills} prefills "
          f"of {cfg.n_layers} layers with attn={cfg.attn}")
    # K4: two launches a layer of every decode tick, counted through the
    # decode program's replays
    decode_ticks = eng._programs[("decode",)].replays
    decode_launches = attention.DECODE_ATTN_LAUNCHES
    check(decode_ticks > 0 and decode_launches == 2 * cfg.n_layers
          * decode_ticks, f"{name}: {decode_launches} K4 launches for "
          f"{decode_ticks} decode ticks of {cfg.n_layers} layers")
    check_completions(done, reqs, cfg.vocab, name)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    prefills = eng.prefills
    del eng

    # the same traffic through measure_serving, the throughput entry point
    attention.FLASH_FWD_LAUNCHES = 0
    stats = serve.measure_serving(cfg, params, reqs, device="cuda",
                                  **geometry)
    measured_launches = attention.FLASH_FWD_LAUNCHES
    check(measured_launches == per_prefill * stats["prefills"],
          f"measure_serving: {measured_launches} flash launches for "
          f"{stats['prefills']} prefills")
    check(stats["tokens"] == want_tokens, "measure_serving lost tokens")
    moe = ({"n_experts": cfg.n_experts, "top_k": cfg.moe_top_k}
           if cfg.n_experts else {})
    print(json.dumps({
        "serving": name, **moe, "requests": len(reqs),
        "slots": geometry["slots"], "max_seq": geometry["max_seq"],
        "buckets": list(SERVE_BUCKETS), "prefills": prefills,
        "flash_launches": launches, "decode_attn_launches": decode_launches,
        "decode_ticks": decode_ticks, "tokens": stats["tokens"],
        "tokens_per_s": stats["tokens_per_s"],
        "occupancy": stats["occupancy"], "ticks": stats["ticks"],
        "max_tick_gap_s": stats["max_tick_gap_s"],
        "elapsed_s": stats["elapsed_s"], "peak_mem_gib": peak_gib}))
    return dict(launches=launches, stats=stats, peak_mem_gib=peak_gib,
                tokens={c.rid: c.tokens for c in done},
                decode_launches=decode_launches, decode_ticks=decode_ticks)


def phase_parity(attention, decode, serve, workload, attn="flash",
                 n_experts=0, chunk_prefill=None, prefix_len=0,
                 kv_cache_dtype=None):
    """Engine == solo greedy generation on tiny f32 (with ``n_experts``
    experts, ``chunk_prefill`` rows a chunk, a registered prefix of
    ``prefix_len`` tokens that every other request follows, an int8 arena),
    with flash attention through the kernel (launches counted for the
    engine, the prefix's registration and each solo run) or naive (no
    launch). A prefix request is held against solo generation on its whole
    prompt, an int8 engine against solo int8 generation. TF32 is off so
    float32 products are full float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(workload.ModelConfig.tiny(), attn=attn,
                              n_experts=n_experts,
                              kv_cache_dtype=kv_cache_dtype)
    per_prefill = cfg.n_layers if attn == "flash" else 0
    params = seeded_params(workload, cfg)
    rng = np.random.default_rng(2)
    reqs = [serve.Request(
        rid=i, prompt=rng.integers(0, cfg.vocab,
                                   size=int(rng.integers(4, 14)),
                                   dtype=np.int32),
        max_new_tokens=int(rng.integers(3, 8))) for i in range(5)]
    prefix = rng.integers(0, cfg.vocab, prefix_len, dtype=np.int32)
    if prefix_len:
        reqs = [dataclasses.replace(r, prefix_id="sys") if r.rid % 2 == 0
                else r for r in reqs]
    eng = serve.ServeEngine(params, cfg, slots=2, max_seq=64,
                            prompt_bucket=16, chunk_prefill=chunk_prefill,
                            device="cuda")
    attention.FLASH_FWD_LAUNCHES = 0
    if prefix_len:
        eng.register_prefix("sys", prefix)
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    engine_prefills = eng.prefills + (1 if prefix_len else 0)
    check(attention.FLASH_FWD_LAUNCHES == per_prefill * engine_prefills,
          f"tiny engine: {attention.FLASH_FWD_LAUNCHES} flash launches for "
          f"{engine_prefills} prefills of {cfg.n_layers} layers, attn={attn}")
    check(sorted(c.rid for c in done) == list(range(5)),
          "tiny engine lost a request")
    for c in done:
        req = reqs[c.rid]
        full = (np.concatenate([prefix, req.prompt]) if req.prefix_id
                else req.prompt)
        check(c.prompt_len == len(full), f"request {c.rid}: prompt_len "
              f"{c.prompt_len}, wanted {len(full)}")
        attention.FLASH_FWD_LAUNCHES = 0
        solo = decode.generate(
            params, torch.as_tensor(full, device="cuda")[None].long(),
            cfg, steps=req.max_new_tokens - 1)[0].cpu().numpy()
        check(attention.FLASH_FWD_LAUNCHES == per_prefill,
              f"solo generate: {attention.FLASH_FWD_LAUNCHES} flash "
              f"launches for one prefill of {cfg.n_layers} layers, "
              f"attn={attn}")
        check(np.array_equal(c.tokens, solo),
              f"request {c.rid}: engine {c.tokens} != solo {solo}")
    opts = "".join([f" with {n_experts} experts" if n_experts else "",
                    f" chunk_prefill={chunk_prefill}" if chunk_prefill else "",
                    f" prefix {prefix_len} (rids 0, 2, 4)" if prefix_len
                    else "", f" kv {kv_cache_dtype}" if kv_cache_dtype
                    else ""])
    print(f"engine == solo on tiny f32{opts} {attn}: {len(done)} requests, "
          f"{engine_prefills} engine prefills, flash launches "
          f"{per_prefill} per prefill")


def phase_timing(attention, shape=(1, 1024, 16, 4, 128)):
    """Times at the main path's large-bucket shape (or a rank's share of it,
    ``shape``). The inputs (10.6 MB whole) stay in the 50 MB L2 across
    launches, as a prefill's freshly computed q/k/v would be."""
    b, s, h, kv, d = shape
    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = rand_qkv(gen, b, s, h, kv, d, dtype)
    counted = attention.FLASH_FWD_LAUNCHES
    ms = cuda_ms(lambda: attention.flash_forward(q, k, v, True))
    graph_ms = graph_launch_ms(lambda: attention.flash_forward(q, k, v, True))
    attention.FLASH_FWD_LAUNCHES = counted   # timing launches are not counted
    plain_ms = cuda_ms(lambda: attention.flash_attention_plain(q, k, v, True))
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    library_ms = cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True))
    flops = 4 * b * h * d * s * (s + 1) / 2     # causal: k <= q pairs only
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size() \
        + b * h * s * 4                         # q, k, v, O, lse
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    print(json.dumps({"timing": "flash_fwd", "shape": [b, s, h, kv, d],
                      "flops": flops, "bytes": nbytes, "ms": ms,
                      "graph_ms": graph_ms, "plain_ms": plain_ms,
                      "library_ms": library_ms}))
    return dict(ms=ms, graph_ms=graph_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def train_big(attention, optim, workload, mesh=None):
    """Five AdamW steps (lr 1e-4, mu f32) of full-width
    llama_like_big(seq=4096), batch 1, random bf16 weights, on one repeated
    batch through make_optax_train_step (on one card a captured program:
    the first step captures it, the others replay), each step's kernel
    launches counted (K1 2·n_layers with remat, K2 and K3 n_layers), with
    a finite, falling loss. With ``mesh`` the same weights and tokens
    train as this rank's shards. Returns the losses, step times, launches
    of the five steps and the peak memory of the steps (allocated, and
    reserved, which holds the graph's pool)."""
    cfg = workload.ModelConfig.llama_like_big(seq=4096)
    params = seeded_params(workload, cfg)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, cfg.seq)), device="cuda")
    tx = optim.adamw(1e-4, mu_dtype=torch.float32)
    step, init_opt, _, _ = workload.make_optax_train_step(mesh, cfg, tx)
    if mesh is not None:
        params = workload.shard_params(params, cfg, mesh)   # whole tree freed
        torch.cuda.empty_cache()
    state = init_opt(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    want = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    losses, step_s, total = [], [], [0, 0, 0]
    for _ in range(5):
        zero_counts(attention)
        t0 = time.perf_counter()
        params, state, loss = step(params, state, tokens)
        losses.append(loss.item())             # the fence
        step_s.append(time.perf_counter() - t0)
        counts = bwd_counts(attention)
        check(counts == want, f"train step launched (K1, K2, K3) = "
              f"{counts}, wanted {want}")
        total = [t + c for t, c in zip(total, counts)]
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    return dict(losses=losses, step_s=step_s, launches=total,
                per_step=want,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                peak_reserved_gib=torch.cuda.max_memory_reserved() / 2**30)


def phase_training(attention, measure, optim, workload):
    """The training path: :func:`train_big` on one card, then
    measure_adamw_train_step on the same configuration. Returns
    :func:`train_big`'s record."""
    cfg = workload.ModelConfig.llama_like_big(seq=4096)
    batch = 1
    run = train_big(attention, optim, workload)
    losses, step_s, want = run["losses"], run["step_s"], run["per_step"]
    peak_gib = run["peak_mem_gib"]
    per_step, tflops, mfu, note = measure.measure_adamw_train_step(cfg, batch)
    print(json.dumps({
        "training": "llama_like_big", "seq": cfg.seq, "batch": batch,
        "optimizer": "adamw lr 1e-4 mu f32", "losses": losses,
        "step_s": step_s, "launches_per_step": dict(zip(
            ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"), want)),
        "peak_mem_gib": peak_gib, "per_step_s": per_step,
        "tokens_per_s": batch * cfg.seq / per_step, "tflops": tflops,
        "mfu": mfu, "peak_tflops": measure.device_peak_tflops(),
        "step_flops": measure.train_step_flops(cfg, batch), "note": note}))
    return run


def phase_training_timing(attention, shape=(1, 4096, 16, 4, 128),
                          label="training shape", causal=True):
    """K1, K2 and K3 at the training shape with CUDA events, beside the
    plain versions and one library call (scaled_dot_product_attention: its
    forward for K1, its backward, which forms dq, dk and dv together, for
    K2 and K3). Bounds: 2, 4 and 3 causal-halved (s, s, d) products (whole
    ones with ``causal=False``, the ring's visiting pairs). Since
    no library call forms dq alone, K2 then K3, as the backward launches
    them, is also timed as one and printed beside the library's backward.
    K1's output at this shape is held against its plain version as in
    phase 2, and its max abs error is returned with its times. ``shape``
    and ``label`` time a rank's share of the training shape."""
    b, s, h, kv, d = shape
    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = rand_qkv(gen, b, s, h, kv, d, dtype)
    do = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
    out, lse = attention.flash_forward(q, k, v, causal)
    ref, _ = attention.flash_attention_plain(q, k, v, causal)
    fwd_err = (out.float() - ref.float()).abs().max().item()
    check(tile_rel_l2(out, ref) < 1e-2,
          "flash kernel disagrees with its plain version at the training shape")
    del ref
    dd = attention._to_bh((do.float() * out.float()).sum(
        dim=-1, keepdim=True)).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    def k2():
        attention._launch_bwd("dkdv", q, k, v, do, lse, dd, (dk, dv), causal)

    def k3():
        attention._launch_bwd("dq", q, k, v, do, lse, dd, (dq,), causal)

    def k2_k3():
        k2()
        k3()
    ms = {
        "flash_fwd": cuda_ms(lambda: attention.flash_forward(q, k, v, causal)),
        "flash_bwd_dkdv": cuda_ms(k2),
        "flash_bwd_dq": cuda_ms(k3),
    }
    pair_ms = cuda_ms(k2_k3)
    fwd_plain = cuda_ms(lambda: attention.flash_attention_plain(q, k, v, causal),
                        iters=10)
    bwd_plain = cuda_ms(lambda: attention.flash_backward_plain(
        q, k, v, out, lse, do, causal), iters=10)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_(True)
                  for x in (q, k, v))

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True)
    with torch.no_grad():
        fwd_lib = cuda_ms(sdpa)
    ot, dot = sdpa(), do.transpose(1, 2).contiguous()
    bwd_lib = cuda_ms(lambda: torch.autograd.grad(ot, (qt, kt, vt), dot,
                                                  retain_graph=True))
    # one (s, s, d) product, causal-halved or whole
    pair = 2 * b * h * d * s * ((s + 1) / 2 if causal else s)
    el = q.element_size()
    rows = b * h * s * 4                         # one f32 value per query row
    work = {  # (products, bytes: each input read once, each output written)
        "flash_fwd": (2, (2 * q.numel() + 2 * k.numel()) * el + rows),
        "flash_bwd_dkdv": (4, (2 * q.numel() + 4 * k.numel()) * el + 2 * rows),
        "flash_bwd_dq": (3, (3 * q.numel() + 2 * k.numel()) * el + 2 * rows),
    }
    timing = {}
    for name, (products, nbytes) in work.items():
        t_ops = products * pair / PEAK_FLOPS[dtype] * 1e3
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        fwd = name == "flash_fwd"
        timing[name] = dict(
            ms=ms[name], plain_ms=fwd_plain if fwd else bwd_plain,
            library_ms=fwd_lib if fwd else bwd_lib,
            bound_ms=max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes")
    timing["flash_fwd"]["max_abs_err"] = fwd_err
    walks = attention._dkdv_schedule(b, s, kv, causal)
    work = (walks[:, :, 3] - walks[:, :, 2]).clip(min=0).sum(axis=1)
    ratio = float(work.max() / work.mean())
    print(f"K2 schedule at {(b, s, h, kv, d)} causal={causal}: {len(work)} "
          f"blocks, "
          f"longest / mean walk {ratio:.4f} (the reference's key tiles: "
          f"1.97)")
    check(ratio <= 1.3, "K2's schedule is out of balance")
    print(json.dumps({"timing": label, "shape": [b, s, h, kv, d],
                      "causal": causal, **timing}))
    print(json.dumps({"timing": f"backward at the {label}",
                      "flash_bwd_dkdv_then_dq_ms": pair_ms,
                      "sdpa_backward_ms": bwd_lib,
                      "bound_ms": (timing["flash_bwd_dkdv"]["bound_ms"]
                                   + timing["flash_bwd_dq"]["bound_ms"])}))
    return timing


def phase_moe_training(measure, workload):
    """The MoE training path: full-width mixtral_like(seq=1024), batch 1
    (the capacity path, C = 320), five SGD steps (lr 0.1) on one repeated
    batch with a finite, falling loss and a finite, positive aux loss after
    them; then measure.measure_train_step. Last, the card against the CPU:
    loss and every gradient (the router's included) of tiny f32 with 4
    experts, TF32 off, within 1e-4 relative (L2, per leaf). Returns the
    steps' peak memory and times."""
    cfg = workload.ModelConfig.mixtral_like(seq=1024)
    batch = 1
    params = workload.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (batch, cfg.seq)), device="cuda")
    step, _, _ = workload.make_sharded_train_step(None, cfg, lr=0.1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        params, loss = step(params, tokens)     # captured, then replayed
        losses.append(loss.item())             # the fence
        step_s.append(time.perf_counter() - t0)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    with torch.no_grad():
        logits, aux = workload.forward(params, tokens, cfg, with_aux=True)
    check(logits.shape == (batch, cfg.seq, cfg.vocab)
          and bool(torch.isfinite(logits).all()), "MoE logits not finite")
    check(all(np.isfinite(losses)), f"non-finite MoE loss: {losses}")
    check(losses[-1] < losses[0], f"MoE loss did not fall: {losses}")
    check(np.isfinite(aux.item()) and aux.item() > 0,
          f"MoE aux loss {aux.item()}")
    del params, logits, step
    per_step, tflops, mfu = measure.measure_train_step(cfg, batch)
    print(json.dumps({
        "training": "mixtral_like", "seq": cfg.seq, "batch": batch,
        "n_experts": cfg.n_experts, "top_k": cfg.moe_top_k,
        "capacity": workload.moe_capacity(cfg, batch * cfg.seq),
        "optimizer": "sgd lr 0.1", "losses": losses, "step_s": step_s,
        "aux": aux.item(), "peak_mem_gib": peak_gib,
        "per_step_s": per_step,
        "tokens_per_s": batch * cfg.seq / per_step, "tflops": tflops,
        "mfu": mfu, "peak_tflops": measure.device_peak_tflops(),
        "step_flops": measure.train_step_flops(cfg, batch),
        "note": measure.moe_flops_note(cfg, batch)}))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tiny = dataclasses.replace(workload.ModelConfig.tiny(), n_experts=4)
    params = workload.init_params(
        tiny, torch.Generator(device="cuda").manual_seed(0), "cuda")
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        0, tiny.vocab, (2, tiny.seq)))
    loss, grads = workload.value_and_grad(params, tokens.cuda(), tiny)
    cpu_params = workload.tree_map(lambda t: t.cpu(), params)
    ref_loss, ref_grads = workload.value_and_grad(cpu_params, tokens, tiny)
    loss_err = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    leaves = [g.cpu() for g in workload.tree_leaves(grads)]
    g_err = grad_rel_err(leaves, workload.tree_leaves(ref_grads))
    r_err = grad_rel_err([grads["layers"][i]["router"].cpu()
                          for i in range(tiny.n_layers)],
                         [ref_grads["layers"][i]["router"]
                          for i in range(tiny.n_layers)])
    print(f"tiny f32 MoE gradients, card vs CPU: loss rel err "
          f"{loss_err:.3e}, worst grad rel L2 {g_err:.3e}, router "
          f"{r_err:.3e} (tol 1e-4)")
    check(loss_err < 1e-4 and g_err < 1e-4,
          "MoE gradients on the card disagree with the CPU's")
    return {"peak_mem_gib": peak_gib, "step_s": step_s}


def phase_moe_decode(measure, workload, kv_cache_dtype=None):
    """Decode throughput of full-width mixtral_like(seq=512), batch 8, 128-
    token prompts (measure.measure_decode's slope between 64 and 256 greedy
    steps), with its HBM bandwidth utilization and the bound that the bytes
    of one step imply at 3.35 TB/s; the cache exact or int8. Returns the
    printed numbers."""
    cfg = dataclasses.replace(workload.ModelConfig.mixtral_like(seq=512),
                              kv_cache_dtype=kv_cache_dtype)
    batch, prompt_len = 8, 128
    tps, ctx = measure.measure_decode(cfg, batch, prompt_len=prompt_len)
    util = measure.decode_bandwidth_utilization(cfg, batch, ctx, tps)
    nbytes = measure.decode_bytes_per_token(cfg, batch, ctx)
    check(np.isfinite(tps) and tps > 0, f"decode rate {tps}")
    check(util is not None and 0 < util < 1,
          f"decode bandwidth utilization {util}")
    out = {"decode": "mixtral_like", "kv_cache_dtype": kv_cache_dtype,
           "seq": cfg.seq, "batch": batch, "prompt_len": prompt_len,
           "tokens_per_s": tps, "mean_ctx": ctx, "step_s": batch / tps,
           "bytes_per_step": nbytes,
           "bound_step_s": nbytes / PEAK_BYTES_PER_S,
           "bandwidth_utilization": util,
           "peak_hbm_gbps": measure.device_peak_hbm_gbps()}
    print(json.dumps(out))
    return out


def trace_summary(prof, label: str, wall_s: float,
                  unprofiled_s: float = None, **extra) -> dict:
    """One JSON line from a ``torch.profiler`` trace (written to
    :data:`TRACE_DIR`): kernel launches the host issued, host-to-device
    copies on the card, stream and device synchronizations, the card's busy
    time (the union of its kernels, copies and sets) against the wall time
    of the traced work, so its idle share, and the five device operations
    with the most time. The profiler slows the host, so where the same work
    was also timed without it (``unprofiled_s``) the idle share is given
    against that time too. Fails if the trace holds no CUDA kernel."""
    TRACE_DIR.mkdir(parents=True, exist_ok=True)
    path = TRACE_DIR / (re.sub(r"\W+", "_", label) + ".json")
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"]
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    host = [e["name"] for e in events
            if e.get("cat") in ("cuda_runtime", "cuda_driver")]
    check(any(e["cat"] == "kernel" for e in device),
          f"trace of {label}: the profiler recorded no CUDA kernel")
    busy_us, end = 0.0, -np.inf
    for e in sorted(device, key=lambda e: e["ts"]):
        start, stop = e["ts"], e["ts"] + e["dur"]
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    by_name: dict = {}
    for e in device:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    out = {"trace": label, **extra,
           "kernels": sum(e["cat"] == "kernel" for e in device),
           "kernel_launch_calls": sum("LaunchKernel" in n for n in host),
           "graph_launches": sum("GraphLaunch" in n for n in host),
           "htod_copies": sum(e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]
                              for e in device),
           "syncs": sum(n in ("cudaStreamSynchronize", "cudaDeviceSynchronize")
                        for n in host),
           "device_busy_s": busy_us / 1e6, "wall_s": wall_s,
           "idle_share": 1.0 - busy_us / 1e6 / wall_s,
           **({"wall_unprofiled_s": unprofiled_s,
               "idle_share_unprofiled": 1.0 - busy_us / 1e6 / unprofiled_s}
              if unprofiled_s else {}),
           "top5_device_s": [[n[:100], t] for n, t in top],
           "file": str(path.relative_to(TRACE_DIR.parents[2]))}
    print(json.dumps(out))
    return out


def profiler():
    return torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])


def fenced_s(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def traced(fn, label: str) -> dict:
    """:func:`trace_summary` of one call of ``fn``, already warm, fenced by
    ``torch.cuda.synchronize()`` on both sides, after the median of three
    calls timed without the profiler."""
    unprofiled = float(np.median([fenced_s(fn) for _ in range(3)]))
    with profiler() as prof:
        wall = fenced_s(fn)
    return trace_summary(prof, label, wall, unprofiled)


def drain_chunked(eng, label):
    """Drain a chunked engine tick by tick, each tick timed (fenced) with
    the chunk programs it runs, except the first tick from the tenth on
    with slots both prefilling and decoding, which is traced
    (:func:`trace_summary`). Returns the trace and the (chunk programs,
    wall s) of every other tick."""
    tick_s, trace = [], None
    while eng.queue or any(r is not None for r in eng.req):
        # a tick runs one chunk for each slot prefilling after admission
        chunks = (sum(o is not None for o in eng.prefill_off)
                  + min(len(eng.queue), sum(r is None for r in eng.req)))
        decoding = sum(r is not None and o is None
                       for r, o in zip(eng.req, eng.prefill_off))
        if trace is None and eng.tick_count >= 10 and chunks and decoding:
            tick = eng.tick_count
            with profiler() as prof:
                wall = fenced_s(eng.tick)
            trace = trace_summary(prof, label, wall, tick=tick,
                                  prefilling=chunks, decoding=decoding)
        else:
            tick_s.append((chunks, fenced_s(eng.tick)))
        check(eng.tick_count < 100_000, "chunked serving did not drain")
    check(trace is not None, f"{label}: no tick mid-drain was traced")
    return trace, tick_s


def phase_chunked_serving(attention, serve, workload, mono):
    """Phase 3's traffic and geometry with chunk_prefill=256, driven as a
    user does and then through measure_serving: every request completes
    with its tokens, and the flash kernel launches 0 times (chunks attend
    through the cached attention, as the reference's chunk program runs no
    Pallas call). Each tick of the user's run is timed (fenced) with the
    chunk programs it runs, to test the reference's claim that chunking
    bounds a tick near one chunk and the decode step; one tick mid-drain,
    with slots both prefilling and decoding, is traced (and left out of
    those times). Prints beside phase 3's monolithic ``mono``. Returns the
    user's streams, the trace and measure_serving's numbers."""
    cfg = workload.ModelConfig.llama_like_big()
    params = seeded_params(workload, cfg)
    reqs = make_requests(cfg, serve)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attention.FLASH_FWD_LAUNCHES = 0
    eng = serve.ServeEngine(params, cfg, chunk_prefill=CHUNK, device="cuda",
                            **SERVE_GEOMETRY)
    eng.warmup()
    for r in reqs:
        eng.submit(r)
    trace, tick_s = drain_chunked(eng, "llama_like_big chunked serving tick")
    done = eng.completions
    torch.cuda.synchronize()
    launches = attention.FLASH_FWD_LAUNCHES
    check(launches == 0, f"chunked serving launched the flash kernel "
          f"{launches} times; chunks attend through the cached attention")
    check(eng.prefills == 0, "chunked serving ran a monolithic prefill")
    check_completions(done, reqs, cfg.vocab, "chunked llama_like_big")
    tokens = {c.rid: c.tokens for c in done}
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    del eng
    attention.FLASH_FWD_LAUNCHES = 0
    stats = serve.measure_serving(cfg, params, reqs, chunk_prefill=CHUNK,
                                  device="cuda", **SERVE_GEOMETRY)
    check(attention.FLASH_FWD_LAUNCHES == 0,
          "chunked measure_serving launched the flash kernel")
    check(stats["tokens"] == sum(r.max_new_tokens for r in reqs),
          "chunked measure_serving lost tokens")
    keys = ("tokens_per_s", "ticks", "occupancy", "max_tick_gap_s",
            "elapsed_s")
    by_chunks = {}
    for n in sorted({n for n, _ in tick_s}):
        ts = [t for m, t in tick_s if m == n]
        by_chunks[str(n)] = {"ticks": len(ts), "median_s": float(
            np.median(ts)), "max_s": max(ts)}
    print(json.dumps({
        "serving": "llama_like_big", "chunk_prefill": CHUNK,
        "requests": len(reqs), "flash_launches": launches,
        "peak_mem_gib": peak_gib, **{k: stats[k] for k in keys},
        "tick_s_by_chunk_programs": by_chunks,
        "monolithic": {**{k: mono["stats"][k] for k in keys},
                       "peak_mem_gib": mono["peak_mem_gib"]}}))
    return dict(tokens=tokens, trace=trace, stats=stats)


def slo_traffic(vocab: int):
    """Phase 13's traffic: a 300-token shared prefix (a ragged flash tile),
    then 32 requests of 64-640-token suffixes and 16-128 new tokens
    arriving by tick with Poisson gaps of mean 2, from one seeded
    generator."""
    rng = np.random.default_rng(6)
    prefix = rng.integers(0, vocab, 300, dtype=np.int32)
    suffixes = [rng.integers(0, vocab, int(rng.integers(64, 641)),
                             dtype=np.int32) for _ in range(32)]
    gens = [int(rng.integers(16, 129)) for _ in range(32)]
    arrivals = np.cumsum(rng.poisson(2.0, 32)).tolist()
    return prefix, suffixes, gens, arrivals


SLO_TICKS = 16


@contextlib.contextmanager
def engines_built(serve, graphs=True):
    """While open, ``serve.ServeEngine`` (which the harnesses build their
    engines from) records every engine it builds in the list it yields;
    ``graphs=False`` sets the private hook that makes a card engine call
    its programs' bodies."""
    built, base = [], serve.ServeEngine

    class Recorded(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self._graphs = self._graphs and graphs
            built.append(self)

    serve.ServeEngine = Recorded
    try:
        yield built
    finally:
        serve.ServeEngine = base


def phase_slo(attention, serve, workload, graphs=True):
    """measure_serving_slo on full-width llama_like_big with phase 13's
    traffic, three ways: (a) monolithic on the full prompts (prefix +
    suffix <= 940 < 1024), (b) chunk_prefill=256 on the full prompts, (c)
    chunk_prefill=256 with the prefix registered, on the suffixes. All
    three serve the same count of tokens; (c) drains in fewer ticks than
    (b), with a TTFT p50 in ticks no higher; the flash kernel launches once a layer
    per monolithic prefill in (a) (32 admissions and warmup's 2 buckets),
    never in (b), and only for the prefix's registration in (c).
    ``graphs=False`` runs the engines' program bodies (phase 36). Returns
    the launches and each run's streams."""
    cfg = workload.ModelConfig.llama_like_big()
    params = seeded_params(workload, cfg)
    prefix, suffixes, gens, arrivals = slo_traffic(cfg.vocab)

    def requests(prompts):
        return [serve.Request(rid=i, prompt=p, max_new_tokens=gens[i])
                for i, p in enumerate(prompts)]
    full = [np.concatenate([prefix, s]) for s in suffixes]
    runs = {"monolithic": (full, {}, cfg.n_layers * (len(full) + 2)),
            "chunked": (full, dict(chunk_prefill=CHUNK), 0),
            "prefix": (suffixes, dict(chunk_prefill=CHUNK,
                                      prefix_tokens=prefix), cfg.n_layers)}
    out, launches, streams = {}, {}, {}
    for name, (prompts, kw, want) in runs.items():
        attention.FLASH_FWD_LAUNCHES = 0
        with engines_built(serve, graphs) as built:
            out[name] = serve.measure_serving_slo(
                cfg, params, requests(prompts), arrivals,
                ttft_slo_ticks=SLO_TICKS, device="cuda", **SERVE_GEOMETRY,
                **kw)
        launches[name] = attention.FLASH_FWD_LAUNCHES
        streams[name] = {c.rid: c.tokens for c in built[0].completions}
        check(launches[name] == want, f"SLO {name}: {launches[name]} flash "
              f"launches, wanted {want}")
    counts = {name: r["tokens"] for name, r in out.items()}
    check(len(set(counts.values())) == 1 and counts["chunked"] == sum(gens),
          f"SLO runs served different token counts: {counts}")
    check(out["prefix"]["ticks"] < out["chunked"]["ticks"]
          and out["prefix"]["ttft_ticks_p50"]
          <= out["chunked"]["ttft_ticks_p50"],
          "the registered prefix did not help against chunked full prompts")
    print(json.dumps({
        "slo": "llama_like_big", "graphed": graphs, "requests": len(full),
        "prefix_tokens": len(prefix), "ttft_slo_ticks": SLO_TICKS,
        "chunk_prefill": CHUNK, "flash_launches": launches, **out}))
    return launches, streams


def phase_int8_serving(attention, serve, workload, exact, exact_decode,
                       measure):
    """Phase 3's requests on an int8 arena (monolithic admission): the
    flash kernel launches once a layer per prefill, the arena takes about
    half the exact one's bytes, and each request's first token is phase 3's
    exact engine's (prefill attends the fresh K/V and reads no cache). The
    share of all tokens that agree is printed, not checked: random weights
    leave near-ties. Then phase 11's decode with an int8 cache, beside
    phase 11's exact numbers. Returns the flash launches and the peak
    memory of the drain."""
    cfg = dataclasses.replace(workload.ModelConfig.llama_like_big(),
                              kv_cache_dtype="int8")
    params = seeded_params(workload, cfg)
    reqs = make_requests(cfg, serve)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    attention.FLASH_FWD_LAUNCHES = 0
    eng = serve.ServeEngine(params, cfg, device="cuda", **SERVE_GEOMETRY)
    eng.warmup()
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    launches = attention.FLASH_FWD_LAUNCHES
    check(launches == cfg.n_layers * eng.prefills, f"int8 serving: "
          f"{launches} flash launches for {eng.prefills} prefills")
    check_completions(done, reqs, cfg.vocab, "int8 llama_like_big")
    arena = sum(t.numel() * t.element_size()
                for layer in eng.cache for t in layer.values())
    exact_arena = (cfg.n_layers * 2 * SERVE_GEOMETRY["slots"]
                   * SERVE_GEOMETRY["max_seq"] * cfg.kv_heads * cfg.head_dim
                   * torch.finfo(cfg.dtype).bits // 8)
    check(arena < 0.55 * exact_arena, f"int8 arena {arena} bytes against "
          f"the exact {exact_arena}")
    differ = [c.rid for c in done
              if int(c.tokens[0]) != int(exact["tokens"][c.rid][0])]
    check(not differ, f"int8 first tokens differ from the exact engine's "
          f"for requests {differ}")
    agree = np.concatenate([c.tokens == exact["tokens"][c.rid]
                            for c in done])
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    del eng
    attention.FLASH_FWD_LAUNCHES = 0
    stats = serve.measure_serving(cfg, params, reqs, device="cuda",
                                  **SERVE_GEOMETRY)
    check(attention.FLASH_FWD_LAUNCHES == cfg.n_layers * stats["prefills"],
          "int8 measure_serving: flash launches against prefills")
    check(stats["tokens"] == sum(r.max_new_tokens for r in reqs),
          "int8 measure_serving lost tokens")
    keys = ("tokens_per_s", "max_tick_gap_s", "elapsed_s")
    print(json.dumps({
        "serving": "llama_like_big", "kv_cache_dtype": "int8",
        **{k: stats[k] for k in keys},
        "exact": {k: exact["stats"][k] for k in keys},
        "requests": len(reqs), "prefills": int(launches // cfg.n_layers),
        "flash_launches": launches, "arena_bytes": arena,
        "exact_arena_bytes": exact_arena,
        "first_tokens_equal": len(done) - len(differ),
        "token_agreement_with_exact": float(agree.mean()),
        "peak_mem_gib": peak_gib,
        "exact_peak_mem_gib": exact["peak_mem_gib"]}))
    i8 = phase_moe_decode(measure, workload, "int8")
    keys = ("tokens_per_s", "step_s", "bytes_per_step", "bound_step_s",
            "bandwidth_utilization")
    print(json.dumps({"decode": "mixtral_like", "int8": {
        k: i8[k] for k in keys}, "exact": {k: exact_decode[k] for k in keys}}))
    return launches, peak_gib


def phase_trace(decode, workload):
    """torch.profiler traces, after warm-up, of one greedy decode step of
    full-width mixtral_like(seq=512) at batch 8 (128-token prompts, as
    phases 11 and 14), with an exact and with an int8 cache, and of one
    mixtral_like(seq=1024) SGD step (as phase 10)."""
    for kv_cache_dtype in (None, "int8"):
        cfg = dataclasses.replace(workload.ModelConfig.mixtral_like(seq=512),
                                  kv_cache_dtype=kv_cache_dtype)
        params = seeded_params(workload, cfg)
        gen = torch.Generator(device="cuda").manual_seed(1)
        prompt = torch.randint(0, cfg.vocab, (8, 128), generator=gen,
                               device="cuda")
        cache = decode.init_kv_cache(cfg, 8, cfg.seq, "cuda")
        state = {"pos": 128}
        with torch.no_grad():
            logits, _ = decode.prefill(params, cache, prompt, cfg)
            state["tok"] = logits[:, -1].argmax(-1)

            def step():               # one step of decode.sample's loop
                logits, _ = decode.decode_step(params, cache, state["tok"],
                                               state["pos"], cfg)
                state["tok"] = decode.sample_token(logits, None, 0.0)
                state["pos"] += 1
            for _ in range(3):
                step()
            traced(step, f"mixtral_like decode step batch 8 kv "
                   f"{kv_cache_dtype or 'exact'}")
        del params, cache, logits
    cfg = workload.ModelConfig.mixtral_like(seq=1024)
    params = seeded_params(workload, cfg)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, cfg.seq)), device="cuda")
    state = {"params": params}

    def sgd():
        state["params"], loss = workload.sgd_train_step(
            state["params"], tokens, cfg, lr=0.1)
        check(np.isfinite(loss.item()), "non-finite MoE loss")
    sgd()
    traced(sgd, "mixtral_like SGD step seq 1024")


# -- speculative decoding and request-keyed sampling (phases 17-19) -----------

SPEC_K = 4


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def flash_layers(cfg) -> int:
    """K1 launches of one prefill of ``cfg``: one a layer under flash."""
    return cfg.n_layers if cfg.attn == "flash" else 0


def first_difference(decode, params, cfg, prompt, plain, spec, device):
    """None for equal streams; else where ``spec`` first leaves ``plain``:
    the plain stream's prefix up to that index is scored by a solo
    ``prefill``, and the index, both tokens, their logits there and the
    relative margin (the difference over the larger magnitude) come
    back."""
    plain, spec = [int(t) for t in plain], [int(t) for t in spec]
    check(len(plain) == len(spec),
          f"speculative stream of {len(spec)} tokens against {len(plain)}")
    i = next((i for i, (a, b) in enumerate(zip(plain, spec)) if a != b), None)
    if i is None:
        return None
    ctx = torch.as_tensor(np.concatenate([np.asarray(prompt), plain[:i]]),
                          device=device)[None].long()
    with torch.no_grad():
        logits, _ = decode.prefill(params, decode.init_kv_cache(
            cfg, 1, ctx.shape[1], device), ctx, cfg)
    row = logits[0, -1].float()
    a, b = row[plain[i]].item(), row[spec[i]].item()
    return {"index": i, "plain": [plain[i], a], "spec": [spec[i], b],
            "margin": abs(a - b) / max(abs(a), abs(b), 1e-30)}


def near_tie(decode, params, cfg, prompt, plain, spec, device):
    """The near-tie rule for greedy bf16 streams that should equal plain
    decoding's. Greedy speculation emits the target's argmax exactly, but
    its verify span (k + 1 rows) and plain decoding (1 row) are different
    GEMM shapes (and tensor-parallel ranks sum partial products), so an
    argmax whose top two logits nearly tie may flip. Where ``spec`` differs
    from ``plain``, the two tokens' logits at the first difference
    (:func:`first_difference`) must lie within 1/32 of the larger one's
    magnitude, else the run fails. Returns :func:`first_difference`'s
    record."""
    tie = first_difference(decode, params, cfg, prompt, plain, spec, device)
    if tie is None:
        return None
    print(json.dumps({"near_tie": tie}))
    check(tie["margin"] <= 1 / 32, f"a greedy stream left plain decoding "
          f"at token {tie['index']} without a near tie: {tie}")
    return tie


def timed(fn, device):
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def phase_spec_solo(attention, decode, spec_decode, workload,
                    target="llama_like_big", draft="llama_like", prompt_len=64,
                    steps=127, device="cuda"):
    """Solo speculation at full width: ``target`` (bf16, flash) from a
    seeded ``prompt_len``-token prompt, ``steps`` steps, k = 4, through
    ``decode.generate``, ``speculative_generate`` with a self-draft (the
    ceiling) and with ``draft`` as the draft (same vocabulary), each timed
    (fenced) with its K1 launches counted: one a layer for each prefill of
    a flash model, after an untimed 8-step run of the same call (the first
    use of a span shape pays set-up the steady state does not). The greedy
    streams meet :func:`near_tie`. Then a self-draft ``speculative_sample``
    (temperature 0.8, top_p 0.95) run twice with one key gives identical
    tokens. Returns the launches."""
    cfg = getattr(workload.ModelConfig, target)()
    dcfg = getattr(workload.ModelConfig, draft)()
    params = seeded_params(workload, cfg, device)
    dparams = seeded_params(workload, dcfg, device, seed=1)
    prompt_np = np.random.default_rng(17).integers(0, cfg.vocab, prompt_len)
    prompt = torch.as_tensor(prompt_np, device=device)[None].long()
    runs, launches = {}, {}
    decode.generate(params, prompt, cfg, 8)
    attention.FLASH_FWD_LAUNCHES = 0
    plain, elapsed = timed(lambda: decode.generate(params, prompt, cfg,
                                                   steps), device)
    launches["generate"] = attention.FLASH_FWD_LAUNCHES
    check(launches["generate"] == flash_layers(cfg),
          f"generate: {launches['generate']} flash launches")
    plain = plain[0].cpu().numpy()
    runs["generate"] = {"target_calls": steps + 1,
                        "tokens_per_s": (steps + 1) / elapsed,
                        "elapsed_s": elapsed}
    for name, (dp, dc) in (("self_draft", (params, cfg)),
                           (draft, (dparams, dcfg))):
        spec_decode.speculative_generate(params, cfg, dp, dc, prompt, 8,
                                         k=SPEC_K)
        attention.FLASH_FWD_LAUNCHES = 0
        (toks, stats), elapsed = timed(
            lambda: spec_decode.speculative_generate(
                params, cfg, dp, dc, prompt, steps, k=SPEC_K), device)
        launches[name] = attention.FLASH_FWD_LAUNCHES
        check(launches[name] == flash_layers(cfg) + flash_layers(dc),
              f"speculative_generate ({name}): {launches[name]} flash "
              f"launches")
        check(toks.shape == (1, steps + 1)
              and bool(((toks >= 0) & (toks < cfg.vocab)).all()),
              f"speculative_generate ({name}): tokens {toks.shape}")
        check(stats["plain_calls"] == steps + 1
              and stats["accepted"] <= stats["drafted"], f"stats {stats}")
        runs[name] = {**stats, "tokens_per_s": (steps + 1) / elapsed,
                      "elapsed_s": elapsed, "near_tie": near_tie(
                          decode, params, cfg, prompt_np, plain, toks[0],
                          device)}
    check(runs["self_draft"]["target_calls"] < steps + 1,
          "a self-draft saved no target call")
    sampled = []
    for _ in range(2):
        attention.FLASH_FWD_LAUNCHES = 0
        (toks, stats), elapsed = timed(
            lambda: spec_decode.speculative_sample(
                params, cfg, params, cfg, prompt, steps, 2024, k=SPEC_K,
                temperature=0.8, top_p=0.95), device)
        launches["sampled_self_draft"] = attention.FLASH_FWD_LAUNCHES
        check(launches["sampled_self_draft"] == 2 * flash_layers(cfg),
              "speculative_sample: flash launches")
        sampled.append((toks, {**stats, "tokens_per_s": (steps + 1) / elapsed,
                               "elapsed_s": elapsed}))
    check(np.array_equal(sampled[0][0], sampled[1][0]),
          "speculative_sample is not repeatable for one key")
    print(json.dumps({
        "speculative": target, "draft": draft, "prompt_len": prompt_len,
        "steps": steps, "k": SPEC_K, "flash_launches": launches, **runs,
        "sampled_self_draft": [st for _, st in sampled]}))
    return launches


def drain_traced(eng, label, device, at=10, times=None, until=None):
    """Drain ``eng`` tick by tick as ``run_until_drained`` does (or stop
    once its tick count reaches ``until``), tracing the tick numbered
    ``at`` (:func:`trace_summary`, with the active slots); returns the
    trace and the fenced wall time of the untraced ticks, each of which is
    also appended to ``times`` when given."""
    trace, untraced_s = None, 0.0
    while ((eng.queue or any(r is not None for r in eng.req))
           and (until is None or eng.tick_count < until)):
        if eng.tick_count == at and label:
            with profiler() as prof:
                wall = fenced_s(eng.tick)
            trace = trace_summary(prof, label, wall, tick=at, active=sum(
                r is not None for r in eng.req))
        else:
            tick_s = fenced_s(eng.tick)
            untraced_s += tick_s
            if times is not None:
                times.append(tick_s)
        check(eng.tick_count < 100_000, "serving did not drain")
    return trace, untraced_s


def serve_speculative(attention, serve, params, cfg, dparams, dcfg, reqs,
                      geometry, device, trace_label=None, **kw):
    """One drain of ``reqs`` through a warmed speculative engine, as a user
    drives it, K1 launches counted (one a layer for each target and each
    draft prefill of a flash model); with ``trace_label`` its tenth round
    is traced (:func:`drain_traced`). Returns the completions' tokens by
    rid, the engine's spec_stats, ticks and fenced drain seconds (the
    traced round left out), the launches and the trace."""
    attention.FLASH_FWD_LAUNCHES = 0
    eng = serve.ServeEngine(params, cfg, draft_params=dparams,
                            draft_cfg=dcfg, spec_k=SPEC_K, device=device,
                            **geometry, **kw)
    eng.warmup()
    for r in reqs:
        eng.submit(r)
    trace, drain_s = drain_traced(eng, trace_label, device)
    done = eng.completions
    sync(device)
    launches = attention.FLASH_FWD_LAUNCHES
    want = flash_layers(cfg) * eng.prefills + flash_layers(
        dcfg) * eng.draft_prefills
    check(launches == want, f"speculative serving: {launches} flash launches "
          f"for {eng.prefills} target and {eng.draft_prefills} draft "
          f"prefills")
    check_completions(done, reqs, cfg.vocab, "speculative serving")
    return ({c.rid: c.tokens for c in done}, dict(eng.spec_stats),
            eng.tick_count, drain_s,
            {"target": flash_layers(cfg) * eng.prefills,
             "draft": flash_layers(dcfg) * eng.draft_prefills}, trace)


def phase_spec_serving(attention, decode, serve, workload, mono,
                       target="llama_like_big", draft="llama_like",
                       geometry=SERVE_GEOMETRY, device="cuda"):
    """Speculative serving at full width: phase 3's requests and geometry,
    spec_k = 4, with a self-draft and with ``draft``, each drained once as a
    user drives it (launches counted; tokens against phase 3's plain
    engine's ``mono`` by :func:`near_tie`) and once through
    ``measure_serving`` (rounds, accepted/drafted, tokens/s, max tick gap).
    A self-draft needs fewer rounds than plain serving ticks. The tenth
    round of each user drain, and the tenth tick of a plain engine's drain
    of the same traffic, are traced. Then request-keyed sampled
    speculative serving with a self-draft, drained twice: identical
    tokens. Returns the launches of the greedy drains."""
    cfg = getattr(workload.ModelConfig, target)()
    dcfg = getattr(workload.ModelConfig, draft)()
    params = seeded_params(workload, cfg, device)
    dparams = seeded_params(workload, dcfg, device, seed=1)
    reqs = make_requests(cfg, serve)
    out, launches = {}, {}
    keys = ("tokens_per_s", "ticks", "occupancy", "max_tick_gap_s",
            "elapsed_s")
    eng = serve.ServeEngine(params, cfg, device=device, **geometry)
    eng.warmup()
    for r in reqs:
        eng.submit(r)
    drain_traced(eng, f"{target} plain serving tick", device)
    del eng
    for name, (dp, dc) in (("self_draft", (params, cfg)),
                           (draft, (dparams, dcfg))):
        tokens, stats, ticks, _, launches[name], _ = serve_speculative(
            attention, serve, params, cfg, dp, dc, reqs, geometry, device,
            trace_label=f"{target} speculative round, {name}")
        ties = {rid: near_tie(decode, params, cfg, reqs[rid].prompt,
                              mono["tokens"][rid], toks, device)
                for rid, toks in tokens.items()}
        attention.FLASH_FWD_LAUNCHES = 0
        m = serve.measure_serving(cfg, params, reqs, draft_params=dp,
                                  draft_cfg=dc, spec_k=SPEC_K, device=device,
                                  **geometry)
        check(attention.FLASH_FWD_LAUNCHES == flash_layers(cfg) * m[
            "prefills"] + flash_layers(dc) * m["draft_prefills"],
              "speculative measure_serving: flash launches")
        check(m["tokens"] == sum(r.max_new_tokens for r in reqs),
              "speculative measure_serving lost tokens")
        check(m["spec_rounds"] == stats["rounds"]
              and m["spec_accepted"] == stats["accepted"],
              f"measure_serving's rounds {m} against the user's {stats}")
        out[name] = {**{k: m[k] for k in keys},
                     **{k: m[k] for k in m if k.startswith("spec_")},
                     "user_drain_ticks": ticks, "flash_launches":
                     launches[name], "near_ties": {
                         rid: t for rid, t in ties.items() if t}}
    check(out["self_draft"]["spec_rounds"] < mono["stats"]["ticks"],
          f"self-draft speculative serving took "
          f"{out['self_draft']['spec_rounds']} rounds against "
          f"{mono['stats']['ticks']} plain ticks")
    sampled = [serve_speculative(attention, serve, params, cfg, params, cfg,
                                 reqs, geometry, device, temperature=0.8,
                                 top_p=0.95, seed=7, request_keyed=True)
               for _ in range(2)]
    check(all(np.array_equal(sampled[0][0][rid], sampled[1][0][rid])
              for rid in sampled[0][0]),
          "request-keyed sampled speculative serving is not repeatable")
    n_tokens = sum(r.max_new_tokens for r in reqs)
    print(json.dumps({
        "speculative_serving": target, "draft": draft, "spec_k": SPEC_K,
        "requests": len(reqs), **out,
        "plain": {k: mono["stats"][k] for k in keys},
        "sampled_self_draft": {"spec_stats": sampled[0][1],
                               "ticks": sampled[0][2],
                               "drain_tokens_per_s": [n_tokens / x[3]
                                                      for x in sampled],
                               "flash_launches": sampled[0][4]}}))
    return launches


def phase_spec_parity(attention, decode, serve, spec_decode, workload,
                      device="cuda"):
    """Speculation on tiny f32 (flash, TF32 off), exact: for an exact and an
    int8 target arena and a random, a truncated (the target's first layer)
    and a self-draft, the speculative engine == the plain engine == solo
    ``speculative_generate``, each run's K1 launches counted; the
    request-keyed engine == solo ``sample_position_keyed`` with
    ``fold_in(seed, rid)``; the sampled speculative engine == solo
    ``speculative_sample``; a self-draft ``speculative_sample`` ==
    ``sample_position_keyed``. The random draft keeps tiny's head_dim 32,
    which the kernel takes."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(workload.ModelConfig.tiny(), attn="flash")
    params = seeded_params(workload, cfg, device)
    rand_cfg = dataclasses.replace(cfg, n_layers=1, d_ff=64)
    drafts = {"random": (seeded_params(workload, rand_cfg, device, seed=3),
                         rand_cfg),
              "truncated": ({**params, "layers": params["layers"][:1]},
                            dataclasses.replace(cfg, n_layers=1)),
              "self": (params, cfg)}
    rng = np.random.default_rng(2)
    reqs = [serve.Request(
        rid=i, prompt=rng.integers(0, cfg.vocab, size=int(rng.integers(4, 14)),
                                   dtype=np.int32),
        max_new_tokens=int(rng.integers(3, 8))) for i in range(5)]
    geometry = dict(slots=2, max_seq=64, prompt_bucket=16)

    def prompt_of(req):
        return torch.as_tensor(req.prompt, device=device)[None].long()

    def drain(eng):
        for r in reqs:
            eng.submit(r)
        return {c.rid: c.tokens for c in eng.run_until_drained()}

    stats = {}
    for kv in (None, "int8"):
        tcfg = dataclasses.replace(cfg, kv_cache_dtype=kv)
        attention.FLASH_FWD_LAUNCHES = 0
        eng = serve.ServeEngine(params, tcfg, device=device, **geometry)
        plain = drain(eng)
        check(attention.FLASH_FWD_LAUNCHES == flash_layers(cfg) * eng.prefills,
              "tiny plain engine: flash launches")
        for name, (dp, dc) in drafts.items():
            attention.FLASH_FWD_LAUNCHES = 0
            eng = serve.ServeEngine(params, tcfg, draft_params=dp,
                                    draft_cfg=dc, spec_k=3, device=device,
                                    **geometry)
            got = drain(eng)
            check(attention.FLASH_FWD_LAUNCHES == flash_layers(cfg)
                  * eng.prefills + flash_layers(dc) * eng.draft_prefills,
                  f"tiny speculative engine ({name}): flash launches")
            stats[f"{kv or 'exact'} {name}"] = dict(eng.spec_stats)
            for r in reqs:
                attention.FLASH_FWD_LAUNCHES = 0
                solo, _ = spec_decode.speculative_generate(
                    params, tcfg, dp, dc, prompt_of(r), r.max_new_tokens - 1,
                    k=3)
                check(attention.FLASH_FWD_LAUNCHES
                      == flash_layers(cfg) + flash_layers(dc),
                      "solo speculative_generate: flash launches")
                check(np.array_equal(got[r.rid], plain[r.rid])
                      and np.array_equal(got[r.rid], solo[0]),
                      f"tiny {kv or 'exact'} {name} request {r.rid}: "
                      f"speculative engine {got[r.rid]}, plain "
                      f"{plain[r.rid]}, solo {solo[0]}")
    check(stats["exact self"]["accepted"] == stats["exact self"]["drafted"],
          "a tiny f32 self-draft was rejected")
    sampling = dict(temperature=0.8, top_k=24)
    keyed = dict(seed=5, request_keyed=True, **sampling)
    got = drain(serve.ServeEngine(params, cfg, device=device, **geometry,
                                  **keyed))
    for r in reqs:
        solo = decode.sample_position_keyed(
            params, prompt_of(r), cfg, r.max_new_tokens - 1,
            decode.fold_in(5, r.rid), **sampling)[0].cpu().numpy()
        check(np.array_equal(got[r.rid], solo), f"request-keyed engine "
              f"request {r.rid}: {got[r.rid]} != solo {solo}")
    for name in ("truncated", "self"):
        dp, dc = drafts[name]
        eng = serve.ServeEngine(params, cfg, draft_params=dp, draft_cfg=dc,
                                spec_k=3, device=device, **geometry, **keyed)
        got = drain(eng)
        stats[f"sampled {name}"] = dict(eng.spec_stats)
        for r in reqs:
            solo, _ = spec_decode.speculative_sample(
                params, cfg, dp, dc, prompt_of(r), r.max_new_tokens - 1,
                decode.fold_in(5, r.rid), k=3, **sampling)
            check(np.array_equal(got[r.rid], solo[0]), f"sampled speculative "
                  f"engine ({name}) request {r.rid}: {got[r.rid]} != solo "
                  f"{solo[0]}")
    for k in (1, 3, 4):
        ref = decode.sample_position_keyed(params, prompt_of(reqs[0]), cfg, 18,
                                           42, **sampling)[0].cpu().numpy()
        got, st = spec_decode.speculative_sample(
            params, cfg, params, cfg, prompt_of(reqs[0]), 18, 42, k=k,
            **sampling)
        check(np.array_equal(got[0], ref) and st["accept_rate"] == 1.0,
              f"self-draft speculative_sample (k={k}) != "
              f"sample_position_keyed")
    print(json.dumps({"speculative parity": "tiny f32 flash", "exact": True,
                      "spec_stats": stats}))


# -- tensor and data parallelism (phases 20-22) ---------------------------------

# what every time of phases 20-22 measures: one card holds every rank
GLOO_NOTE = "gloo through the host, ranks sharing one card"


# -- rank groups side by side (phases 20-34, 39 and 40) ----------------------
#
# Each of these phases spawns gloo rank groups on the card (``tmesh.launch``).
# A phase is a generator: its main-process work runs in the main thread up to
# a ``yield`` of the groups it needs (a tuple of :class:`Group`), which start
# in worker threads as soon as the card's memory admits them, and the phase
# resumes with them once they have all ended. :func:`run_side_by_side` primes
# every phase in phase order, so that every group is queued at once, then
# resumes the phases in phase order: a phase's checks that read an earlier
# phase's results (33 reads 27's, 39 reads 20's, 26's and 32's) run after
# that phase has ended, while the groups themselves depend on nothing but
# phases 3-19. A group's admission figure is its ranks' peak memory reserved
# a rank (GROUP_PEAK_GIB, each printed by that group in an earlier whole run's
# ``rank_groups`` line) plus a CUDA context a rank.

# GiB reserved at each rank's peak, by group label: the
# ``peak_reserved_gib_per_rank`` of the ``rank_groups`` line of a whole run
# (PR 18 call 8; NVIDIA H100 80GB HBM3, 700.00 W); phase 34's groups spawn
# their ranks in ``entry`` and are not sampled: tiny f32, as 25's and 28's
GROUP_PEAK_GIB = {
    "20-22 tp 2": [7.83] * 2, "20-22 tp 4": [1.79] * 4,
    "23 ring": [0.22, 0.28], "24 fsdp x sp": [13.82, 13.82, 13.82, 13.82],
    "25 dryrun": [0.13] * 8, "26 ep train": [8.61] * 4,
    "26 ep serve": [1.83, 1.59], "27 pp": [16.38, 20.63],
    "28 dryrun ep pp": [0.20] * 8, "28 pp flash": [0.14] * 2,
    "29 ckpt mesh": [0.27] * 4, "30 handoff": [1.68] * 2,
    "32 fsdp serving": [6.02] * 2, "33 pp x fsdp": [13.57, 13.57, 19.47,
                                                    19.47],
    "34 dryrun 8": [0.2] * 8, "34 dryrun 6": [0.2] * 6,
    "39 mesh programs": [5.24] * 2, "40 tp 2 adamw": [9.37] * 2,
    "40 fsdp x sp adamw": [16.43, 16.50, 16.48, 16.50],
    "40 dp x ep sgd": [11.58] * 4, "40 pp": [19.58, 26.31],
    "40 tiny accum": [0.19] * 4}
# the phases in the order their groups queue: first phase 40, whose fsdp x
# sp group and phase 33's take the whole card and so run alone before the
# others, then the longest (each group's seconds in the ``rank_groups``
# line), so that the short ones fill the card and the cores around them;
# the checks run in phase order
GROUP_QUEUE_ORDER = ("40", "33", "39", "32", "20-22", "24", "34", "30",
                     "27", "29", "26", "25", "28", "23")
GROUP_MARGIN_GIB = 4.0       # the main process's checks between groups
# a rank still running after this many seconds writes its threads' stacks
# to stderr and exits, failing its group: no group runs near it alone, and
# a hung rank would otherwise hold the script to the call's limit
RANK_DEADLINE_S = 900
# running ranks a CPU core, at most: a rank waiting on the card spins a core
GROUP_MAX_RANKS = 1.5


class LockedLines(io.TextIOBase):
    """``sys.stdout`` for threads that print: each thread's text is kept
    until its line ends, then written whole under one lock."""

    def __init__(self, out):
        import threading
        self.out, self.lock = out, threading.Lock()
        self.local = threading.local()

    def write(self, text: str) -> int:
        pending = getattr(self.local, "pending", "") + text
        head, sep, tail = pending.rpartition("\n")
        self.local.pending = tail
        if sep:
            with self.lock:
                self.out.write(head + sep)
                self.out.flush()
        return len(text)

    def flush(self) -> None:
        self.out.flush()

    @property
    def encoding(self):
        return self.out.encoding


def sampled_rank(mesh, fn, *args):
    """``fn(mesh, *args)`` on one rank with the memory its caching
    allocator reserves sampled every 20 ms: (its result, the peak GiB
    reserved, the larger of the samples and the allocator's own peak).
    Past RANK_DEADLINE_S the rank writes every thread's stack to stderr
    and exits. The rank's host work is the gloo staging, whose copies and
    sums its CPU threads would only contend for with the other groups'
    ranks: one torch thread."""
    import faulthandler
    import threading
    faulthandler.dump_traceback_later(RANK_DEADLINE_S, exit=True)
    torch.set_num_threads(1)
    peak, done = [0], threading.Event()

    def sample():
        while not done.wait(0.02):
            peak[0] = max(peak[0], torch.cuda.memory_reserved())

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        out = fn(mesh, *args)
    finally:
        done.set()
        sampler.join()
    return out, max(peak[0], torch.cuda.max_memory_reserved()) / 2**30


class Group:
    """One rank group of a phase: ``ranks`` gloo ranks on the card that
    ``call()`` runs (a ``tmesh.launch``, blocking) in a worker thread; its
    start and end (seconds since the section began), result or exception,
    and each rank's peak reserved GiB when it reports one."""

    def __init__(self, label: str, ranks: int, call):
        self.label, self.ranks, self.call = label, ranks, call
        self.start = self.end = None
        self.result = self.error = None
        self.peaks = None
        self.section = None

    @property
    def need_gib(self) -> float:
        return (sum(GROUP_PEAK_GIB[self.label])
                + self.ranks * self.section.context_gib)

    def overlapped(self) -> list:
        """The groups that were on the card while this one was."""
        return [g.label for g in self.section.groups if g is not self
                and g.start is not None and g.start < self.end
                and (g.end is None or g.end > self.start)]

    def note(self) -> dict:
        """For a line that prints this group's gloo times: who shared the
        card and the host with it."""
        return {"overlapping_groups": self.overlapped(),
                "overlap_note": "gloo times taken while other rank groups "
                                "shared the card and the host's "
                                f"{os.cpu_count()} cores"
                if self.overlapped() else "no other rank group ran"}


def spawn(label: str, fn, sizes: dict, *args) -> Group:
    """A group of ``fn(mesh, *args)`` on every rank of ``sizes`` (gloo, the
    card), each rank's memory sampled (:func:`sampled_rank`); its result
    the ranks' results in rank order."""
    workdir = pathlib.Path(__file__).resolve().parent / "build"
    workdir.mkdir(exist_ok=True)

    def call():
        from tpusched_torch import mesh as tmesh
        out = tmesh.launch(sampled_rank, sizes, fn, *args, backend="gloo",
                           device="cuda", workdir=str(workdir))
        group.peaks = [peak for _, peak in out]
        return [r for r, _ in out]

    group = Group(label, math.prod(sizes.values()), call)
    return group


class Section:
    """The worker threads and the admission of the rank groups: a queued
    group starts, in queue order, once the card's free memory
    (``mem_get_info`` after ``empty_cache``) and the section's budget (the
    free memory when it began, less GROUP_MARGIN_GIB) both cover its
    ``need_gib`` beside the groups running, and the running ranks stay
    within GROUP_MAX_RANKS a core."""

    def __init__(self):
        import threading
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        # this process's memory outside its allocator: the context, its
        # loaded modules and libraries, as each rank will hold them
        self.context_gib = (total - free - torch.cuda.memory_reserved()) \
            / 2**30
        self.budget_gib = free / 2**30 - GROUP_MARGIN_GIB
        self.max_ranks = int(GROUP_MAX_RANKS * (os.cpu_count() or 1))
        self.t0 = time.perf_counter()
        self.groups: list = []
        self.queue: list = []
        self.cond = threading.Condition()
        self.failed = None
        self.closed = False
        self.thread = threading.Thread(target=self._admit, daemon=True)
        self.thread.start()

    def submit(self, groups) -> None:
        with self.cond:
            for g in groups:
                check(g.label in GROUP_PEAK_GIB, f"no admission figure for "
                      f"rank group {g.label!r}")
                g.section = self
                self.groups.append(g)
                self.queue.append(g)
            self.cond.notify_all()

    def _running(self) -> list:
        return [g for g in self.groups
                if g.start is not None and g.end is None]

    def _admit(self) -> None:
        try:
            self._admit_loop()
        except BaseException as e:         # raised in the main thread
            with self.cond:
                self.failed = e
                self.cond.notify_all()

    def _admit_loop(self) -> None:
        import threading
        while True:
            with self.cond:
                if self.closed:
                    return
                running = self._running()
                held = sum(g.need_gib for g in running)
                ranks = sum(g.ranks for g in running)
                start = None
                for g in self.queue:
                    # alone, a group starts whatever it asks: it ran alone
                    # before the groups ran side by side
                    if not running or (
                            held + g.need_gib <= self.budget_gib
                            and ranks + g.ranks <= self.max_ranks):
                        start = g
                        break
                if start is not None:
                    torch.cuda.empty_cache()
                    free = torch.cuda.mem_get_info()[0] / 2**30
                    if free < start.need_gib + GROUP_MARGIN_GIB and running:
                        start = None
                if start is None:
                    self.cond.wait(0.5)
                    continue
                self.queue.remove(start)
                start.start = time.perf_counter() - self.t0
            threading.Thread(target=self._run, args=(start,),
                             daemon=True).start()

    def _run(self, g: Group) -> None:
        try:
            g.result = g.call()
        except BaseException as e:            # raised in the main thread
            g.error = e
        with self.cond:
            g.end = time.perf_counter() - self.t0
            self.cond.notify_all()
        print(json.dumps({"rank_group_ended": g.label, "start_s": g.start,
                          "end_s": g.end, "peak_reserved_gib_per_rank":
                          g.peaks, "failed": g.error is not None}),
              file=sys.stderr, flush=True)

    def wait(self, groups) -> tuple:
        """Block until every group of ``groups`` has ended; raise the first
        one's exception, if any."""
        with self.cond:
            while any(g.end is None for g in groups) and self.failed is None:
                self.cond.wait(0.5)
        if self.failed is not None:
            raise RuntimeError("the rank groups' admission failed") \
                from self.failed
        for g in groups:
            if g.error is not None:
                raise RuntimeError(f"rank group {g.label!r} failed") \
                    from g.error
        return tuple(groups)

    def close(self, ok: bool) -> None:
        """Stop admitting; after a failure, end every rank still running."""
        import multiprocessing
        with self.cond:
            self.closed = True
            self.cond.notify_all()
        if not ok:
            for child in multiprocessing.active_children():
                child.terminate()

    def line(self) -> dict:
        return {"rank_groups": [
            {"label": g.label, "ranks": g.ranks, "start_s": g.start,
             "end_s": g.end, "overlapped": g.overlapped(),
             "admitted_at_gib": g.need_gib,
             "peak_reserved_gib_per_rank": g.peaks} for g in self.groups],
            "cpu_count": os.cpu_count(), "context_gib": self.context_gib,
            "budget_gib": self.budget_gib, "margin_gib": GROUP_MARGIN_GIB,
            "max_ranks": self.max_ranks,
            "section_s": time.perf_counter() - self.t0}


def run_side_by_side(phases: dict, results: dict) -> dict:
    """Every phase generator of ``phases`` (name -> generator, in phase
    order) run to its end with its groups side by side on the card: each
    primed in GROUP_QUEUE_ORDER (its work up to its first groups, which
    are queued at once), then resumed in turn whenever its groups have
    ended, in phase order. Fills ``results`` with each phase's return value and returns
    the section's line (the ``rank_groups`` line). Any failure ends every
    rank and is raised."""
    section = Section()
    waiting = {}
    ok = False
    try:
        for name in sorted(phases, key=lambda n: (
                GROUP_QUEUE_ORDER.index(n) if n in GROUP_QUEUE_ORDER
                else len(GROUP_QUEUE_ORDER))):
            _advance(section, name, phases[name], None, results, waiting)
        for name, gen in phases.items():
            while name in waiting:
                groups = section.wait(waiting[name])
                _advance(section, name, gen, groups, results, waiting)
        ok = True
    finally:
        section.close(ok)
    return section.line()


def _advance(section, name, gen, groups, results, waiting) -> None:
    """``gen`` resumed with ``groups`` (primed when None) up to its next
    yield, whose groups are queued, or to its end."""
    waiting.pop(name, None)
    try:
        wanted = gen.send(groups) if groups is not None else next(gen)
    except StopIteration as stop:
        results[name] = stop.value
        return
    waiting[name] = tuple(wanted)
    section.submit(waiting[name])
# phase 21's GQA variant of tiny: head_dim 32, 4 heads over 2 KV heads, so
# each rank at tp = 2 runs the flash kernel on 2 heads over 1
TINY_GQA = dict(d_model=128, n_heads=4, n_kv_heads=2, attn="flash")
TRAIN_LOSS_RTOL = 2e-2       # bf16: the repo's tolerance for bf16 losses


def tp_serve(mesh, name):
    """One rank's drain of phase 3's traffic and geometry on the preset
    ``name`` at full width (phase 3's weights, from the same seeded
    generator), as a user drives the engine on ``mesh``; the flash kernel's
    launches counted from the engine's construction. The peak memory is
    taken after the whole weights are dropped: the rank's shards, its share
    of the arena and the drain."""
    from tpusched_torch import attention, serve, workload
    cfg = getattr(workload.ModelConfig, name)()
    reqs = make_requests(cfg, serve)
    attention.FLASH_FWD_LAUNCHES = 0
    eng = serve.ServeEngine(seeded_params(workload, cfg), cfg, mesh=mesh,
                            **SERVE_GEOMETRY)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.warmup()
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    check_completions(done, reqs, cfg.vocab, f"{name} on {mesh.shape}")
    return dict(launches=attention.FLASH_FWD_LAUNCHES, prefills=eng.prefills,
                ticks=eng.tick_count, kv_heads=int(eng.cache[0]["k"].shape[2]),
                tokens={c.rid: c.tokens for c in done},
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30,
                drain_s=drain_s, segments=program_segments(eng))


def all_reduce_ms(mesh) -> dict:
    """One rank's time of an f32 sum over the tp axis through the mesh's
    collective, a decode tick's size (64 KiB) and a 1024-row prefill's
    (8 MiB), 5 calls after 1 warm, each ended by a synchronize; then the
    same sum's parts, each fenced, 5 times: the copy to the host, gloo's
    sum of the host tensors and the copy back (``split``, ms each)."""
    import torch.distributed as dist
    from tpusched_torch.mesh import all_reduce
    out = {}
    for label, n in (("64KiB", 1 << 14), ("8MiB", 1 << 21)):
        x = torch.ones(n, device="cuda")
        all_reduce(x, mesh.tp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            all_reduce(x, mesh.tp)
        torch.cuda.synchronize()
        out[label] = (time.perf_counter() - t0) / 5 * 1e3
        parts = np.zeros(3)
        for _ in range(5):
            t = [time.perf_counter()]
            host = x.to("cpu")
            t.append(time.perf_counter())
            dist.all_reduce(host, group=mesh.tp.group)
            t.append(time.perf_counter())
            x.copy_(host)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            parts += np.diff(t)
        out[f"{label}_split"] = dict(zip(
            ("to_host_ms", "gloo_host_sum_ms", "to_card_ms"),
            (parts / 5 * 1e3).tolist()))
    return out


def tp_tiny_parity(mesh):
    """Phase 21 on one rank: tiny f32 (TINY_GQA, TF32 off) at tp = 2 against
    the unsharded engine and solo generation, token for token, for plain,
    chunked (5 rows), prefix (12 tokens, chunked), int8, greedy self-draft
    speculation (spec_k 3), request-keyed sampling (solo: the keyed
    sampler with the request's key) and 4 experts (the MoE rank-partial
    sums exact in f32); each engine's flash launches are held to its
    prefills. Returns each mode's tp tokens and launches."""
    from tpusched_torch import attention, decode, serve, workload
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = dataclasses.replace(workload.ModelConfig.tiny(), **TINY_GQA)
    params = seeded_params(workload, base)
    rng = np.random.default_rng(2)
    reqs = [serve.Request(
        rid=i, prompt=rng.integers(0, base.vocab, size=int(rng.integers(4, 14)),
                                   dtype=np.int32),
        max_new_tokens=int(rng.integers(3, 8))) for i in range(5)]
    prefix = rng.integers(0, base.vocab, 12, dtype=np.int32)
    keyed = dict(temperature=0.8, top_k=24, seed=5, request_keyed=True)
    modes = {  # mode -> (cfg, engine kwargs, registered prefix)
        "plain": (base, {}, False),
        "chunked": (base, dict(chunk_prefill=5), False),
        "prefix": (base, dict(chunk_prefill=5), True),
        "int8": (dataclasses.replace(base, kv_cache_dtype="int8"), {}, False),
        "speculative": (base, dict(draft_params=params, draft_cfg=base,
                                   spec_k=3), False),
        "request_keyed": (base, keyed, False),
        "moe": (dataclasses.replace(base, n_experts=4), {}, False)}
    out = {}
    for mode, (cfg, kw, use_prefix) in modes.items():
        weights = seeded_params(workload, cfg) if cfg.n_experts else params
        mreqs = [dataclasses.replace(r, prefix_id="sys")
                 if use_prefix and r.rid % 2 == 0 else r for r in reqs]
        runs, launches = {}, None
        for label, m in (("tp", mesh), ("whole", None)):
            attention.FLASH_FWD_LAUNCHES = 0
            eng = serve.ServeEngine(weights, cfg, mesh=m, device="cuda",
                                    slots=2, max_seq=64, prompt_bucket=16,
                                    **kw)
            if use_prefix:
                eng.register_prefix("sys", prefix)
            for r in mreqs:
                eng.submit(r)
            runs[label] = {c.rid: c.tokens.tolist()
                           for c in eng.run_until_drained()}
            want = cfg.n_layers * (eng.prefills + eng.draft_prefills
                                   + use_prefix)
            check(attention.FLASH_FWD_LAUNCHES == want,
                  f"tiny {mode} {label}: {attention.FLASH_FWD_LAUNCHES} "
                  f"flash launches, wanted {want}")
            launches = launches if launches is not None else want
        solo = {}
        for r in mreqs:
            full = (np.concatenate([prefix, r.prompt]) if r.prefix_id
                    else r.prompt)
            toks = torch.as_tensor(full, device="cuda")[None].long()
            if mode == "request_keyed":
                got = decode.sample_position_keyed(
                    weights, toks, cfg, r.max_new_tokens - 1,
                    decode.fold_in(keyed["seed"], r.rid),
                    temperature=keyed["temperature"], top_k=keyed["top_k"])
            else:
                got = decode.generate(weights, toks, cfg,
                                      steps=r.max_new_tokens - 1)
            solo[r.rid] = got[0].cpu().tolist()
        check(runs["tp"] == runs["whole"] == solo,
              f"tiny f32 {mode}: tp {runs['tp']} != unsharded "
              f"{runs['whole']} != solo {solo}")
        out[mode] = dict(tokens=runs["tp"], flash_launches=launches)
    return out


def tp_tiny_train(mesh):
    """Phase 22's exact half on one rank of a dp2×tp2 ``mesh``: three AdamW
    steps (lr 1e-3) of tiny f32 (TINY_GQA, remat, TF32 off) on one global
    batch of 4, sharded and whole, launches counted per step; the losses
    within 1e-5 relative, and every gathered parameter leaf within 1e-5
    relative L2 (:func:`grad_rel_err`, as phase 5 holds gradients) of the
    whole model's. Then the vocab-parallel loss of
    this rank's batch share against the replicated-logits loss of the same
    shards."""
    from tpusched_torch import attention, optim, workload
    from tpusched_torch.mesh import local_chunk
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(workload.ModelConfig.tiny(), **TINY_GQA,
                              remat=True)
    tokens = torch.as_tensor(np.random.default_rng(9).integers(
        0, cfg.vocab, (4, cfg.seq)), device="cuda")
    want = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    runs = {}
    for label, m in (("whole", None), ("sharded", mesh)):
        params = seeded_params(workload, cfg)
        step, init_opt, _, _ = workload.make_optax_train_step(
            m, cfg, optim.adamw(1e-3))
        if m is not None:
            params = workload.shard_params(params, cfg, m)
        state = init_opt(params)
        losses = []
        for _ in range(3):
            zero_counts(attention)
            params, state, loss = step(params, state, tokens)
            losses.append(loss.item())
            check(bwd_counts(attention) == want,
                  f"tiny {label} step launched {bwd_counts(attention)}, "
                  f"wanted {want}")
        if m is not None:
            params = workload.gather_params(params, cfg, m)
        runs[label] = (losses, workload.tree_leaves(params))
    (losses, got), (ref_losses, ref) = runs["sharded"], runs["whole"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    leaf_rel = grad_rel_err(got, ref)
    check(loss_rel <= 1e-5 and leaf_rel <= 1e-5,
          f"tiny dp2xtp2 AdamW: losses {losses} against {ref_losses} "
          f"(rel {loss_rel:.3e}), worst leaf rel L2 {leaf_rel:.3e} (tol "
          f"1e-5)")
    vp = dataclasses.replace(cfg, vocab_parallel_loss=True)
    params = seeded_params(workload, cfg)
    local = local_chunk(tokens, mesh.batch, 0)
    with torch.no_grad():
        vp_loss = workload.loss_fn(workload.shard_params(params, vp, mesh),
                                   local, vp, tp=mesh.tp).item()
        rep_loss = workload.loss_fn(workload.shard_params(params, cfg, mesh),
                                    local, cfg, tp=mesh.tp).item()
    check(abs(vp_loss - rep_loss) <= 1e-5 * abs(rep_loss),
          f"vocab-parallel loss {vp_loss} != replicated {rep_loss}")
    return dict(losses=losses, whole_losses=ref_losses, loss_rel=loss_rel,
                worst_leaf_rel_l2=leaf_rel, vocab_parallel_loss=vp_loss,
                replicated_loss=rep_loss, launches_per_step=want)


def tp2_rank(mesh):
    """Everything phases 20-22 run on the tp = 2 ranks, in one spawn."""
    from tpusched_torch import attention, optim, workload
    out = {"all_reduce_ms": all_reduce_ms(mesh),
           "llama_like_big": tp_serve(mesh, "llama_like_big"),
           "mixtral_like": tp_serve(mesh, "mixtral_like"),
           "tiny": tp_tiny_parity(mesh)}
    torch.cuda.empty_cache()
    out["train"] = train_big(attention, optim, workload, mesh)
    return out


def tp4_rank(mesh):
    """Everything phases 20-22 run on four ranks: tp = 4 serving, then the
    same ranks as a dp2×tp2 mesh for the tiny training."""
    from tpusched_torch import mesh as tmesh
    out = {"all_reduce_ms": all_reduce_ms(mesh),
           "llama_like_big": tp_serve(mesh, "llama_like_big")}
    torch.cuda.empty_cache()
    out["tiny_train"] = tp_tiny_train(
        tmesh.build_named_mesh({"dp": 2, "tp": 2}, "gloo", "cuda"))
    return out


def ranks_agree(ranks, key, what):
    """Every rank's completions of ``key`` equal rank 0's."""
    for r, out in enumerate(ranks[1:], 1):
        a, b = ranks[0][key]["tokens"], out[key]["tokens"]
        check(a.keys() == b.keys() and all(np.array_equal(a[i], b[i])
                                           for i in a),
              f"{what}: rank {r}'s completions differ from rank 0's")


def phase_tp(attention, decode, serve, workload, mono, moe_mono, train):
    """Phases 20-22 (module docstring): two groups of gloo ranks sharing
    the card, then the checks against phases 3, 6 and 8. Returns the
    per-rank launches for the kernels line."""
    t0 = time.perf_counter()
    two_g, four_g = yield (spawn("20-22 tp 2", tp2_rank, {"tp": 2}),
                           spawn("20-22 tp 4", tp4_rank, {"tp": 4}))
    two, four = two_g.result, four_g.result
    cfg = workload.ModelConfig.llama_like_big()
    params = None
    per_prefill = cfg.n_layers
    for tp, ranks, group in ((2, two, two_g), (4, four, four_g)):
        ranks_agree(ranks, "llama_like_big", f"llama_like_big at tp {tp}")
        runs = [r["llama_like_big"] for r in ranks]
        for run in runs:
            check(run["launches"] == per_prefill * run["prefills"] == 216,
                  f"tp {tp}: {run['launches']} flash launches for "
                  f"{run['prefills']} prefills")
            check(run["kv_heads"] == cfg.kv_heads // tp, "arena heads")
            check_segments(run["segments"], f"llama_like_big at tp {tp}")
        ties = {}
        for rid, toks in runs[0]["tokens"].items():
            if not np.array_equal(toks, mono["tokens"][rid]):
                if params is None:
                    params = seeded_params(workload, cfg)
                ties[rid] = near_tie(decode, params, cfg,
                                     make_requests(cfg, serve)[rid].prompt,
                                     mono["tokens"][rid], toks, "cuda")
        print(json.dumps({
            "tp_serving": "llama_like_big", "tp": tp, "ranks": tp,
            "backend": "gloo", "ranks_agree": True,
            "flash_launches_per_rank": [r["launches"] for r in runs],
            "prefills": runs[0]["prefills"], "ticks": runs[0]["ticks"],
            "unsharded_ticks": mono["stats"]["ticks"],
            "streams_equal_to_phase_3": len(runs[0]["tokens"]) - len(ties),
            "near_ties": ties,
            "peak_mem_gib_per_rank": [r["peak_mem_gib"] for r in runs],
            "unsharded_peak_mem_gib": mono["peak_mem_gib"],
            "drain_s_per_rank": [r["drain_s"] for r in runs],
            "all_reduce_ms_per_rank": [r["all_reduce_ms"] for r in ranks],
            "segments": runs[0]["segments"], "drain_s_note": GLOO_NOTE,
            **group.note()}))
    del params
    ranks_agree(two, "mixtral_like", "mixtral_like at tp 2")
    moe = [r["mixtral_like"] for r in two]
    check(all(r["launches"] == 0 for r in moe),
          "mixtral_like at tp 2 launched the flash kernel")
    for run in moe:
        check_segments(run["segments"], "mixtral_like at tp 2")
    # reported, not held: a bf16 rounding difference may flip a top-2
    # route, which moves the logits by more than a near tie (phase 21
    # holds the MoE tp path exact in f32)
    moe_cfg = workload.ModelConfig.mixtral_like()
    moe_params = seeded_params(workload, moe_cfg)
    moe_reqs = make_requests(moe_cfg, serve)
    moe_diff = {rid: first_difference(decode, moe_params, moe_cfg,
                                      moe_reqs[rid].prompt,
                                      moe_mono["tokens"][rid], toks, "cuda")
                for rid, toks in moe[0]["tokens"].items()}
    del moe_params
    print(json.dumps({
        "tp_serving": "mixtral_like", "tp": 2, "backend": "gloo",
        "ranks_agree": True, "flash_launches_per_rank":
        [r["launches"] for r in moe], "ticks": moe[0]["ticks"],
        "streams_equal_to_phase_8": sum(d is None for d in moe_diff.values()),
        "first_differences": {rid: d for rid, d in moe_diff.items() if d},
        "peak_mem_gib_per_rank": [r["peak_mem_gib"] for r in moe],
        "unsharded_peak_mem_gib": moe_mono["peak_mem_gib"],
        "drain_s_per_rank": [r["drain_s"] for r in moe],
        "segments": moe[0]["segments"], "drain_s_note": GLOO_NOTE,
        **two_g.note()}))
    for mode in two[0]["tiny"]:
        check(two[0]["tiny"][mode] == two[1]["tiny"][mode],
              f"tiny {mode}: the ranks disagree")
        print(f"tp 2 engine == unsharded engine == solo on tiny f32 "
              f"(d_model 128, 4 heads over 2) flash, {mode}: ranks agree, "
              f"flash launches {two[0]['tiny'][mode]['flash_launches']} "
              f"per rank")
    runs = [r["train"] for r in two]
    check(runs[0]["losses"] == runs[1]["losses"],
          f"tp training: the ranks' losses differ: {runs}")
    rel = [abs(a - b) / abs(b) for a, b in zip(runs[0]["losses"],
                                               train["losses"])]
    check(max(rel) <= TRAIN_LOSS_RTOL,
          f"tp 2 losses {runs[0]['losses']} against phase 6's "
          f"{train['losses']}: rel {rel} (tol {TRAIN_LOSS_RTOL})")
    print(json.dumps({
        "tp_training": "llama_like_big", "seq": 4096, "batch": 1, "tp": 2,
        "backend": "gloo", "optimizer": "adamw lr 1e-4 mu f32",
        "losses": runs[0]["losses"], "phase_6_losses": train["losses"],
        "loss_rel_diff": rel, "loss_rtol": TRAIN_LOSS_RTOL,
        "launches_per_step_per_rank": dict(zip(
            ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"),
            runs[0]["per_step"])),
        "peak_mem_gib_per_rank": [r["peak_mem_gib"] for r in runs],
        "phase_6_peak_mem_gib": train["peak_mem_gib"],
        "step_s_per_rank": [r["step_s"] for r in runs],
        "step_s_note": GLOO_NOTE, **two_g.note()}))
    tiny = [r["tiny_train"] for r in four]
    check(all(t["losses"] == tiny[0]["losses"] for t in tiny),
          "tiny dp2xtp2: the ranks' losses differ")
    print(json.dumps({"tp_training": "tiny f32 dp2xtp2", "steps": 3,
                      **tiny[0]}))
    print(json.dumps({"phases_20_22_s": time.perf_counter() - t0}))
    return {"two": two, "four": four}


# -- phases 23-25: fully-sharded and sequence-parallel training -----------------

RING_CHUNK = (1, 4096, 16, 4, 128)      # phase 24's per-rank share at sp = 2
SP_MESH = {"fsdp": 2, "sp": 2}          # phase 24
DRYRUN_MESH = {"fsdp": 2, "sp": 2, "tp": 2}   # phase 25, the reference's


def launches_since(attention, start):
    """(K1, K2, K3) launches since the counts were ``start``."""
    return tuple(c - s for c, s in zip(bwd_counts(attention), start))


def ring_pair_backward(attention, tile=1e-3):
    """Phase 23's first check: K2 and K3 non-causal at RING_CHUNK bf16 on
    the pair (resident chunk 1, visiting chunk 0) of a two-chunk sequence,
    with the lse and D of the whole ring (the diagonal pair's and the
    visiting pair's forward combined), not the pair's own; against the
    plain version with the same lse and D, and bitwise equal when run
    twice. Returns the max abs errors (dq, max of dk and dv)."""
    b, s, h, kv, d = RING_CHUNK
    gen = torch.Generator(device="cuda").manual_seed(23)
    q, k1, v1 = rand_qkv(gen, b, s, h, kv, d, torch.bfloat16)
    _, k0, v0 = rand_qkv(gen, b, s, h, kv, d, torch.bfloat16)
    do = torch.randn((b, s, h, d), generator=gen, device="cuda").to(q.dtype)
    out1, lse1 = attention.flash_forward(q, k1, v1, True)
    out0, lse0 = attention.flash_forward(q, k0, v0, False)
    o, lse = attention._combine_partials(
        attention._to_bh(out1).float(), lse1, attention._to_bh(out0).float(),
        lse0)
    out = attention._from_bh(o.to(q.dtype), b, h).contiguous()
    check((lse - lse0).min().item() > 0, "the ring's lse is the pair's own")
    dd = attention._to_bh((do.float() * out.float()).sum(dim=-1,
                                                        keepdim=True))
    got = attention._flash_backward(q, k0, v0, out, lse, do, False, dd)
    again = attention._flash_backward(q, k0, v0, out, lse, do, False, dd)
    torch.cuda.synchronize()
    check(all(torch.equal(x, y) for x, y in zip(got, again)),
          "K2/K3 with the ring's lse and D are not bitwise repeatable")
    ref = attention.flash_backward_plain(q, k0, v0, out, lse, do, False, dd)
    errs = []
    for name, x, y in zip(("dq", "dk", "dv"), got, ref):
        l2 = tile_rel_l2(x, y, floor=tile)
        errs.append((x.float() - y.float()).abs().max().item())
        print(f"ring pair backward {RING_CHUNK} bf16 non-causal, the ring's "
              f"lse and D, {name}: worst-tile rel L2 {l2:.3e} (tol 2e-2), "
              f"max|err| {errs[-1]:.3e}, bitwise repeatable")
        check(l2 < 2e-2, f"K2/K3 {name} with the ring's lse and D disagree "
              f"with their plain version")
    return errs[0], max(errs[1:])


def ring_inputs(seed, b, s, h, kv, d, dtype, outlier=False):
    """The whole sequence's q, k, v and dO from a seeded generator on the
    card: every rank makes the same ones and keeps its chunk. With
    ``outlier`` the second half's keys ×100 (tiny f32)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = rand_qkv(gen, b, s, h, kv, d, dtype)
    do = torch.randn((b, s, h, d), generator=gen, device="cuda").to(dtype)
    if outlier:
        k = k.clone()
        k[:, s // 2:] *= 100.0
    return q, k, v, do


RING_CASES = {  # name -> ring_inputs arguments
    "chunk": (24, 1, 2 * RING_CHUNK[1], *RING_CHUNK[2:], torch.bfloat16),
    "outlier": (25, 2, 64, 2, 2, 64, torch.float32, True),
}


def ring_rank(mesh):
    """Phase 23 on one rank of {"sp": 2}: ring-flash on this rank's chunk
    of each RING_CASES sequence, out and the gradients of (out · dO)
    through the ring's backward, with the rank's K1/K2/K3 launches; back to
    the parent on the host."""
    from tpusched_torch import attention
    out = {}
    for name, args in RING_CASES.items():
        q, k, v, do = (x.chunk(2, dim=1)[mesh.sp.index].contiguous()
                       for x in ring_inputs(*args))
        q, k, v = (x.requires_grad_(True) for x in (q, k, v))
        start = bwd_counts(attention)
        o = attention.ring_flash_attention(q, k, v, mesh.sp, True)
        o.backward(do)
        torch.cuda.synchronize()
        out[name] = {"index": mesh.sp.index,
                     "launches": launches_since(attention, start),
                     **{n: t.detach().cpu() for n, t in
                        (("out", o), ("dq", q.grad), ("dk", k.grad),
                         ("dv", v.grad))}}
    return out


def ring_plain(attention) -> dict:
    """Phase 23's references, by RING_CASES name: the plain version's out,
    dq, dk and dv of the whole sequence (run before the rank groups: the
    whole (s, s) scores of 8192 positions take tens of GiB)."""
    refs = {}
    for name, args in RING_CASES.items():
        q, k, v, do = ring_inputs(*args)
        out, lse = attention.flash_attention_plain(q, k, v, True)
        refs[name] = dict(zip(("dq", "dk", "dv"),
                              attention.flash_backward_plain(
                                  q, k, v, out, lse, do, True)), out=out)
        del q, k, v, do, lse, out
        torch.cuda.empty_cache()
    return refs


def phase_ring(attention, pair_err, refs):
    """Phase 23: the kernels in the ring's way. K2/K3 with the ring's lse
    and D (:func:`ring_pair_backward`, ``pair_err``, run before the rank
    groups); then ring-flash on two gloo ranks at RING_CHUNK, causal,
    against the plain version of the whole sequence (``refs``,
    :func:`ring_plain`; out: worst 64-row tile 1e-2; dq, dk, dv: 2e-2),
    rank r launching K1, K2 and K3 1 + r times each; then the
    masked-outlier input in f32: gradients finite and within 3e-3 +
    2e-3·|plain| of the plain version's. Returns the pair's max abs
    errors."""
    t0 = time.perf_counter()
    group, = yield (spawn("23 ring", ring_rank, {"sp": 2}),)
    ranks = group.result
    for name in RING_CASES:
        ref = refs.pop(name)
        for r, rank in enumerate(ranks):
            got = rank[name]
            check(got["index"] == r and got["launches"] == (1 + r,) * 3,
                  f"ring {name}: rank {r} launched (K1, K2, K3) "
                  f"{got['launches']}, wanted {(1 + r,) * 3}")
            for key in ("out", "dq", "dk", "dv"):
                x = got[key].to("cuda")
                y = ref[key].chunk(2, dim=1)[r]
                check(bool(torch.isfinite(x).all()),
                      f"ring {name} {key}: not finite on rank {r}")
                if name == "outlier":
                    bad = ((x.float() - y.float()).abs()
                           > 3e-3 + 2e-3 * y.float().abs()).sum().item()
                    msg = f"{bad} entries outside 3e-3 + 2e-3|plain|"
                    ok = bad == 0
                else:
                    tol = 1e-2 if key == "out" else 2e-2
                    l2 = tile_rel_l2(x, y, floor=1e-3)
                    msg = f"worst-tile rel L2 {l2:.3e} (tol {tol})"
                    ok = l2 < tol
                print(f"ring-flash sp 2 {name} rank {r} {key}: {msg}, max|err| "
                      f"{(x.float() - y.float()).abs().max().item():.3e}")
                check(ok, f"ring-flash {name} {key} disagrees with the plain "
                      f"version on rank {r}")
        del ref
    print(json.dumps({"ring_kernels": "phase 23", "chunk": list(RING_CHUNK),
                      "launches_per_rank": [r["chunk"]["launches"]
                                            for r in ranks],
                      "pair_backward_max_abs_err": pair_err,
                      "phase_23_s": time.perf_counter() - t0}))
    return pair_err


def sp_big_cfg(workload):
    """Phase 24's model: llama_like_big at seq 8192 (remat on, as the
    preset has it)."""
    return workload.ModelConfig.llama_like_big(seq=2 * RING_CHUNK[1])


def sp_big_tokens(cfg):
    """Phase 24's global batch: two seeded rows of the whole sequence."""
    return torch.as_tensor(np.random.default_rng(24).integers(
        0, cfg.vocab, (2, cfg.seq)), device="cuda")


def sp_big_steps(attention, optim, workload, cfg, mesh=None, steps=3):
    """AdamW (lr 1e-4, mu f32) of ``cfg`` on :func:`sp_big_tokens`, on one
    process or as this rank's shards on ``mesh``: the losses, step times,
    each step's (K1, K2, K3) launches, the peak memory of the steps and,
    on a mesh, whether every fsdp-sharded leaf holds half its whole
    size."""
    params = seeded_params(workload, cfg)
    whole = [t.numel() for t in workload.tree_leaves(params)]
    tokens = sp_big_tokens(cfg)
    step, init_opt, specs, _ = workload.make_optax_train_step(
        mesh, cfg, optim.adamw(1e-4, mu_dtype=torch.float32))
    halves = None
    if mesh is not None:
        params = workload.shard_params(params, cfg, mesh)
        torch.cuda.empty_cache()
        sharded = [t.numel() for t in workload.tree_leaves(params)]
        fsdp = workload.tree_leaves(workload.tree_map(
            lambda _, spec: "fsdp" in spec, params, specs))
        halves = all(n * 2 == w if f else n == w for n, w, f in
                     zip(sharded, whole, fsdp))
    state = init_opt(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, launches = [], [], []
    for _ in range(steps):
        zero_counts(attention)
        t0 = time.perf_counter()
        params, state, loss = step(params, state, tokens)
        losses.append(loss.item())
        step_s.append(time.perf_counter() - t0)
        launches.append(bwd_counts(attention))
    return dict(losses=losses, step_s=step_s, launches=launches,
                fsdp_halves=halves,
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)


def fsdp_sp_rank(mesh):
    """Phase 24 on one rank of SP_MESH: :func:`sp_big_steps` with
    ring-flash attention."""
    from tpusched_torch import attention, optim, workload
    cfg = dataclasses.replace(sp_big_cfg(workload), attn="ringflash")
    return {"sp_index": mesh.sp.index, "fsdp_index": mesh.fsdp.index,
            **sp_big_steps(attention, optim, workload, cfg, mesh)}


def phase_fsdp_sp(workload, train, ref):
    """Phase 24: full-width llama_like_big(seq=8192) on SP_MESH, four gloo
    ranks sharing the card, three AdamW steps with ring-flash attention,
    against the same weights and batch on one process with whole-sequence
    flash attention (``ref``, :func:`sp_big_steps` run before the rank
    groups). Held: every step's loss within 2e-2 of the one-process run's
    and falling; per rank and step K1 2·12·(1 + sp index), K2 = K3 =
    12·(1 + sp index); every fsdp leaf a rank holds half its whole size.
    Returns the launches per step by sp index."""
    t0 = time.perf_counter()
    cfg = sp_big_cfg(workload)
    group, = yield (spawn("24 fsdp x sp", fsdp_sp_rank, SP_MESH),)
    ranks = group.result
    layers = cfg.n_layers
    for r, run in enumerate(ranks):
        i = run["sp_index"]
        want = (2 * layers * (1 + i), layers * (1 + i), layers * (1 + i))
        check(all(c == want for c in run["launches"]),
              f"fsdp x sp rank {r} (sp index {i}) launched (K1, K2, K3) "
              f"{run['launches']} a step, wanted {want}")
        check(run["fsdp_halves"], f"rank {r}: an fsdp leaf is not half its "
              f"whole size")
        check(run["losses"] == ranks[0]["losses"],
              f"fsdp x sp: the ranks' losses differ: {run['losses']}")
    losses = ranks[0]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"fsdp x sp loss did not fall: {losses}")
    check(max(rel) <= TRAIN_LOSS_RTOL,
          f"fsdp x sp losses {losses} against one process's {ref['losses']}:"
          f" rel {rel} (tol {TRAIN_LOSS_RTOL})")
    by_index = {run["sp_index"]: run["launches"][0] for run in ranks}
    print(json.dumps({
        "fsdp_sp_training": "llama_like_big", "seq": cfg.seq, "batch": 2,
        "mesh": SP_MESH, "attn": "ringflash", "backend": "gloo",
        "optimizer": "adamw lr 1e-4 mu f32", "losses": losses,
        "one_process_losses": ref["losses"], "loss_rel_diff": rel,
        "loss_rtol": TRAIN_LOSS_RTOL,
        "launches_per_step_by_sp_index": {
            i: dict(zip(("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"), c))
            for i, c in sorted(by_index.items())},
        "fsdp_leaves_half": True,
        "peak_mem_gib_per_rank": [r["peak_mem_gib"] for r in ranks],
        "one_process_peak_mem_gib": ref["peak_mem_gib"],
        "phase_6_peak_mem_gib": train["peak_mem_gib"],
        "step_s_per_rank": [r["step_s"] for r in ranks],
        "one_process_step_s": ref["step_s"], "step_s_note": GLOO_NOTE,
        **group.note(), "phase_24_s": time.perf_counter() - t0}))
    return by_index


def dryrun_cfg(workload, attn):
    """Phase 25's model: tiny f32 with TINY_GQA's heads (4 over 2, so 2
    over 1 at tp = 2), remat on."""
    return dataclasses.replace(workload.ModelConfig.tiny(),
                               **{**TINY_GQA, "attn": attn}, remat=True)


def dryrun_tokens(cfg):
    return torch.as_tensor(np.random.default_rng(25).integers(
        0, cfg.vocab, (4, cfg.seq)), device="cuda")


def dryrun_rank(mesh):
    """Phase 25 on one rank of DRYRUN_MESH: one SGD step each with the ring
    and with ring-flash (TF32 off); the losses and this rank's launches."""
    from tpusched_torch import attention, workload
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"sp_index": mesh.sp.index}
    for attn in ("ring", "ringflash"):
        cfg = dryrun_cfg(workload, attn)
        step, _, _ = workload.make_sharded_train_step(mesh, cfg)
        params = workload.shard_params(seeded_params(workload, cfg), cfg,
                                       mesh)
        zero_counts(attention)
        _, loss = step(params, dryrun_tokens(cfg))
        out[attn] = {"loss": loss.item(), "launches": bwd_counts(attention)}
    return out


def phase_dryrun(workload):
    """Phase 25: tiny f32 on the reference's dryrun mesh DRYRUN_MESH, eight
    gloo ranks: one SGD step with the ring and with ring-flash, each loss
    within 1e-5 relative of the whole model's with naive attention; K1
    2·2·(1 + sp index) a rank with ring-flash (K2 = K3 half that), none
    with the ring."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dryrun_cfg(workload, "naive")
    with torch.no_grad():
        whole = workload.loss_fn(seeded_params(workload, cfg),
                                 dryrun_tokens(cfg), cfg).item()
    group, = yield (spawn("25 dryrun", dryrun_rank, DRYRUN_MESH),)
    ranks = group.result
    layers = cfg.n_layers
    for r, run in enumerate(ranks):
        i = run["sp_index"]
        for attn, want in (("ring", (0, 0, 0)), ("ringflash", (
                2 * layers * (1 + i), layers * (1 + i), layers * (1 + i)))):
            got = run[attn]
            rel = abs(got["loss"] - whole) / abs(whole)
            check(rel <= 1e-5, f"dryrun {attn} rank {r}: loss {got['loss']} "
                  f"against the whole model's {whole} (rel {rel:.3e})")
            check(got["launches"] == want, f"dryrun {attn} rank {r}: "
                  f"launched {got['launches']}, wanted {want}")
    print(json.dumps({
        "dryrun": "tiny f32", "mesh": DRYRUN_MESH, "backend": "gloo",
        "whole_naive_loss": whole,
        "losses": {a: ranks[0][a]["loss"] for a in ("ring", "ringflash")},
        "ringflash_launches_by_sp_index": {
            run["sp_index"]: run["ringflash"]["launches"] for run in ranks}}))



# -- phases 26-28: expert and pipeline parallelism -------------------------------

EP_MESH = {"dp": 2, "ep": 2}            # phase 26's training
EP_SERVE_MESH = {"ep": 2}               # phase 26's serving
EP_LR = 0.1                             # phase 10's SGD
PP_MESH = {"pp": 2}                     # phase 27
PP_MICRO = 4
PP_LR = 1.0
DRYRUN_MOE_MESH = {"dp": 2, "ep": 2, "tp": 2}   # phase 28, the reference's
DRYRUN_PP_MESH = {"pp": 2, "dp": 4}


def ep_cfg(workload):
    """Phase 26's training model: phase 10's mixtral_like(seq=1024)."""
    return workload.ModelConfig.mixtral_like(seq=1024)


def ep_steps(attention, workload, mesh=None, steps=3):
    """Three SGD steps (lr EP_LR) of :func:`ep_cfg` on a seeded global batch
    of 2 rows through make_sharded_train_step, on one process or as this
    rank's shards on ``mesh``: the losses, step times, flash launches of
    the steps, the aux after them (the global batch's), the experts a rank
    holds and the peak memory of the steps."""
    cfg = ep_cfg(workload)
    params = seeded_params(workload, cfg)
    tokens = torch.as_tensor(np.random.default_rng(26).integers(
        0, cfg.vocab, (2, cfg.seq)), device="cuda")
    step, _, _ = workload.make_sharded_train_step(mesh, cfg, lr=EP_LR)
    ts = workload.TrainShardings(mesh, cfg)
    if mesh is not None:
        params = workload.shard_params(params, cfg, mesh)
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(attention)
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        params, loss = step(params, tokens)
        losses.append(loss.item())             # the fence
        step_s.append(time.perf_counter() - t0)
    launches = bwd_counts(attention)
    peak = torch.cuda.max_memory_allocated() / 2**30
    with torch.no_grad():
        _, aux = workload.forward(params, ts.local(tokens), cfg,
                                  with_aux=True, moe=ts.moe)
    return dict(losses=losses, step_s=step_s, launches=launches,
                aux=aux.item(), experts=params["layers"][0]["w_gate"].shape[0],
                peak_mem_gib=peak)


def ep_train_rank(mesh):
    from tpusched_torch import attention, workload
    return ep_steps(attention, workload, mesh)


def ep_serve_rank(mesh):
    return {"mixtral_like": tp_serve(mesh, "mixtral_like")}


def phase_ep(decode, serve, workload, moe_mono, moe_train, ref):
    """Phase 26: expert parallelism at full width, gloo ranks sharing the
    card. Training: :func:`ep_steps` on one process (``ref``, run before
    the rank groups), then on EP_MESH (four ranks): losses within 2e-2 of
    the one process's and falling, a positive aux, E/ep experts a rank, no
    flash launch (mixtral_like attends naively). Serving: phase 8's
    traffic on EP_SERVE_MESH: the ranks agree, every stream equals phase
    8's or first differs at a near tie, no flash launch."""
    t0 = time.perf_counter()
    cfg = ep_cfg(workload)
    train_g, serve_g = yield (spawn("26 ep train", ep_train_rank, EP_MESH),
                              spawn("26 ep serve", ep_serve_rank,
                                    EP_SERVE_MESH))
    ranks = train_g.result
    want_experts = cfg.n_experts // EP_MESH["ep"]
    for r, run in enumerate(ranks):
        check(run["launches"] == (0, 0, 0),
              f"ep rank {r} launched the flash kernels {run['launches']}")
        check(run["experts"] == want_experts,
              f"ep rank {r} holds {run['experts']} experts, wanted "
              f"{want_experts}")
        check(run["losses"] == ranks[0]["losses"],
              f"ep: the ranks' losses differ: {run['losses']}")
    losses = ranks[0]["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"ep loss did not fall: {losses}")
    check(max(rel) <= TRAIN_LOSS_RTOL,
          f"ep losses {losses} against one process's {ref['losses']}: rel "
          f"{rel} (tol {TRAIN_LOSS_RTOL})")
    check(np.isfinite(ranks[0]["aux"]) and ranks[0]["aux"] > 0,
          f"ep aux {ranks[0]['aux']}")
    print(json.dumps({
        "ep_training": "mixtral_like", "seq": cfg.seq, "batch": 2,
        "mesh": EP_MESH, "backend": "gloo", "optimizer": f"sgd lr {EP_LR}",
        "capacity": workload.moe_capacity(cfg, 2 * cfg.seq),
        "losses": losses, "one_process_losses": ref["losses"],
        "loss_rel_diff": rel, "loss_rtol": TRAIN_LOSS_RTOL,
        "aux": ranks[0]["aux"], "one_process_aux": ref["aux"],
        "experts_per_rank": want_experts,
        "flash_launches_per_rank": [r["launches"] for r in ranks],
        "peak_mem_gib_per_rank": [r["peak_mem_gib"] for r in ranks],
        "one_process_peak_mem_gib": ref["peak_mem_gib"],
        "phase_10_peak_mem_gib": moe_train["peak_mem_gib"],
        "step_s_per_rank": [r["step_s"] for r in ranks],
        "one_process_step_s": ref["step_s"], "step_s_note": GLOO_NOTE,
        **train_g.note()}))
    served = serve_g.result
    ranks_agree(served, "mixtral_like", "mixtral_like on ep 2")
    runs = [r["mixtral_like"] for r in served]
    check(all(r["launches"] == 0 for r in runs),
          "mixtral_like on ep 2 launched the flash kernel")
    moe_cfg = workload.ModelConfig.mixtral_like()
    for run in runs:
        check_segments(run["segments"], "mixtral_like on ep 2")
    params = seeded_params(workload, moe_cfg)
    reqs = make_requests(moe_cfg, serve)
    ties = {}
    for rid, toks in runs[0]["tokens"].items():
        tie = near_tie(decode, params, moe_cfg, reqs[rid].prompt,
                       moe_mono["tokens"][rid], toks, "cuda")
        if tie is not None:
            ties[rid] = tie
    del params
    print(json.dumps({
        "ep_serving": "mixtral_like", "mesh": EP_SERVE_MESH,
        "backend": "gloo", "ranks_agree": True,
        "flash_launches_per_rank": [r["launches"] for r in runs],
        "ticks": runs[0]["ticks"], "unsharded_ticks":
        moe_mono["stats"]["ticks"],
        "streams_equal_to_phase_8": len(runs[0]["tokens"]) - len(ties),
        "near_ties": ties,
        "peak_mem_gib_per_rank": [r["peak_mem_gib"] for r in runs],
        "unsharded_peak_mem_gib": moe_mono["peak_mem_gib"],
        "drain_s_per_rank": [r["drain_s"] for r in runs],
        "segments": runs[0]["segments"], "drain_s_note": GLOO_NOTE,
        **serve_g.note(), "phase_26_s": time.perf_counter() - t0}))
    return runs[0]


def pp_cfg(workload):
    """Phase 27's model: phase 6's llama_like_big(seq=4096) (its remat does
    not apply inside a stage)."""
    return workload.ModelConfig.llama_like_big(seq=4096)


def pp_tokens(cfg):
    """Phase 27's global batch: four seeded rows."""
    return torch.as_tensor(np.random.default_rng(27).integers(
        0, cfg.vocab, (4, cfg.seq)), device="cuda")


def pp_rank(mesh, lr=PP_LR, steps=3):
    """Phase 27 on one stage of PP_MESH (phase 33: one rank of
    PP_FSDP_MESH): ``steps`` pipelined SGD steps (lr ``lr``, PP_MICRO
    microbatches) of :func:`pp_cfg` on phase 6's seeded weights, each
    step's (K1, K2, K3) launches counted, and the size of each leaf over
    fsdp against its stage's whole (:func:`fsdp_fractions`)."""
    from tpusched_torch import attention, pipeline, workload
    cfg = pp_cfg(workload)
    step, _, _ = pipeline.make_pipeline_train_step(mesh, cfg, PP_MICRO, lr)
    shards = pipeline.shard_pipeline_params(pipeline.init_pipeline_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"), cfg,
        mesh)
    torch.cuda.empty_cache()
    tokens = pp_tokens(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s, launches = [], [], []
    for _ in range(steps):
        zero_counts(attention)
        t0 = time.perf_counter()
        shards, loss = step(shards, tokens)
        losses.append(loss.item())             # the fence
        step_s.append(time.perf_counter() - t0)
        launches.append(bwd_counts(attention))
    shapes = workload.param_shapes(cfg)
    whole = ({k: (cfg.n_layers, *s) for k, s in shapes["layers"][0].items()},
             shapes["embed"], shapes["out"], shapes["ln_f"])
    halves = fsdp_fractions(workload, list(shards), list(whole), list(
        pipeline.pipeline_param_specs(cfg, mesh)), mesh)
    return dict(stage=mesh.pp.index, rank=mesh.rank,
                fsdp_index=mesh.fsdp.index if mesh.fsdp is not None else 0,
                losses=losses, step_s=step_s, launches=launches,
                fsdp_leaf_fractions=sorted(set(halves)),
                fsdp_leaves=len(halves),
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)


def pp_whole_loss(workload) -> float:
    """Phase 27's reference: one process's loss_fn on its weights and
    batch (run before the rank groups)."""
    cfg = pp_cfg(workload)
    with torch.no_grad():
        whole = workload.loss_fn(seeded_params(workload, cfg),
                                 pp_tokens(cfg), cfg).item()
    torch.cuda.empty_cache()
    return whole


def phase_pp(workload, train, whole):
    """Phase 27: the GPipe pipeline at full width, two gloo ranks (stages)
    sharing the card: every stage launches K1, K2 and K3 (L/pp)·n_micro =
    24 times a step; the first loss within 2e-2 of one process's loss_fn
    on the same weights and batch (``whole``, :func:`pp_whole_loss`), the
    losses falling and equal on both stages. Returns the launches a stage
    a step, the losses and the peak memory a stage."""
    t0 = time.perf_counter()
    cfg = pp_cfg(workload)
    group, = yield (spawn("27 pp", pp_rank, PP_MESH),)
    ranks = group.result
    per = cfg.n_layers // PP_MESH["pp"] * PP_MICRO
    for run in ranks:
        check(all(c == (per, per, per) for c in run["launches"]),
              f"pp stage {run['stage']} launched (K1, K2, K3) "
              f"{run['launches']} a step, wanted {per} each")
        check(run["losses"] == ranks[0]["losses"],
              f"pp: the stages' losses differ: {run['losses']}")
    losses = ranks[0]["losses"]
    rel = abs(losses[0] - whole) / abs(whole)
    check(rel <= TRAIN_LOSS_RTOL, f"pp first loss {losses[0]} against one "
          f"process's loss_fn {whole}: rel {rel} (tol {TRAIN_LOSS_RTOL})")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"pp loss did not fall: {losses}")
    print(json.dumps({
        "pp_training": "llama_like_big", "seq": cfg.seq, "batch": 4,
        "n_micro": PP_MICRO, "mesh": PP_MESH, "backend": "gloo",
        "optimizer": f"sgd lr {PP_LR}", "losses": losses,
        "one_process_loss": whole, "first_loss_rel_diff": rel,
        "loss_rtol": TRAIN_LOSS_RTOL,
        "launches_per_step_per_stage": dict(zip(
            ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"), (per,) * 3)),
        "peak_mem_gib_per_stage": [r["peak_mem_gib"] for r in ranks],
        "phase_6_peak_mem_gib": train["peak_mem_gib"],
        "step_s_per_stage": [r["step_s"] for r in ranks],
        "step_s_note": GLOO_NOTE, **group.note(),
        "phase_27_s": time.perf_counter() - t0}))
    return dict(per=per, losses=losses, peak_mem_gib_per_stage=[
        r["peak_mem_gib"] for r in ranks])


def dryrun_moe_cfg(workload, cf):
    """Phase 28's MoE model: the reference dryrun's tiny with 4 experts,
    top-2, at capacity factor ``cf``."""
    return dataclasses.replace(workload.ModelConfig.tiny(), n_experts=4,
                               moe_top_k=2, moe_capacity_factor=cf)


def dryrun_pp_tokens(cfg, rows):
    return torch.as_tensor(np.random.default_rng(28).integers(
        0, cfg.vocab, (rows, cfg.seq)), device="cuda")


def dryrun_moe_pp_rank(mesh):
    """Phase 28 on one of eight ranks: one SGD step of the MoE model on
    DRYRUN_MOE_MESH at capacity factors 1.25 and 0.5, then one pipelined
    SGD step of tiny (2 layers, n_micro 2) on DRYRUN_PP_MESH over the same
    ranks; the losses (TF32 off)."""
    from tpusched_torch import mesh as tmesh, pipeline, workload
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    for cf in (1.25, 0.5):
        cfg = dryrun_moe_cfg(workload, cf)
        step, _, _ = workload.make_sharded_train_step(mesh, cfg)
        params = workload.shard_params(seeded_params(workload, cfg), cfg,
                                       mesh)
        out[f"moe_cf{cf}"] = step(params, dryrun_tokens(cfg))[1].item()
    pp = tmesh.build_named_mesh(DRYRUN_PP_MESH, "gloo", "cuda")
    cfg = workload.ModelConfig.tiny()
    step, _, _ = pipeline.make_pipeline_train_step(pp, cfg, 2)
    shards = pipeline.shard_pipeline_params(pipeline.init_pipeline_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"), cfg, pp)
    out["pp"] = step(shards, dryrun_pp_tokens(cfg, 8))[1].item()
    return out


# phase 28's flash pipeline: tiny at 4 layers, so a stage holds 2
PP_FLASH_LAYERS, PP_FLASH_MICRO, PP_FLASH_LR = 4, 2, 1e3


def pp_flash_rank(mesh):
    """Phase 28's flash half on one stage of PP_MESH: one pipelined SGD
    step of tiny f32 (4 layers) with flash and with naive attention on the
    same weights and batch (TF32 off); each run's loss, (K1, K2, K3)
    launches and gradients, read off the update (lr PP_FLASH_LR: the
    update dwarfs the weights' rounding; the step updates the shards in
    place, so their values before it are kept)."""
    from tpusched_torch import attention, pipeline, workload
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"stage": mesh.pp.index}
    for attn in ("flash", "naive"):
        cfg = dataclasses.replace(workload.ModelConfig.tiny(), attn=attn,
                                  remat=True, n_layers=PP_FLASH_LAYERS)
        step, _, _ = pipeline.make_pipeline_train_step(
            mesh, cfg, PP_FLASH_MICRO, PP_FLASH_LR)
        shards = pipeline.shard_pipeline_params(
            pipeline.init_pipeline_params(
                cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"),
            cfg, mesh)
        before = [t.clone() for t in workload.tree_leaves(list(shards))]
        zero_counts(attention)
        new, loss = step(shards, dryrun_pp_tokens(cfg, 4))
        grads = [((p - n) / PP_FLASH_LR).cpu() for p, n in zip(
            before, workload.tree_leaves(list(new)))]
        out[attn] = {"loss": loss.item(), "launches": bwd_counts(attention),
                     "grads": grads}
    return out


def phase_dryrun_ep_pp(workload):
    """Phase 28: tiny f32 on the reference dryrun's MoE and pipeline meshes
    (eight gloo ranks), each loss within 1e-5 relative of the whole
    model's; the 0.5 capacity factor drops slots (the whole model's loss
    moves from the one with room for all); then a tiny flash pipeline on
    PP_MESH: K1, K2 and K3 (L/pp)·n_micro times a stage, none with naive
    attention, and every gradient leaf within 1e-5 relative L2 of the
    naive pipeline's. Returns the flash launches a stage."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    whole = {}
    with torch.no_grad():
        for cf in (1.25, 0.5, 100.0):
            cfg = dryrun_moe_cfg(workload, cf)
            whole[f"moe_cf{cf}"] = workload.loss_fn(
                seeded_params(workload, cfg), dryrun_tokens(cfg), cfg).item()
        cfg = workload.ModelConfig.tiny()
        whole["pp"] = workload.loss_fn(seeded_params(workload, cfg),
                                       dryrun_pp_tokens(cfg, 8), cfg).item()
    check(abs(whole["moe_cf0.5"] - whole["moe_cf100.0"]) > 1e-4,
          f"capacity factor 0.5 drops no slot: {whole}")
    moe_g, flash_g = yield (
        spawn("28 dryrun ep pp", dryrun_moe_pp_rank, DRYRUN_MOE_MESH),
        spawn("28 pp flash", pp_flash_rank, PP_MESH))
    ranks = moe_g.result
    rels = {}
    for name in ("moe_cf1.25", "moe_cf0.5", "pp"):
        rels[name] = max(abs(r[name] - whole[name]) / abs(whole[name])
                         for r in ranks)
        check(rels[name] <= 1e-5, f"dryrun {name}: losses "
              f"{[r[name] for r in ranks]} against the whole model's "
              f"{whole[name]} (rel {rels[name]:.3e}, tol 1e-5)")
    stages = flash_g.result
    per = PP_FLASH_LAYERS // PP_MESH["pp"] * PP_FLASH_MICRO
    worst = 0.0
    for run in stages:
        check(run["flash"]["launches"] == (per, per, per)
              and run["naive"]["launches"] == (0, 0, 0),
              f"pp flash stage {run['stage']}: launched "
              f"{run['flash']['launches']} (naive "
              f"{run['naive']['launches']}), wanted {per} each")
        check(abs(run["flash"]["loss"] - run["naive"]["loss"])
              <= 1e-5 * abs(run["naive"]["loss"]),
              f"pp flash loss {run['flash']['loss']} against naive "
              f"{run['naive']['loss']}")
        worst = max(worst, grad_rel_err(run["flash"]["grads"],
                                        run["naive"]["grads"]))
    check(worst <= 1e-5, f"pp flash gradients against naive: worst leaf rel "
          f"L2 {worst:.3e} (tol 1e-5)")
    print(json.dumps({
        "dryrun_ep_pp": "tiny f32", "moe_mesh": DRYRUN_MOE_MESH,
        "pp_mesh": DRYRUN_PP_MESH, "backend": "gloo", "whole_losses": whole,
        "losses": {n: ranks[0][n] for n in ("moe_cf1.25", "moe_cf0.5",
                                            "pp")},
        "loss_rel_diff": rels, "pp_flash": {
            "mesh": PP_MESH, "layers": PP_FLASH_LAYERS,
            "n_micro": PP_FLASH_MICRO, "launches_per_stage": per,
            "loss": stages[0]["flash"]["loss"],
            "naive_loss": stages[0]["naive"]["loss"],
            "worst_grad_rel_l2": worst},
        "phase_28_s": time.perf_counter() - t0}))
    return per


# -- phases 29-31: checkpoint and resume, the hand-off to serving, calibrate
# -- and the HBM budget --------------------------------------------------------

CHIPWORK = pathlib.Path(__file__).resolve().parent / ".chipwork"
CKPT_RTOL = 1e-6             # phase 29's resumed losses against uninterrupted
# phase 29's mesh changes, tiny f32: name -> (saved on, restored onto,
# experts), over the four ranks of the first
CKPT_MESHES = {"dense": ({"dp": 2, "tp": 2}, {"fsdp": 2, "tp": 2}, 0),
               "moe": ({"dp": 2, "ep": 2}, {"ep": 4}, 4)}
HANDOFF_MESH = {"tp": 2}     # phase 30's sharded load


def disk_bytes(path) -> int:
    return sum(f.stat().st_size for f in pathlib.Path(path).rglob("*")
               if f.is_file())


def work_dir(prefix: str) -> pathlib.Path:
    """A new directory under the git-ignored ``.chipwork/``."""
    import tempfile
    CHIPWORK.mkdir(exist_ok=True)
    return pathlib.Path(tempfile.mkdtemp(prefix=prefix, dir=CHIPWORK))


def adamw_skeleton(checkpoint, optim, workload, cfg, mu_dtype):
    """The AdamW state's restore skeleton from the parameter skeleton: mu
    in ``mu_dtype``, nu in the parameters' dtype, no tensor made."""
    skel = checkpoint.param_skeleton(cfg)
    return optim.AdamWState(0, workload.tree_map(
        lambda a: dataclasses.replace(a, dtype=mu_dtype), skel), skel)


def ckpt_mesh_rank(mesh, directory):
    """Phase 29's mesh changes on one rank: for each CKPT_MESHES case, tiny
    f32 (TF32 off) SGD, two steps on the first mesh, a save of the shards,
    two more steps (the uninterrupted run), then a restore onto the second
    mesh and two steps there. Returns the losses and the restored shapes."""
    import os
    from tpusched_torch import checkpoint, workload
    from tpusched_torch import mesh as tmesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    meshes = {tuple(mesh.shape.items()): mesh}

    def mesh_of(sizes):
        key = tuple(sizes.items())
        if key not in meshes:
            meshes[key] = tmesh.build_named_mesh(sizes, "gloo", "cuda")
        return meshes[key]

    out = {}
    for name, (sa, sb, experts) in CKPT_MESHES.items():
        a, b = mesh_of(sa), mesh_of(sb)
        cfg = dataclasses.replace(workload.ModelConfig.tiny(),
                                  n_experts=experts)
        tokens = torch.as_tensor(np.random.default_rng(11).integers(
            0, cfg.vocab, (4, cfg.seq)), device="cuda")
        step_a, specs_a, _ = workload.make_sharded_train_step(a, cfg)
        shards = workload.shard_params(seeded_params(workload, cfg), cfg, a)
        for _ in range(2):
            shards, _ = step_a(shards, tokens)
        d = os.path.join(directory, name)
        checkpoint.save(d, shards, 2, mesh=a, specs=specs_a)
        base = []
        for _ in range(2):
            shards, loss = step_a(shards, tokens)
            base.append(loss.item())
        step_b, specs_b, _ = workload.make_sharded_train_step(b, cfg)
        restored, saved = checkpoint.restore(d, checkpoint.abstract_state(
            checkpoint.param_skeleton(cfg), specs_b, b), mesh=b)
        layer = restored["layers"][0]
        shapes = {k: list(layer[k].shape) for k in ("wq", "w_gate")}
        resumed = []
        for _ in range(2):
            restored, loss = step_b(restored, tokens)
            resumed.append(loss.item())
        out[name] = dict(base=base, resumed=resumed, saved=saved,
                         shapes=shapes, device=str(layer["wq"].device))
    return out


def checkpoint_alone(attention, checkpoint, data, optim, workload, train):
    """Phase 29's one-process part (module docstring), before the rank
    groups. Returns the trained params (for phase 30), the kernels'
    launches a step and its seconds."""
    t0 = time.perf_counter()
    cfg = workload.ModelConfig.llama_like_big(seq=4096)
    mu_dtype = torch.float32
    step, init_opt, _, _ = workload.make_optax_train_step(
        None, cfg, optim.adamw(1e-4, mu_dtype=mu_dtype))
    want = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    directory = work_dir("ckpt-")

    def run(params, state, batches):
        losses, step_s = [], []
        for tokens in batches:
            zero_counts(attention)
            t = time.perf_counter()
            params, state, loss = step(params, state, tokens)
            losses.append(loss.item())              # the fence
            step_s.append(time.perf_counter() - t)
            check(bwd_counts(attention) == want, f"checkpointed step "
                  f"launched (K1, K2, K3) = {bwd_counts(attention)}, wanted "
                  f"{want}")
        return losses, step_s

    torch.cuda.empty_cache()
    params = seeded_params(workload, cfg)
    state = init_opt(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    stream = iter(data.TokenBatcher(cfg, 1, seed=0, device="cuda"))
    first, _ = run(params, state, (next(stream) for _ in range(2)))
    t = time.perf_counter()
    checkpoint.save(str(directory), params, 2, extra=state)
    save_s = time.perf_counter() - t
    save_bytes = disk_bytes(directory)
    check(checkpoint.latest_step(str(directory)) == 2, "no step 2 saved")
    batches = [next(stream) for _ in range(2)]
    kept = [b.cpu() for b in batches]
    uninterrupted, step_s = run(params, state, batches)
    train_peak = torch.cuda.max_memory_allocated() / 2**30
    del params, state, batches, stream
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params, saved, state = checkpoint.restore(
        str(directory), checkpoint.abstract_state(
            checkpoint.param_skeleton(cfg)),
        abstract_extra=adamw_skeleton(checkpoint, optim, workload, cfg,
                                      mu_dtype), device="cuda")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t
    check(saved == 2 and state.count == 2,
          f"restored step {saved}, AdamW count {state.count}, wanted 2 and 2")
    check(params["embed"].device.type == "cuda", "restore left the card")
    resumed_batches = list(itertools.islice(
        data.TokenBatcher(cfg, 1, seed=0, start_step=2, device="cuda"), 2))
    check(all(torch.equal(a.cpu(), b) for a, b in zip(resumed_batches, kept)),
          "the resumed stream's batches 2-3 differ from the first's")
    resumed, resumed_step_s = run(params, state, resumed_batches)
    resumed_peak = torch.cuda.max_memory_allocated() / 2**30
    rel = [abs(a - b) / abs(b) for a, b in zip(resumed, uninterrupted)]
    check(max(rel) <= CKPT_RTOL, f"resumed losses {resumed} against the "
          f"uninterrupted {uninterrupted}: rel {rel} (tol {CKPT_RTOL})")
    del state
    shutil.rmtree(directory)
    print(json.dumps({
        "checkpoint": "llama_like_big", "seq": cfg.seq, "batch": 1,
        "optimizer": "adamw lr 1e-4 mu f32", "first_losses": first,
        "uninterrupted_losses": uninterrupted, "resumed_losses": resumed,
        "loss_rel_diff": rel, "loss_rtol": CKPT_RTOL,
        "bitwise_equal": resumed == uninterrupted, "restored_count": 2,
        "launches_per_step": dict(zip(
            ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"), want)),
        "save_s": save_s, "save_bytes": save_bytes,
        "save_gib": save_bytes / 2**30, "restore_s": restore_s,
        "step_s": step_s, "resumed_step_s": resumed_step_s,
        "peak_mem_gib": train_peak, "resumed_peak_mem_gib": resumed_peak,
        "phase_6_peak_mem_gib": train["peak_mem_gib"]}))
    torch.cuda.empty_cache()
    return params, want, time.perf_counter() - t0


def phase_checkpoint(workload, alone_s):
    """Phase 29's mesh changes (module docstring), after its one-process
    part (:func:`checkpoint_alone`, ``alone_s`` seconds)."""
    t0 = time.perf_counter() - alone_s
    directory = work_dir("ckpt-mesh-")
    group, = yield (spawn("29 ckpt mesh", ckpt_mesh_rank,
                          CKPT_MESHES["dense"][0], str(directory)),)
    ranks = group.result
    shutil.rmtree(directory)
    worst = {}
    for name in CKPT_MESHES:
        runs = [r[name] for r in ranks]
        check(all(r["resumed"] == runs[0]["resumed"] for r in runs),
              f"{name}: the ranks' resumed losses differ")
        for r in runs:
            check(r["saved"] == 2, f"{name}: restored step {r['saved']}")
            check(r["device"].startswith("cuda"), f"{name}: restored on "
                  f"{r['device']}")
        worst[name] = max(abs(a - b) / abs(b) for r in runs
                          for a, b in zip(r["resumed"], r["base"]))
        check(worst[name] <= 1e-5, f"{name} mesh change: resumed "
              f"{runs[0]['resumed']} against {runs[0]['base']} (rel "
              f"{worst[name]:.3e}, tol 1e-5)")
    cfg_t = workload.ModelConfig.tiny()
    check(ranks[0]["dense"]["shapes"]["wq"] == [cfg_t.d_model // 2] * 2,
          f"dense restored wq {ranks[0]['dense']['shapes']['wq']}")
    check(ranks[0]["moe"]["shapes"]["w_gate"][0] == 1,
          f"moe restored w_gate {ranks[0]['moe']['shapes']['w_gate']}")
    print(json.dumps({
        "checkpoint_mesh_change": "tiny f32", "backend": "gloo",
        "cases": {name: {"saved_on": sa, "restored_onto": sb,
                         "experts": e, "uninterrupted": ranks[0][name]["base"],
                         "resumed": ranks[0][name]["resumed"],
                         "restored_shapes": ranks[0][name]["shapes"],
                         "worst_rel": worst[name]}
                  for name, (sa, sb, e) in CKPT_MESHES.items()},
        "phase_29_s": time.perf_counter() - t0}))


def handoff_rank(mesh, directory):
    """Phase 30's sharded load on one rank: this rank's shards of the
    snapshot through ``load_for_serving(mesh=)``, served with phase 3's
    traffic and geometry as a user drives the engine."""
    from tpusched_torch import attention, checkpoint, serve, workload
    cfg = workload.ModelConfig.llama_like_big()
    t0 = time.perf_counter()
    shards = checkpoint.load_for_serving(directory, cfg, mesh=mesh)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    sharded = all(workload.tree_leaves(workload.tree_map(
        lambda x, whole, spec: tuple(x.shape) == workload.shard_shape(
            whole, spec, mesh), shards, workload.param_shapes(cfg),
        workload.param_specs(cfg, mesh))))
    reqs = make_requests(cfg, serve)
    attention.FLASH_FWD_LAUNCHES = 0
    eng = serve.ServeEngine(shards, cfg, mesh=mesh, **SERVE_GEOMETRY)
    eng.warmup()
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    check_completions(done, reqs, cfg.vocab, f"snapshot on {mesh.shape}")
    return {"llama_like_big": dict(
        tokens={c.rid: c.tokens for c in done}, load_s=load_s,
        launches=attention.FLASH_FWD_LAUNCHES, prefills=eng.prefills,
        sharded=sharded, ticks=eng.tick_count)}


class ReportRecorder:
    """An in-process stand-in for the scheduler's client: keeps what
    ``GoodputReporter`` sends."""

    def __init__(self):
        self.reports = []

    def report_status(self, reports):
        self.reports.extend(reports)


def handoff_alone(attention, checkpoint, measure, serve, workload, params):
    """Phase 30's one-process part (module docstring), before the rank
    groups: the export, the one-card drains of ``params`` and of the
    snapshot, and the goodput reports. Returns what :func:`phase_handoff`
    prints and checks."""
    t0 = time.perf_counter()
    cfg = workload.ModelConfig.llama_like_big()
    directory = work_dir("serving-")
    t = time.perf_counter()
    path = checkpoint.export_for_serving(str(directory), params, cfg, step=4)
    export_s = time.perf_counter() - t
    snapshot_bytes = disk_bytes(path)
    reqs = make_requests(cfg, serve)

    def drain(p):
        eng = serve.ServeEngine(p, cfg, device="cuda", **SERVE_GEOMETRY)
        eng.warmup()
        for r in reqs:
            eng.submit(r)
        done = eng.run_until_drained()
        check_completions(done, reqs, cfg.vocab, "snapshot")
        return {c.rid: c.tokens for c in done}, eng.prefills

    in_memory, _ = drain(params)
    torch.cuda.synchronize()
    t = time.perf_counter()
    loaded = checkpoint.load_for_serving(str(directory), cfg, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t
    check(all(torch.equal(a, b) for a, b in zip(
        workload.tree_leaves(loaded), workload.tree_leaves(params))),
          "the loaded snapshot differs from the params exported")
    attention.FLASH_FWD_LAUNCHES = 0
    got, prefills = drain(loaded)
    launches = attention.FLASH_FWD_LAUNCHES
    check(launches == cfg.n_layers * prefills and launches > 0,
          f"snapshot serving: {launches} flash launches for {prefills} "
          f"prefills")
    differ = [rid for rid in got if not np.array_equal(got[rid],
                                                       in_memory[rid])]
    check(not differ, f"the snapshot's completions differ from the "
          f"in-memory params' for requests {differ}")
    # goodput: one report a harness on phase 13's traffic, monolithic
    prefix, suffixes, gens, arrivals = slo_traffic(cfg.vocab)
    slo_reqs = [serve.Request(rid=i, prompt=np.concatenate([prefix, s]),
                              max_new_tokens=gens[i])
                for i, s in enumerate(suffixes)]
    reports = {}
    for name, fn, args, kw in (
            ("measure_serving", serve.measure_serving, (), {}),
            ("measure_serving_slo", serve.measure_serving_slo, (arrivals,),
             dict(ttft_slo_ticks=SLO_TICKS))):
        client = ReportRecorder()
        rep = measure.GoodputReporter(client, "default/serve-0",
                                      gang="default/serve")
        out = fn(cfg, loaded, slo_reqs, *args, reporter=rep, device="cuda",
                 **SERVE_GEOMETRY, **kw)
        check(rep.sent == 1 and len(client.reports) == 1,
              f"{name}: {len(client.reports)} goodput reports, wanted 1")
        r = client.reports[0]
        check(r.step == int(out["ticks"]), f"{name}: report step {r.step}, "
              f"ticks {out['ticks']}")
        check(abs(r.throughput - out["tokens_per_s"])
              <= 1e-6 * out["tokens_per_s"], f"{name}: report throughput "
              f"{r.throughput} against {out['tokens_per_s']} tokens/s")
        if args:
            check(r.ttft_s == out["ttft_s_p50"], f"{name}: report ttft "
                  f"{r.ttft_s} against ttft_s_p50 {out['ttft_s_p50']}")
        reports[name] = {"report": dataclasses.asdict(r), "ticks":
                         out["ticks"], "tokens_per_s": out["tokens_per_s"],
                         "ttft_s_p50": out.get("ttft_s_p50")}
    torch.cuda.empty_cache()
    return dict(directory=directory, loaded=loaded, got=got, reqs=reqs,
                launches=launches, prefills=prefills, reports=reports,
                snapshot_bytes=snapshot_bytes, export_s=export_s,
                load_s=load_s, seconds=time.perf_counter() - t0)


def phase_handoff(decode, workload, alone):
    """Phase 30's sharded load on two gloo ranks after its one-process
    part (``alone``, :func:`handoff_alone`). Returns K1's launches in the
    one-card drain of the snapshot."""
    t0 = time.perf_counter() - alone["seconds"]
    cfg = workload.ModelConfig.llama_like_big()
    directory, loaded, got = alone["directory"], alone["loaded"], alone["got"]
    reqs, launches, prefills = (alone["reqs"], alone["launches"],
                                alone["prefills"])
    snapshot_bytes, export_s, load_s = (alone["snapshot_bytes"],
                                        alone["export_s"], alone["load_s"])
    reports = alone["reports"]
    group, = yield (spawn("30 handoff", handoff_rank, HANDOFF_MESH,
                          str(directory)),)
    ranks = group.result
    ranks_agree(ranks, "llama_like_big", "the snapshot at tp 2")
    runs = [r["llama_like_big"] for r in ranks]
    check(all(r["sharded"] for r in runs),
          "load_for_serving(mesh=) returned leaves not at their shard shape")
    ties = {}
    for rid, toks in runs[0]["tokens"].items():
        tie = near_tie(decode, loaded, cfg, reqs[rid].prompt, got[rid], toks,
                       "cuda")
        if tie is not None:
            ties[rid] = tie
    shutil.rmtree(directory)
    print(json.dumps({
        "handoff": "llama_like_big", "snapshot_bytes": snapshot_bytes,
        "snapshot_gib": snapshot_bytes / 2**30, "export_s": export_s,
        "load_s": load_s, "requests": len(reqs), "prefills": prefills,
        "flash_launches": launches, "equal_to_in_memory": len(got),
        "tp": {"mesh": HANDOFF_MESH, "backend": "gloo", "ranks_agree": True,
               "load_s_per_rank": [r["load_s"] for r in runs],
               "flash_launches_per_rank": [r["launches"] for r in runs],
               "streams_equal_to_one_card": len(got) - len(ties),
               "near_ties": ties, **group.note()},
        "goodput": reports, "phase_30_s": time.perf_counter() - t0}))
    return launches


CALIBRATE_N = 4096           # phase 31's matmul size, calibrate's default


def phase_calibrate(measure) -> float:
    """Phase 31's card work (module docstring), before the rank groups:
    calibrate and its chain. Returns its seconds."""
    t0 = time.perf_counter()
    tflops = measure.calibrate(n=CALIBRATE_N, device="cuda")
    peak = measure.device_peak_tflops()
    check(0 < tflops < 989, f"calibrate read {tflops} TFLOP/s, outside "
          f"(0, 989): the timing path is broken")
    # calibrate's chain stays eager unless the card idles in it: the wall
    # time of one fenced 16-link chain (median of 3) against 16 matmuls
    # at the rate the slope just read
    gen = torch.Generator(device="cuda").manual_seed(0)
    n = CALIBRATE_N
    a, b = (torch.randn(n, n, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(2))

    def chain():
        x = a
        for _ in range(16):
            x = (x @ b) * (1.0 / n)
        return x.float().sum()
    chain_s = float(np.median([fenced_s(chain) for _ in range(4)][1:]))
    del a, b
    print(json.dumps({"calibrate": {
        "n": n, "k1": 16, "k2": 64, "tflops": tflops, "peak_tflops": peak,
        "share_of_peak": tflops / 989, "chain_16_wall_s": chain_s,
        "chain_16_matmul_s": 16 * 2 * n**3 / (tflops * 1e12),
        "chain_busy_share": 16 * 2 * n**3 / (tflops * 1e12) / chain_s}}))
    return time.perf_counter() - t0


def phase_budget(budget, workload, mono, train, int8_peak, tp, calib_s):
    """Phase 31's HBM model on the H100 beside the peaks this run measured
    (phase 20's among them: after the rank groups); ``calib_s`` the
    seconds of :func:`phase_calibrate`."""
    t0 = time.perf_counter() - calib_s
    acc = "h100-80gb"
    train_cfg = workload.ModelConfig.llama_like_big(seq=4096)
    serve_cfg = workload.ModelConfig.llama_like_big()
    int8 = dataclasses.replace(serve_cfg, kv_cache_dtype="int8")
    two = tp["two"]
    slots, rows = SERVE_GEOMETRY["slots"], SERVE_GEOMETRY["max_seq"]
    table = {
        "train": (budget.train_hbm_breakdown(train_cfg, 1, mu_dtype="f32",
                                             accelerator=acc),
                  "phase 6", train["peak_mem_gib"]),
        # the captured step's memory as the card holds it: the graph's
        # private pool stays reserved between replays
        "train_reserved": (budget.train_hbm_breakdown(
            train_cfg, 1, mu_dtype="f32", accelerator=acc),
            "phase 6, reserved", train["peak_reserved_gib"]),
        "train_tp2": (budget.train_hbm_breakdown(
            train_cfg, 1, mu_dtype="f32", tp=2, accelerator=acc),
            "phase 22", max(r["train"]["peak_mem_gib"] for r in two)),
        "serve": (budget.serve_hbm_breakdown(serve_cfg, slots, rows,
                                             accelerator=acc),
                  "phase 3", mono["peak_mem_gib"]),
        "serve_tp2": (budget.serve_hbm_breakdown(
            serve_cfg, slots, rows, tp=2, accelerator=acc),
            "phase 20", max(r["llama_like_big"]["peak_mem_gib"]
                            for r in two)),
        "serve_int8": (budget.serve_hbm_breakdown(int8, slots, rows,
                                                  accelerator=acc),
                       "phase 14", int8_peak),
    }
    n = budget.count_params(train_cfg)
    print(json.dumps({"budget": {
        name: {**bd.to_dict(), "measured_by": where, "measured_gib": got,
               "measured_over_budget": got / bd.total_gib}
        for name, (bd, where, got) in table.items()},
        "accelerator": acc,
        "table_hbm_mb": budget.ACCELERATORS[acc].hbm_mb_per_chip,
        "device_total_memory_bytes":
        torch.cuda.get_device_properties(0).total_memory,
        "n_params": n,
        # the model counts nu in mu's f32; optim.AdamW keeps it in the
        # parameters' bf16, as optax does
        "nu_counted_over_kept_gib": n * 2 / 2**30,
        "phase_31_s": time.perf_counter() - t0}))


# -- phases 32-34: serving over fsdp, the pipeline over fsdp, the entry points

FSDP_SERVE_MESH = {"fsdp": 2}           # phase 32
FSDP_SERVE_REQUESTS = 8                 # phase 3's first 8: one arena's worth
# each of them cut to its first 16 tokens (the least phase 3 asks): under
# gloo every forward gathers the 1.25 GB of weights through the host, about
# 1.2 s, so the full 127 ticks took 167 s a drain
FSDP_SERVE_NEW_TOKENS = 16
PP_FSDP_MESH = {"pp": 2, "fsdp": 2}     # phase 33
PP_FSDP_STEPS = 2


def fsdp_fractions(workload, shards, whole_shapes, specs, mesh):
    """Each leaf that ``specs`` put over fsdp, its size over its whole
    size on one rank without fsdp (its stage's, for a pipeline leaf over
    pp): 0.5 each at fsdp 2 with no tp."""
    out = []
    workload.tree_map(lambda x, whole, spec: out.append(
        x.numel() * (mesh.shape.get(spec[0], 1) if spec[0] == "pp" else 1)
        / math.prod(whole)) if "fsdp" in spec else None,
        shards, whole_shapes, specs)
    return out


def fsdp_serve_drain(mesh, params, cfg, reqs, graphs=True):
    """One rank's drain of ``reqs`` at phase 3's geometry on ``mesh``, as a
    user drives the engine, from ``params`` (the whole tree, or this
    rank's shards), through its captured chains or, with ``graphs``
    False, its programs' bodies; K1 counted from the engine's
    construction; the peak memory from after its construction (its
    shards, the whole arena, the drain)."""
    from tpusched_torch import attention, serve, workload
    attention.FLASH_FWD_LAUNCHES = 0
    eng = serve.ServeEngine(params, cfg, mesh=mesh, **SERVE_GEOMETRY)
    eng._graphs = graphs
    del params
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng.warmup()
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    drain_s = time.perf_counter() - t0
    check_completions(done, reqs, cfg.vocab, f"fsdp serving on {mesh.shape}")
    halves = fsdp_fractions(workload, eng.params, workload.param_shapes(cfg),
                            workload.param_specs(cfg, mesh), mesh)
    return dict(launches=attention.FLASH_FWD_LAUNCHES, prefills=eng.prefills,
                ticks=eng.tick_count, kv_heads=int(eng.cache[0]["k"].shape[2]),
                tokens={c.rid: c.tokens for c in done}, drain_s=drain_s,
                fsdp_leaf_fractions=sorted(set(halves)),
                fsdp_leaves=len(halves), segments=program_segments(eng),
                peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)


def fsdp_serve_requests(cfg, serve):
    """Phase 32's traffic: the first FSDP_SERVE_REQUESTS of phase 3's
    requests, each cut to at most FSDP_SERVE_NEW_TOKENS new tokens."""
    return [dataclasses.replace(r, max_new_tokens=min(
        r.max_new_tokens, FSDP_SERVE_NEW_TOKENS))
        for r in make_requests(cfg, serve)[:FSDP_SERVE_REQUESTS]]


def fsdp_serve_rank(mesh, directory):
    """Phase 32 on one rank of FSDP_SERVE_MESH: :func:`fsdp_serve_requests`
    served from phase 3's seeded weights through the captured chains, then
    from the snapshot under ``directory`` read as this rank's shards
    (``load_for_serving(mesh=)``) through the programs' bodies, so that
    the two drains also hold the chains against the bodies."""
    from tpusched_torch import checkpoint, serve, workload
    cfg = workload.ModelConfig.llama_like_big()
    reqs = fsdp_serve_requests(cfg, serve)
    out = {"in_memory": fsdp_serve_drain(
        mesh, seeded_params(workload, cfg), cfg, reqs)}
    t0 = time.perf_counter()
    shards = checkpoint.load_for_serving(directory, cfg, mesh=mesh)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    out["snapshot"] = fsdp_serve_drain(mesh, shards, cfg, reqs, graphs=False)
    out["snapshot"]["load_s"] = load_s
    return out


def phase_fsdp_serving(checkpoint, decode, serve, workload, mono):
    """Phase 32: full-width ``llama_like_big`` served over FSDP_SERVE_MESH,
    two gloo ranks sharing the card, :func:`fsdp_serve_requests` (one
    arena's worth, at phase 3's geometry): the ranks agree, K1 launches 12
    x the engine's prefills a rank (warm-up included: 12 x (8 + 2) = 120),
    every fsdp leaf is half its whole size, each stream equals the start
    of phase 3's or first differs at a near tie;
    then the same from a fresh ``export_for_serving`` of the seeded weights
    read as shards and drained through the programs' bodies: the same
    launches and the in-memory engine's (graphed) streams exactly. Returns
    K1's launches a rank."""
    t0 = time.perf_counter()
    cfg = workload.ModelConfig.llama_like_big()
    reqs = fsdp_serve_requests(cfg, serve)
    directory = work_dir("fsdp-serving-")
    params = seeded_params(workload, cfg)
    checkpoint.export_for_serving(str(directory), params, cfg)
    torch.cuda.empty_cache()
    group, = yield (spawn("32 fsdp serving", fsdp_serve_rank,
                          FSDP_SERVE_MESH, str(directory)),)
    ranks = group.result
    shutil.rmtree(directory)
    want = cfg.n_layers * (FSDP_SERVE_REQUESTS + len(SERVE_BUCKETS))
    lines = {}
    for which in ("in_memory", "snapshot"):
        ranks_agree(ranks, which, f"fsdp serving ({which})")
        runs = [r[which] for r in ranks]
        for run in runs:
            check(run["launches"] == cfg.n_layers * run["prefills"] == want,
                  f"fsdp serving ({which}): {run['launches']} flash launches "
                  f"for {run['prefills']} prefills, wanted {want}")
            check(run["kv_heads"] == cfg.kv_heads, "fsdp arena heads")
            check(run["fsdp_leaf_fractions"] == [0.5]
                  and run["fsdp_leaves"] == 7 * cfg.n_layers + 2,
                  f"fsdp serving: leaves over fsdp hold "
                  f"{run['fsdp_leaf_fractions']} of their whole size")
            if which == "in_memory":
                check_segments(run["segments"], "fsdp serving")
        lines[which] = runs
    in_memory = lines["in_memory"][0]["tokens"]
    differ = [rid for rid, toks in lines["snapshot"][0]["tokens"].items()
              if not np.array_equal(toks, in_memory[rid])]
    check(not differ, f"fsdp serving from the snapshot differs from the "
          f"in-memory weights for requests {differ}")
    ties = {}
    for rid, toks in lines["in_memory"][0]["tokens"].items():
        plain = mono["tokens"][rid][:len(toks)]
        if not np.array_equal(toks, plain):
            ties[rid] = near_tie(decode, params, cfg, reqs[rid].prompt,
                                 plain, toks, "cuda")
    del params
    torch.cuda.empty_cache()
    runs = lines["in_memory"]
    print(json.dumps({
        "fsdp_serving": "llama_like_big", "mesh": FSDP_SERVE_MESH,
        "backend": "gloo", "requests": FSDP_SERVE_REQUESTS,
        "max_new_tokens_cap": FSDP_SERVE_NEW_TOKENS,
        "tokens": sum(len(t) for t in runs[0]["tokens"].values()),
        "ranks_agree": True,
        "flash_launches_per_rank": [r["launches"] for r in runs],
        "prefills": runs[0]["prefills"], "ticks": runs[0]["ticks"],
        "fsdp_leaves_halved": runs[0]["fsdp_leaves"],
        "streams_equal_to_phase_3_start": len(runs[0]["tokens"]) - len(ties),
        "near_ties": ties,
        "snapshot_streams_equal_to_in_memory": len(runs[0]["tokens"]),
        "snapshot_through_bodies": True,
        "snapshot_load_s_per_rank": [r["load_s"]
                                     for r in lines["snapshot"]],
        "peak_mem_gib_per_rank": [r["peak_mem_gib"] for r in runs],
        "snapshot_peak_mem_gib_per_rank": [r["peak_mem_gib"]
                                           for r in lines["snapshot"]],
        "unsharded_peak_mem_gib": mono["peak_mem_gib"],
        "drain_s_per_rank": [r["drain_s"] for r in runs],
        "snapshot_drain_s_per_rank": [r["drain_s"]
                                      for r in lines["snapshot"]],
        "segments": runs[0]["segments"],
        "drain_s_note": GLOO_NOTE, **group.note(),
        "phase_32_s": time.perf_counter() - t0}))
    return {"in_memory_per_rank": [r["launches"] for r in runs],
            "snapshot_per_rank": [r["launches"] for r in lines["snapshot"]]}


def phase_pp_fsdp(workload, results):
    """Phase 33: phase 27's GPipe step at full width on PP_FSDP_MESH, four
    gloo ranks sharing the card: K1 = K2 = K3 = (L/pp)·n_micro = 24 a
    stage a step, every leaf the specs put over fsdp half its phase 27
    size (its stage's whole), the first loss within 1e-6 relative of phase
    27's (the gathered weights are the whole ones; predicted bitwise
    equal), the ranks' losses equal. Phase 27's results are read from
    ``results`` after the group, once its checks have run (they run
    first, in phase order). Returns the launches a stage a step."""
    t0 = time.perf_counter()
    group, = yield (spawn("33 pp x fsdp", pp_rank, PP_FSDP_MESH, PP_LR,
                          PP_FSDP_STEPS),)
    ranks = group.result
    pp = results["27"]
    cfg = pp_cfg(workload)
    per = cfg.n_layers // PP_FSDP_MESH["pp"] * PP_MICRO
    for run in ranks:
        check(all(c == (per, per, per) for c in run["launches"]),
              f"pp x fsdp rank {run['rank']}: launched (K1, K2, K3) "
              f"{run['launches']} a step, wanted {per} each")
        check(run["losses"] == ranks[0]["losses"],
              f"pp x fsdp: the ranks' losses differ: {run['losses']}")
        check(run["fsdp_leaf_fractions"] == [0.5]
              and run["fsdp_leaves"] == 9,
              f"pp x fsdp rank {run['rank']}: leaves over fsdp hold "
              f"{run['fsdp_leaf_fractions']} of their stage's size")
    first = ranks[0]["losses"][0]
    rel = abs(first - pp["losses"][0]) / abs(pp["losses"][0])
    check(rel <= CKPT_RTOL, f"pp x fsdp first loss {first} against phase "
          f"27's {pp['losses'][0]}: rel {rel} (tol {CKPT_RTOL})")
    print(json.dumps({
        "pp_fsdp_training": "llama_like_big", "seq": cfg.seq, "batch": 4,
        "n_micro": PP_MICRO, "mesh": PP_FSDP_MESH, "backend": "gloo",
        "optimizer": f"sgd lr {PP_LR}", "losses": ranks[0]["losses"],
        "phase_27_losses": pp["losses"], "first_loss_rel_diff": rel,
        "first_loss_bitwise_equal": first == pp["losses"][0],
        "loss_rtol": CKPT_RTOL,
        "launches_per_step_per_stage": dict(zip(
            ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq"), (per,) * 3)),
        "fsdp_leaves_halved": ranks[0]["fsdp_leaves"],
        "peak_mem_gib_per_rank": {
            f"stage {r['stage']} fsdp {r['fsdp_index']}": r["peak_mem_gib"]
            for r in ranks},
        "phase_27_peak_mem_gib_per_stage": pp["peak_mem_gib_per_stage"],
        "step_s_per_rank": [r["step_s"] for r in ranks],
        "step_s_note": GLOO_NOTE, **group.note(),
        "phase_33_s": time.perf_counter() - t0}))
    return per


def phase_entry(entry, workload, workdir):
    """Phase 34: ``entry()``'s forward on the card, (4, 128, 2048), within
    1e-5 relative (of its largest logit) of the same weights' forward on
    the CPU, TF32 off; then ``dryrun_multichip(8)`` and
    ``dryrun_multichip(6)`` with every rank a gloo rank on the card: the
    reference's lines, each OK (raising otherwise); at 8 the dense block's
    ring-flash launches K1 = K2 = K3 = L·(1 + sp index) a rank (the
    reference's dense config has no remat, so one forward launch a pair,
    where phase 25's remat doubles K1), at 6 dp 3 × tp 2 with no MoE or
    pipeline block and, without sp, no flash launch. Returns the dense
    block's launches by sp index."""
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fn, (params, tokens) = entry.entry()
    check(tokens.device.type == "cuda" and all(
        t.device.type == "cuda" for t in workload.tree_leaves(params)),
        "entry() did not put its params and tokens on the card")
    with torch.no_grad():
        out = fn(params, tokens)
        cpu_fn, (cpu_params, cpu_tokens) = entry.entry(device="cpu")
        want = cpu_fn(cpu_params, cpu_tokens)
    got = out.float().cpu()
    err = (got - want).abs().max().item() / want.abs().max().item()
    check(tuple(out.shape) == (4, 128, 2048) and err <= 1e-5,
          f"entry forward {tuple(out.shape)} against the CPU's: rel {err}")
    print(f"entry forward: {tuple(out.shape)}")
    entry_s = time.perf_counter() - t0
    # dryrun_multichip spawns its own ranks (entry.run_blocks) and runs its
    # references here, in the group's worker thread
    groups = yield tuple(
        Group(f"34 dryrun {n}", n, functools.partial(
            entry.dryrun_multichip, n, backend="gloo", workdir=str(workdir)))
        for n in (8, 6))
    results = {n: g.result for n, g in zip((8, 6), groups)}
    seconds = {n: g.end - g.start for n, g in zip((8, 6), groups)}
    eight, six = results[8], results[6]
    check(list(eight) == ["dense", "moe", "pipeline", "tp-serve",
                          "tp-speculative", "tp-int8kv", "handoff"],
          f"dryrun_multichip(8) ran {list(eight)}")
    check(list(six) == ["dense", "tp-serve", "tp-speculative", "tp-int8kv",
                        "handoff"] and six["dense"]["mesh"] == {"dp": 3,
                                                               "tp": 2},
          f"dryrun_multichip(6) ran {list(six)} on {six['dense']['mesh']}")
    layers = workload.ModelConfig.tiny().n_layers
    by_sp = {}
    for r, run in enumerate(eight["dense"]["ranks"]):
        i = run["sp_index"]
        want_launches = (layers * (1 + i),) * 3
        check(tuple(run["launches"]) == want_launches,
              f"dryrun dense rank {r}: launched {run['launches']}, wanted "
              f"{want_launches}")
        by_sp[i] = tuple(run["launches"])
    check(all(tuple(run["launches"]) == (0, 0, 0)
              for run in six["dense"]["ranks"]),
          "dryrun_multichip(6): a flash kernel launched without sp")
    print(json.dumps({
        "entry": {"forward_shape": list(out.shape), "rel_err_vs_cpu": err,
                  "tf32": False, "entry_s": entry_s},
        "dryrun": {str(n): {name: {k: v for k, v in block.items()
                                   if k in ("line", "loss", "ref", "mesh")}
                            for name, block in res.items()}
                   for n, res in results.items()},
        "dense_launches_by_sp_index": by_sp, "backend": "gloo",
        "dryrun_s": seconds, "dryrun_overlap": {
            n: g.note() for n, g in zip((8, 6), groups)},
        "phase_34_s": time.perf_counter() - t0}))
    return by_sp


# -- the compiled programs (phase 35) -----------------------------------------

PROGRAM_TICKS = 3            # ticks before the replay-vs-body comparisons
SYNC_FREE_REPLAYS = 32
# why a replay and its body may differ, printed beside any difference: the
# body runs eagerly on the default stream, the graph was captured on a side
# stream, and a library GEMM may choose another kernel for either
REPLAY_NOTE = ("replay and body differ: the GEMM library may choose another "
               "kernel under capture; argmax held equal")


def arena_copy(cache):
    return [{n: t.clone() for n, t in c.items()} for c in cache]


def arena_restore(cache, state) -> None:
    for c, s in zip(cache, state):
        for n, t in c.items():
            t.copy_(s[n])


def arena_equal(cache, state) -> bool:
    return all(torch.equal(t, s[n]) for c, s in zip(cache, state)
               for n, t in c.items())


def replay_vs_body(attention, prog, cache, values, label) -> dict:
    """``prog`` run with ``values`` as a replay, then its body called
    directly on the arena as it was: the output (where the program returns
    one) and the arena compared bitwise; where they differ, the max |err|
    is printed and the argmax must agree. The arena is left as it was and
    the launch counters as they were."""
    counts = (attention.FLASH_FWD_LAUNCHES, attention.FLASH_BWD_DKDV_LAUNCHES,
              attention.FLASH_BWD_DQ_LAUNCHES)
    before = arena_copy(cache)
    out_graph = prog(**values)
    none = torch.zeros(0)
    out_graph = none if out_graph is None else out_graph.clone()
    after = arena_copy(cache)
    arena_restore(cache, before)
    out_body = prog.body()
    out_body = none if out_body is None else out_body.clone()
    torch.cuda.synchronize()
    rec = {"program": label, "graphed": prog.graph is not None,
           "output_bitwise": torch.equal(out_graph, out_body),
           "arena_bitwise": arena_equal(cache, after)}
    check(rec["graphed"], f"{label}: the program was not captured")
    if not (rec["output_bitwise"] and rec["arena_bitwise"]):
        rec["arena_max_abs_err"] = max(
            float((t.float() - a[n].float()).abs().max())
            for c, a in zip(cache, after) for n, t in c.items())
        rec["note"] = REPLAY_NOTE
        if not out_graph.numel():        # a copy: only its rows to compare
            check(rec["arena_bitwise"], f"{label}: replay and body wrote "
                  f"different rows: {rec}")
        rec["max_abs_err"] = float((out_graph.float() - out_body.float())
                                   .abs().max())
        if out_graph.is_floating_point():
            check(torch.equal(out_graph.argmax(-1), out_body.argmax(-1)),
                  f"{label}: replay and body disagree on the argmax: {rec}")
        else:
            check(rec["output_bitwise"], f"{label}: replay and body "
                  f"disagree on the tokens: {rec}")
    arena_restore(cache, before)
    (attention.FLASH_FWD_LAUNCHES, attention.FLASH_BWD_DKDV_LAUNCHES,
     attention.FLASH_BWD_DQ_LAUNCHES) = counts
    return rec


def started_engine(serve, params, cfg, reqs, graphs=True, **kw):
    """A warmed engine at phase 3's geometry with ``reqs`` submitted and
    :data:`PROGRAM_TICKS` ticks run. ``graphs=False`` is the private hook
    that makes a card engine call its programs' bodies."""
    eng = serve.ServeEngine(params, cfg, device="cuda", **SERVE_GEOMETRY,
                            **kw)
    eng._graphs = graphs
    eng.warmup()
    for r in reqs:
        eng.submit(r)
    for _ in range(PROGRAM_TICKS):
        eng.tick()
    return eng


def prefill_values(cfg, bucket):
    rng = np.random.default_rng(bucket)
    prompt = rng.integers(0, cfg.vocab, bucket, dtype=np.int64)
    prompt[bucket - 5:] = 0                  # padding past the true length
    return {"prompt": prompt, "slot": 3, "true_len": bucket - 5}


def programs_full_width(attention, serve, workload) -> dict:
    """Phase 35a-b: replay == body for the decode tick and both prefill
    buckets of llama_like_big, its int8 arena and mixtral_like; the pool
    memory the programs hold; 32 decode-tick replays with no
    synchronization."""
    out = {}
    for name, kv in (("llama_like_big", None), ("llama_like_big", "int8"),
                     ("mixtral_like", None)):
        cfg = dataclasses.replace(getattr(workload.ModelConfig, name)(),
                                  kv_cache_dtype=kv)
        params = seeded_params(workload, cfg)
        reqs = make_requests(cfg, serve)[:SERVE_GEOMETRY["slots"]]
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        eng = started_engine(serve, params, cfg, reqs)
        arena = sum(t.numel() * t.element_size()
                    for c in eng.cache for t in c.values())
        torch.cuda.synchronize()
        held = torch.cuda.memory_reserved() - reserved
        tick = eng._program(("decode",))
        recs = [replay_vs_body(attention, tick, eng.cache,
                               {"tokens": eng.next_tok, "pos": eng.pos},
                               "decode_tick")]
        for bucket in SERVE_BUCKETS:
            recs.append(replay_vs_body(
                attention, eng._program(("prefill", bucket, False)),
                eng.cache, prefill_values(cfg, bucket), f"prefill_{bucket}"))
        label = f"{name}{' int8' if kv else ''}"
        out[label] = {"comparisons": recs, "arena_gib": arena / 2**30,
                      "reserved_by_engine_gib": held / 2**30,
                      "programs_gib": (held - arena) / 2**30}
        if label == "llama_like_big":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                for _ in range(SYNC_FREE_REPLAYS):
                    tick(tokens=eng.next_tok, pos=eng.pos)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            out[label]["sync_free_replays"] = SYNC_FREE_REPLAYS
        print(json.dumps({"programs": label, **out[label]}))
        del eng, tick, params
    return out


def programs_streams(attention, serve, workload, mono) -> dict:
    """Phase 35c-d: phase 3's 16 requests drained by a graphed engine and
    by one whose programs call their bodies, tick 10 of each traced: both
    give phase 3's streams exactly, K1 12 a slot prefill either way (the
    graphed drain's counted through replays)."""
    cfg = workload.ModelConfig.llama_like_big()
    params = seeded_params(workload, cfg)
    reqs = make_requests(cfg, serve)
    out = {}
    for graphs in (True, False):
        attention.FLASH_FWD_LAUNCHES = 0
        eng = serve.ServeEngine(params, cfg, device="cuda", **SERVE_GEOMETRY)
        eng._graphs = graphs
        eng.warmup()
        for r in reqs:
            eng.submit(r)
        kind = "graphed" if graphs else "eager bodies"
        trace, drain_s = drain_traced(
            eng, f"llama_like_big {kind} serving tick", "cuda")
        torch.cuda.synchronize()
        launches = attention.FLASH_FWD_LAUNCHES
        check(launches == cfg.n_layers * eng.prefills,
              f"{kind} drain: {launches} flash launches for {eng.prefills} "
              f"prefills")
        differ = [c.rid for c in eng.completions
                  if not np.array_equal(c.tokens, mono["tokens"][c.rid])]
        check_completions(eng.completions, reqs, cfg.vocab, kind)
        check(not differ, f"{kind} drain: streams {differ} differ from "
              f"phase 3's")
        out[kind] = {"flash_launches": launches, "prefills": eng.prefills,
                     "ticks": eng.tick_count, "drain_s": drain_s,
                     "tick_ms": 1e3 * drain_s / (eng.tick_count - 1),
                     "trace": trace}
        del eng
    return out


def programs_speculative(attention, serve, workload) -> dict:
    """Phase 35e: phase 18's llama_like-draft engine, graphed and through
    its bodies: the draft tick and verify span replay == body after three
    rounds, the streams of both drains equal, round 10 of each traced."""
    cfg = workload.ModelConfig.llama_like_big()
    dcfg = workload.ModelConfig.llama_like()
    params = seeded_params(workload, cfg)
    dparams = seeded_params(workload, dcfg, seed=1)
    reqs = make_requests(cfg, serve)
    out, tokens = {}, {}
    for graphs in (True, False):
        attention.FLASH_FWD_LAUNCHES = 0
        eng = started_engine(serve, params, cfg, reqs, graphs,
                             draft_params=dparams, draft_cfg=dcfg,
                             spec_k=SPEC_K)
        kind = "graphed" if graphs else "eager bodies"
        recs = []
        if graphs:
            pos = eng._round_positions()
            feed2 = np.stack([eng.prev_tok, eng.next_tok], axis=1)
            draft = eng._program(("draft",))
            recs.append(replay_vs_body(attention, draft, eng.draft_cache,
                                       {"feed2": feed2, "pos": pos},
                                       "draft_tick"))
            scored = np.concatenate([eng.next_tok[:, None],
                                     draft.outputs.cpu().numpy()], axis=1)
            recs.append(replay_vs_body(attention, eng._program(("verify",)),
                                       eng.cache, {"scored": scored,
                                                   "pos": pos},
                                       "verify_span"))
        trace, drain_s = drain_traced(
            eng, f"llama_like_big {kind} speculative round, llama_like", "cuda")
        torch.cuda.synchronize()
        check_completions(eng.completions, reqs, cfg.vocab, kind)
        check(attention.FLASH_FWD_LAUNCHES == cfg.n_layers * eng.prefills,
              f"{kind} speculative drain: flash launches")
        tokens[kind] = {c.rid: c.tokens for c in eng.completions}
        rounds = eng.tick_count
        out[kind] = {"comparisons": recs, "spec_stats": dict(eng.spec_stats),
                     "flash_launches": attention.FLASH_FWD_LAUNCHES,
                     "round_ms": 1e3 * drain_s / (rounds - PROGRAM_TICKS - 1),
                     "trace": trace}
        del eng
    differ = [rid for rid, t in tokens["graphed"].items()
              if not np.array_equal(t, tokens["eager bodies"][rid])]
    check(not differ, f"speculative streams {differ} differ between the "
          f"graphed and the eager engine")
    check(out["graphed"]["spec_stats"] == out["eager bodies"]["spec_stats"],
          "speculative stats differ between graphed and eager")
    return out


def programs_decode_step(decode, workload) -> dict:
    """Phase 35f: one greedy decode step of mixtral_like(seq=512) at batch
    8 after a 128-token prefill (phase 16's), as generate's captured step
    program and as its body: traced, and timed with CUDA events."""
    cfg = workload.ModelConfig.mixtral_like(seq=512)
    params = seeded_params(workload, cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (8, 128), generator=gen,
                           device="cuda")
    steps = 96
    cache = decode.init_kv_cache(cfg, 8, 128 + steps, "cuda")
    out = {}
    logits, _ = decode.prefill(params, cache, prompt, cfg)
    first = logits[:, -1].argmax(-1)
    toks = torch.empty((8, steps + 1), dtype=torch.long, device="cuda")
    pos = torch.full((), 128, dtype=torch.long, device="cuda")
    step = decode._greedy_step(params, cache, first.clone(), pos, toks,
                               128, cfg)
    step.capture()
    for name, fn in (("graphed", step), ("eager body", step.body)):
        step(tok=first, pos=128)           # rewind: each run from row 128
        out[name] = {"trace": traced(
            fn, f"mixtral_like decode step batch 8 {name}"),
            "events_ms": cuda_ms(fn, iters=16)}
    return out


def phase_programs(attention, decode, serve, workload, mono,
                   exact_decode) -> dict:
    """Phase 35, the compiled programs on the card: replay == body at full
    width, no synchronization over 32 replays, phase 3's streams from a
    graphed and an eager-bodies engine, greedy speculation graphed and
    eager, the decode step graphed and eager; then phase 11's graphed
    measure_decode beside its bound."""
    t0 = time.perf_counter()
    with torch.no_grad():
        full = programs_full_width(attention, serve, workload)
        streams = programs_streams(attention, serve, workload, mono)
        spec = programs_speculative(attention, serve, workload)
        step = programs_decode_step(decode, workload)
    summary = {
        "programs_summary": True,
        "phase3_peak_mem_gib": mono["peak_mem_gib"],
        "serving_tick_ms": {k: v["tick_ms"] for k, v in streams.items()},
        "speculative_round_ms": {k: v["round_ms"] for k, v in spec.items()},
        "decode_step_events_ms": {k: v["events_ms"] for k, v in step.items()},
        "measure_decode_step_ms": 1e3 * exact_decode["step_s"],
        "measure_decode_bound_ms": 1e3 * exact_decode["bound_step_s"],
        "phase_s": time.perf_counter() - t0}
    print(json.dumps(summary))
    return {"full_width": full, "streams": streams, "speculative": spec,
            "decode_step": step, **summary}


# -- the chunk, prefix and sampled-round programs (phase 36) ------------------

SAMPLED = dict(temperature=0.8, top_p=0.95, seed=7, request_keyed=True)
PHASE36_REQUESTS = 8         # phase 3's first 8: one arena's worth
SOLO_STEPS = 63              # phase 17's prompt, half its steps


def chunk_values(cfg, slot, off):
    """A chunk program's inputs: seeded tokens at ``off`` of ``slot``, the
    logits of chunk row 100 out."""
    rng = np.random.default_rng(1000 * slot + off)
    return {"chunk": rng.integers(0, cfg.vocab, CHUNK), "slot": slot,
            "off": off, "last_row": 100}


def programs_chunk_prefix(attention, serve, workload) -> dict:
    """Phase 36a: on a chunked engine serving 6 of phase 3's requests, the
    chunk program's replay == its body at offsets 0, 256 and 768 of slots
    1 and 6; phase 13's 300-token prefix registered (K1 12, counted
    through the K/V program's replay) and its K/V program's replay ==
    body; a tenant of it admitted into a free slot, whose insert program
    (captured there) replays == its body; then 32 replays each of the
    chunk and the insert program under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    cfg = workload.ModelConfig.llama_like_big()
    params = seeded_params(workload, cfg)
    prefix, suffixes, gens, _ = slo_traffic(cfg.vocab)
    eng = started_engine(serve, params, cfg, make_requests(cfg, serve)[:6],
                         chunk_prefill=CHUNK)
    chunk = eng._program(("chunk",))
    recs = [replay_vs_body(attention, chunk, eng.cache,
                           chunk_values(cfg, slot, off),
                           f"chunk slot {slot} off {off}")
            for slot in (1, 6) for off in (0, 256, 768)]
    torch.cuda.synchronize()
    attention.FLASH_FWD_LAUNCHES = 0
    eng.register_prefix("phase36", prefix)
    torch.cuda.synchronize()
    registration = attention.FLASH_FWD_LAUNCHES
    check(registration == cfg.n_layers, f"prefix registration: "
          f"{registration} flash launches, wanted {cfg.n_layers}")
    kv = eng._program(("prefix", len(prefix)))
    recs.append(replay_vs_body(attention, kv, eng.cache,
                               {"tokens": prefix}, "prefix_kv"))
    eng.submit(serve.Request(rid=100, prompt=suffixes[0],
                             max_new_tokens=gens[0], prefix_id="phase36"))
    eng.tick()
    slot = next(s for s, r in enumerate(eng.req)
                if r is not None and r.rid == 100)
    insert = eng._prefixes["phase36"]["insert"]
    recs.append(replay_vs_body(attention, insert, eng.cache, {"slot": slot},
                               "prefix_insert"))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(SYNC_FREE_REPLAYS):
            chunk(**chunk_values(cfg, 1, CHUNK * (i % 4)))
            insert(slot=slot)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    out = {"comparisons": recs, "prefix_registration_launches": registration,
           "sync_free_replays": {"chunk": SYNC_FREE_REPLAYS,
                                 "prefix_insert": SYNC_FREE_REPLAYS}}
    print(json.dumps({"programs": "llama_like_big chunked", **out}))
    return out


def programs_chunked_streams(attention, serve, workload, chunked,
                             slo_streams) -> dict:
    """Phase 36b: phase 12's traffic drained by a chunked engine whose
    programs call their bodies, its tick traced as phase 12 traced the
    graphed one, and phase 13's three SLO runs through the bodies: every
    stream equal to the graphed run's, K1 0 chunked and 408 / 0 / 12 in
    the SLO runs (``phase_slo`` holds those)."""
    cfg = workload.ModelConfig.llama_like_big()
    params = seeded_params(workload, cfg)
    reqs = make_requests(cfg, serve)
    attention.FLASH_FWD_LAUNCHES = 0
    eng = serve.ServeEngine(params, cfg, chunk_prefill=CHUNK, device="cuda",
                            **SERVE_GEOMETRY)
    eng._graphs = False
    eng.warmup()
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    trace, tick_s = drain_chunked(
        eng, "llama_like_big chunked serving tick, eager bodies")
    drain_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    check(attention.FLASH_FWD_LAUNCHES == 0,
          "chunked bodies drain launched the flash kernel")
    differ = [c.rid for c in eng.completions
              if not np.array_equal(c.tokens, chunked["tokens"][c.rid])]
    check_completions(eng.completions, reqs, cfg.vocab, "chunked bodies")
    check(not differ, f"chunked streams {differ} differ between the graphed "
          f"and the eager-bodies engine")
    ticks = eng.tick_count
    del eng
    launches, streams = phase_slo(attention, serve, workload, graphs=False)
    differ = {name: [rid for rid, t in run.items()
                     if not np.array_equal(t, slo_streams[name][rid])]
              for name, run in streams.items()}
    check(not any(differ.values()), f"SLO streams differ between the "
          f"graphed and the eager-bodies engines: {differ}")
    return {"chunked_bodies": {
        "trace": trace, "ticks": ticks,
        "tokens_per_s": sum(r.max_new_tokens for r in reqs) / drain_s,
        "median_tick_s": float(np.median([t for _, t in tick_s]))},
        "slo_bodies_flash_launches": launches}


def programs_sampled(attention, serve, workload) -> dict:
    """Phase 36c: the request-keyed sampled speculative engine (phase 18's
    sampling, spec_k 4) with ``llama_like`` as the draft and with a
    self-draft, on phase 3's first 8 requests, graphed and through its
    bodies: the draft ingest, the one-token step and the verify span
    replay == body after three rounds (``llama_like`` draft), both drains
    of each draft give identical streams and stats, K1 12 a target prefill
    plus the draft's, round 10 of each drain traced."""
    cfg = workload.ModelConfig.llama_like_big()
    dcfg = workload.ModelConfig.llama_like()
    params = seeded_params(workload, cfg)
    drafts = {"llama_like": (seeded_params(workload, dcfg, seed=1), dcfg),
              "self_draft": (params, cfg)}
    reqs = make_requests(cfg, serve)[:PHASE36_REQUESTS]
    out = {}
    for name, (dp, dc) in drafts.items():
        tokens = {}
        for graphs in (True, False):
            attention.FLASH_FWD_LAUNCHES = 0
            eng = started_engine(serve, params, cfg, reqs, graphs,
                                 draft_params=dp, draft_cfg=dc,
                                 spec_k=SPEC_K, **SAMPLED)
            kind = "graphed" if graphs else "eager bodies"
            recs = []
            if graphs and name == "llama_like":
                rng = np.random.default_rng(36)
                pos = eng._round_positions()
                proposals = rng.integers(0, cfg.vocab, (len(pos), SPEC_K))
                for key, cache, values in (
                        ("draft_ingest", eng.draft_cache, {
                            "tokens": np.stack([eng.prev_tok, eng.next_tok],
                                               axis=1), "pos": pos - 1}),
                        ("draft_step", eng.draft_cache, {
                            "tokens": proposals[:, :1], "pos": pos + 1}),
                        ("verify_sampled", eng.cache, {
                            "tokens": np.concatenate(
                                [eng.next_tok[:, None], proposals], axis=1),
                            "pos": pos})):
                    recs.append(replay_vs_body(attention, eng._program((key,)),
                                               cache, values, key))
            trace, drain_s = drain_traced(
                eng, f"llama_like_big sampled speculative round, {name}, "
                f"{kind}", "cuda")
            torch.cuda.synchronize()
            check_completions(eng.completions, reqs, cfg.vocab,
                              f"sampled {name} {kind}")
            check(attention.FLASH_FWD_LAUNCHES == cfg.n_layers * eng.prefills
                  + flash_layers(dc) * eng.draft_prefills,
                  f"sampled {name} {kind}: flash launches")
            tokens[kind] = {c.rid: c.tokens for c in eng.completions}
            out[f"{name} {kind}"] = {
                "comparisons": recs, "spec_stats": dict(eng.spec_stats),
                "rounds": eng.tick_count,
                "round_ms": 1e3 * drain_s / (eng.tick_count - PROGRAM_TICKS
                                             - 1),
                "trace": trace}
            del eng
        differ = [rid for rid, t in tokens["graphed"].items()
                  if not np.array_equal(t, tokens["eager bodies"][rid])]
        check(not differ, f"sampled {name} streams {differ} differ between "
              f"the graphed and the eager engine")
        check(out[f"{name} graphed"]["spec_stats"]
              == out[f"{name} eager bodies"]["spec_stats"],
              f"sampled {name}: stats differ between graphed and eager")
    return out


def programs_solo(attention, decode, spec_decode, workload) -> dict:
    """Phase 36d: solo speculation, ``llama_like_big`` with ``llama_like``
    as the draft, phase 17's 64-token prompt: each round program (the
    greedy draft of a 1- and a 2-row feed, the greedy span, the sampled
    ingest of 1 and 2 rows, step and span) replay == body after the
    prefills; then ``speculative_generate`` and ``speculative_sample``
    (2024, temperature 0.8, top_p 0.95) for 63 steps, graphed and through
    their bodies (``spec_decode._program_factory`` replaced by one that
    builds programs with ``graphed=False``): equal tokens and stats, K1
    12 + 0 a call, seconds each."""
    from tpusched_torch.program import Program
    cfg = workload.ModelConfig.llama_like_big()
    dcfg = workload.ModelConfig.llama_like()
    params = seeded_params(workload, cfg)
    dparams = seeded_params(workload, dcfg, seed=1)
    prompt_np = np.random.default_rng(17).integers(0, cfg.vocab, 64)
    prompt = torch.as_tensor(prompt_np, device="cuda")[None].long()
    caches = {}
    for name, (p, c) in (("target", (params, cfg)), ("draft", (dparams,
                                                              dcfg))):
        caches[name] = decode.init_kv_cache(c, 1, 64 + SOLO_STEPS + 8,
                                            "cuda")
        decode.prefill(p, caches[name], prompt, c)
    program = functools.partial(Program, graphed=True,
                                pool=torch.cuda.graph_pool_handle())
    sampling = (0.8, 0, 0.95)
    rng = np.random.default_rng(37)
    feed = rng.integers(0, cfg.vocab, (1, 2))
    span = rng.integers(0, cfg.vocab, (1, SPEC_K + 1))
    progs = [("greedy_draft_1", spec_decode._greedy_draft_program(
                 dparams, caches["draft"], dcfg, 1, SPEC_K, program),
              "draft", {"feed": feed[:, :1], "pos": 64}),
             ("greedy_draft_2", spec_decode._greedy_draft_program(
                 dparams, caches["draft"], dcfg, 2, SPEC_K, program),
              "draft", {"feed": feed, "pos": 63}),
             ("greedy_span", spec_decode._greedy_span_program(
                 params, caches["target"], cfg, SPEC_K, program),
              "target", {"scored": span, "pos": 64})]
    for width in (1, 2):
        progs.append((f"sampled_ingest_{width}", decode._adjusted_span_program(
            dparams, caches["draft"], dcfg, (1, width), sampling, program),
            "draft", {"tokens": feed[:, :width], "pos": [65 - width]}))
    progs.append(("sampled_step", decode._adjusted_span_program(
        dparams, caches["draft"], dcfg, (1, 1), sampling, program), "draft",
        {"tokens": feed[:, :1], "pos": [65]}))
    progs.append(("sampled_span", decode._adjusted_span_program(
        params, caches["target"], cfg, (1, SPEC_K + 1), sampling, program,
        last=False), "target", {"tokens": span, "pos": [64]}))
    recs = [replay_vs_body(attention, prog, caches[which], values, label)
            for label, prog, which, values in progs]
    del progs, caches
    runs, factory = {}, spec_decode._program_factory
    for graphs in (True, False):
        if not graphs:
            spec_decode._program_factory = lambda device: functools.partial(
                Program, graphed=False)
        try:
            for fn, args in (("generate", ()), ("sample", (2024,))):
                call = getattr(spec_decode, f"speculative_{fn}")
                kw = ({"temperature": 0.8, "top_p": 0.95} if fn == "sample"
                      else {})
                attention.FLASH_FWD_LAUNCHES = 0
                (toks, stats), elapsed = timed(lambda: call(
                    params, cfg, dparams, dcfg, prompt, SOLO_STEPS, *args,
                    k=SPEC_K, **kw), "cuda")
                check(attention.FLASH_FWD_LAUNCHES == flash_layers(cfg)
                      + flash_layers(dcfg), f"speculative_{fn}: flash "
                      f"launches")
                runs[(fn, graphs)] = (toks, stats, elapsed)
        finally:
            spec_decode._program_factory = factory
    out = {"comparisons": recs}
    for fn in ("generate", "sample"):
        (a, sa, ta), (b, sb, tb) = runs[(fn, True)], runs[(fn, False)]
        check(np.array_equal(a, b) and sa == sb, f"speculative_{fn}: the "
              f"graphed and the eager-bodies call differ")
        out[f"speculative_{fn}"] = {"stats": sa, "graphed_s": ta,
                                    "eager_bodies_s": tb}
    print(json.dumps({"programs": "solo speculation", **out}))
    return out


def phase_chunk_prefix_sampled(attention, decode, serve, spec_decode,
                               workload, mono, chunked, slo_streams) -> dict:
    """Phase 36: the chunk program, the prefix programs, the sampled
    speculative round and solo speculation's rounds as captured programs
    on the card, each replay == its body at full width, no
    synchronization over 32 chunk and insert replays, and every graphed
    drain of phases 12, 13 and the sampled engines equal to its eager
    bodies'; chunked tokens/s (phase 12) beside plain (phase 3)."""
    t0 = time.perf_counter()
    with torch.no_grad():
        full = programs_chunk_prefix(attention, serve, workload)
        streams = programs_chunked_streams(attention, serve, workload,
                                           chunked, slo_streams)
        sampled = programs_sampled(attention, serve, workload)
        solo = programs_solo(attention, decode, spec_decode, workload)
    summary = {
        "chunk_prefix_sampled_summary": True,
        "chunked_tokens_per_s": chunked["stats"]["tokens_per_s"],
        "plain_tokens_per_s": mono["stats"]["tokens_per_s"],
        "chunked_bodies_drain_tokens_per_s":
            streams["chunked_bodies"]["tokens_per_s"],
        "chunked_tick": {"graphed": chunked["trace"],
                         "eager bodies": streams["chunked_bodies"]["trace"]},
        "sampled_round_ms": {k: v["round_ms"] for k, v in sampled.items()},
        "solo_s": {k: [v["graphed_s"], v["eager_bodies_s"]]
                   for k, v in solo.items() if k != "comparisons"},
        "phase_s": time.perf_counter() - t0}
    print(json.dumps(summary))
    return {"full_width": full, "streams": streams, "sampled": sampled,
            "solo": solo, **summary}


# -- the train steps, sampled sample and the keyed tick as programs (37) ------

TRAIN_PROGRAM_STEPS = 5      # AdamW steps each way, as phase 6
MOE_PROGRAM_STEPS = 3
ACCUM_STACK = 2              # microbatches of (1, 4096) a stack
ACCUM_STEPS = 2              # stacks: the first captures, the second replays
SAMPLE_BATCH, SAMPLE_PROMPT, SAMPLE_STEPS = 8, 128, 64
SAMPLE_SLOPE = (16, 64)      # steps of the two timed sample calls
SAMPLE_TRACED = 4            # the steps traced() runs: three timed, one traced
KEYED_REPLAYS = 32


@contextlib.contextmanager
def sync_free():
    """Inside, any synchronization of the card raises
    (``torch.cuda.set_sync_debug_mode("error")``)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(0)


def run_steps(attention, call, n, replays_sync_free):
    """``n`` calls of ``call()`` (a train step; returns its loss): the
    first, which captures a graphed step, fenced and timed alone, the
    other n - 1 as one fenced block, under :func:`sync_free` when
    ``replays_sync_free``; each step's (K1, K2, K3) launches. Returns
    (losses, first_s, per_step_s of the block, launches)."""
    losses, launches = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    zero_counts(attention)
    losses.append(call())
    launches.append(bwd_counts(attention))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with sync_free() if replays_sync_free else contextlib.nullcontext():
        for _ in range(n - 1):
            zero_counts(attention)
            losses.append(call())
            launches.append(bwd_counts(attention))
    torch.cuda.synchronize()
    per = (time.perf_counter() - t0) / (n - 1)
    return [x.item() for x in losses], first_s, per, launches


def named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    return {path: leaf for k, v in items
            for path, leaf in named_leaves(v, f"{prefix}/{k}").items()}


def trees_compare(got: dict, want: dict) -> dict:
    """Named trees (path -> tensor) compared leaf by leaf: bitwise, or the
    first leaf that differs and the largest difference over all."""
    first, worst = None, 0.0
    for path, leaf in want.items():
        if not torch.equal(got[path], leaf):
            first = first or path
            worst = max(worst, float((got[path].float() - leaf.float())
                                     .abs().max()))
    return {"bitwise": first is None, "first_differing_leaf": first,
            "max_abs_diff": worst}


def graphed_vs_body(attention, workload, cfg, build, n, label):
    """Phase 37's train comparison: for ``graphs`` in (True, False) the
    step ``build(graphs)`` returns, (call, tree to compare), run ``n``
    times from the same seeded init (:func:`run_steps`; the graphed run's
    replays sync-free), then traced for one more step each. Losses and
    every leaf of the tree are held bitwise equal, or the first leaf that
    differs is printed with the largest difference."""
    out, trees, calls = {}, {}, {}
    for graphs in (True, False):
        name = "graphed" if graphs else "body"
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated() / 2**30
        call, tree = build(graphs)
        losses, first_s, per, launches = run_steps(attention, call, n,
                                                   graphs)
        out[name] = {"losses": losses, "first_step_s": first_s,
                     "step_ms": 1e3 * per, "launches": launches,
                     "resident_before_gib": resident,
                     "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                     "peak_reserved_gib":
                         torch.cuda.max_memory_reserved() / 2**30}
        check(all(np.isfinite(losses)), f"{label} {name}: losses {losses}")
        trees[name], calls[name] = named_leaves(tree), call
    cmp = trees_compare(trees["graphed"], trees["body"])
    cmp["losses_equal"] = out["graphed"]["losses"] == out["body"]["losses"]
    for name in ("graphed", "body"):
        out[name]["trace"] = traced(calls[name], f"{label} {name}")
    return out, cmp


def programs_adamw(attention, optim, workload):
    """Phase 37a-b: llama_like_big(seq=4096) batch 1 AdamW (phase 6's),
    TRAIN_PROGRAM_STEPS graphed steps against as many body steps from the
    same seeded init, K1/K2/K3 24/12/12 every step through replays; then
    an accumulation step of ACCUM_STACK x (1, 4096), ACCUM_STEPS each
    way."""
    cfg = workload.ModelConfig.llama_like_big(seq=4096)
    tx = optim.adamw(1e-4, mu_dtype=torch.float32)
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (1, cfg.seq)),
                             device="cuda")
    stack = torch.as_tensor(rng.integers(0, cfg.vocab, (
        ACCUM_STACK, 1, cfg.seq)), device="cuda")
    want = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)

    def adamw(graphs):
        step, init_opt, _, _ = workload.make_optax_train_step(None, cfg, tx)
        step._programs.graphs = graphs    # False: the bodies, on the card
        params = seeded_params(workload, cfg)
        state = init_opt(params)
        return (lambda: step(params, state, tokens)[2],
                {"params": params, "mu": state.mu, "nu": state.nu})

    def accum(graphs):
        step, init_opt, _, _ = workload.make_accum_train_step(
            None, cfg, tx, ACCUM_STACK)
        step._programs.graphs = graphs
        params = seeded_params(workload, cfg)
        state = init_opt(params)
        return (lambda: step(params, state, stack)[2],
                {"params": params, "mu": state.mu, "nu": state.nu})

    out = {}
    for name, build, n, per in (
            ("adamw", adamw, TRAIN_PROGRAM_STEPS, want),
            ("accum", accum, ACCUM_STEPS,
             tuple(ACCUM_STACK * w for w in want))):
        runs, cmp = graphed_vs_body(attention, workload, cfg, build, n,
                                    f"llama_like_big {name} step seq 4096")
        for kind, run in runs.items():
            check(all(tuple(c) == per for c in run["launches"]),
                  f"{name} {kind}: (K1, K2, K3) a step {run['launches']}, "
                  f"wanted {per}")
        check(runs["graphed"]["losses"][-1] < runs["graphed"]["losses"][0]
              or name == "accum", f"{name}: loss did not fall")
        if not (cmp["bitwise"] and cmp["losses_equal"]):
            cmp["note"] = REPLAY_NOTE
            check(max(abs(a - b) / abs(b) for a, b in zip(
                runs["graphed"]["losses"], runs["body"]["losses"]))
                <= TRAIN_LOSS_RTOL, f"{name}: graphed and body losses "
                f"{runs['graphed']['losses']} {runs['body']['losses']}")
        # the counts of the last replay, checked equal to ``per`` above
        out[name] = {**runs, "compare": cmp, "launches_per_step":
                     list(runs["graphed"]["launches"][-1])}
        torch.cuda.empty_cache()
    return out


def programs_moe_sgd(attention, workload):
    """Phase 37c: mixtral_like(seq=1024) batch 1 SGD at lr 0.1 (phase
    10's), graphed against bodies from the same seeded init, no flash
    launch, each traced."""
    cfg = workload.ModelConfig.mixtral_like(seq=1024)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, (1, cfg.seq)), device="cuda")

    def sgd(graphs):
        step, _, _ = workload.make_sharded_train_step(None, cfg, lr=0.1)
        step._programs.graphs = graphs
        params = seeded_params(workload, cfg)
        return lambda: step(params, tokens)[1], params

    runs, cmp = graphed_vs_body(attention, workload, cfg, sgd,
                                MOE_PROGRAM_STEPS,
                                "mixtral_like SGD step seq 1024")
    for kind, run in runs.items():
        check(all(tuple(c) == (0, 0, 0) for c in run["launches"]),
              f"mixtral_like {kind}: flash launches {run['launches']}")
    if not (cmp["bitwise"] and cmp["losses_equal"]):
        cmp["note"] = REPLAY_NOTE
    torch.cuda.empty_cache()
    return {**runs, "compare": cmp}


def sample_loop(decode, params, cfg, prompt, steps, seed, graphed):
    """``decode.sample``'s loop written out (prefill, first draw, then
    ``decode._sampled_step`` once a token) with ``graphed`` chosen, the
    replays after the capture sync-free but the last SAMPLE_TRACED, which
    are :func:`traced`: (tokens (b, steps + 1), the trace)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b, s0 = prompt.shape
    sampling = (SAMPLED["temperature"], 0, SAMPLED["top_p"])
    cache = decode.init_kv_cache(cfg, b, s0 + steps, "cuda")
    logits, _ = decode.prefill(params, cache, prompt, cfg)
    tok = decode.sample_token(logits[:, s0 - 1], gen, *sampling)
    out = torch.empty((b, steps + 1), dtype=torch.long, device="cuda")
    out[:, 0] = tok
    pos = torch.full((), s0, dtype=torch.long, device="cuda")
    step = decode._sampled_step(params, cache, tok.clone(), pos, out, s0,
                                cfg, gen, sampling, graphed=graphed)
    step()
    with sync_free() if graphed else contextlib.nullcontext():
        for _ in range(steps - 1 - SAMPLE_TRACED):
            step()
    name = "graphed" if graphed is None else "body"
    trace = traced(step, f"llama_like_big sampled step batch 8 {name}")
    torch.cuda.synchronize()
    return out, trace


def programs_sample(decode, workload):
    """Phase 37d: sampled ``sample`` on llama_like_big at batch 8 (128-token
    prompts, T 0.8, top-p 0.95), 64 tokens under one generator seed: the
    public call, the loop graphed (replays sync-free) and through its body
    give the same tokens, the loop's last steps traced each way; seconds
    a token by the slope between two lengths (the median of three calls
    each), for ``sample``, ``sample`` without the nucleus filter (top-p 1)
    and greedy ``generate``."""
    cfg = workload.ModelConfig.llama_like_big()
    params = seeded_params(workload, cfg)
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (SAMPLE_BATCH, SAMPLE_PROMPT),
                           generator=gen, device="cuda")
    seed = 3

    def public(steps, top_p=SAMPLED["top_p"]):
        return decode.sample(params, prompt, cfg, steps,
                             torch.Generator(device="cuda").manual_seed(seed),
                             temperature=SAMPLED["temperature"], top_p=top_p)

    with torch.no_grad():
        got = public(SAMPLE_STEPS)
        graphed, graphed_trace = sample_loop(decode, params, cfg, prompt,
                                             SAMPLE_STEPS, seed, None)
        body, body_trace = sample_loop(decode, params, cfg, prompt,
                                       SAMPLE_STEPS, seed, False)
        check(torch.equal(got, graphed) and torch.equal(got, body),
              "sampled sample: graphed and body tokens differ")
        check(bool(((got >= 0) & (got < cfg.vocab)).all()),
              "sampled tokens out of the vocabulary")
        per_token = {}
        for name, fn in (("sample", public),
                         ("sample_top_p_1", functools.partial(public,
                                                              top_p=1.0)),
                         ("generate", lambda k:
                          decode.generate(params, prompt, cfg, k))):
            # each call prefills and captures anew: the median of three a
            # length, so one slow capture does not tilt the slope
            t = [float(np.median([fenced_s(functools.partial(fn, k))
                                  for _ in range(3)])) for k in SAMPLE_SLOPE]
            per_token[name] = (t[1] - t[0]) / (SAMPLE_SLOPE[1]
                                               - SAMPLE_SLOPE[0])
    return {"tokens_equal": True, "batch": SAMPLE_BATCH,
            "prompt": SAMPLE_PROMPT, "steps": SAMPLE_STEPS,
            "idle_share": {"graphed": graphed_trace["idle_share_unprofiled"],
                           "body": body_trace["idle_share_unprofiled"]},
            "step_ms": {k: 1e3 * v for k, v in per_token.items()},
            "distinct_tokens": int(torch.unique(got).numel())}


def host_draws(decode, margins):
    """The engine's keyed draw as the host made it before its tick drew on
    the device (the adjusted rows copied over, ``keyed_categorical`` each),
    recording each draw's distance from the nearer edge of its CDF
    interval in ``margins``."""
    def draw(adj, keys, rows):
        toks = []
        for row, key, r in zip(adj.cpu().numpy(), keys.tolist(),
                               rows.tolist()):
            key &= (1 << 64) - 1
            cdf = np.cumsum(decode.probs_from_adjusted(row))
            u = decode.keyed_uniform(key, r)
            tok = decode.keyed_categorical(row, key, r)
            lo = cdf[tok - 1] if tok else 0.0
            margins.append(min(u - lo, max(cdf[tok], 1.0 if tok ==
                                           len(cdf) - 1 else 0.0) - u))
            toks.append(tok)
        return torch.tensor(toks, device=adj.device)
    return draw


def programs_keyed(serve, decode, workload, mono):
    """Phase 37e: phase 3's 16 requests, request-keyed (T 0.8, top-p 0.95,
    seed 7), drained by the graphed engine, whose decode tick draws on the
    device, and by an engine that runs its bodies with every draw made on
    the host (``keyed_categorical``): equal streams, and the smallest
    distance of a host uniform from its CDF edges; then KEYED_REPLAYS
    replays of the keyed tick sync-free; tokens/s beside phase 3's greedy
    engine."""
    cfg = workload.ModelConfig.llama_like_big()
    params = seeded_params(workload, cfg)
    reqs = make_requests(cfg, serve)
    margins: list = []
    out, streams = {}, {}
    for name in ("graphed", "host draws"):
        eng = serve.ServeEngine(params, cfg, device="cuda", **SERVE_GEOMETRY,
                                **SAMPLED)
        host = name == "host draws"
        eng._graphs = not host
        draw = serve.keyed_draw
        if host:
            serve.keyed_draw = host_draws(decode, margins)
        try:
            eng.warmup()
            for r in reqs:
                eng.submit(r)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            done = eng.run_until_drained()
            torch.cuda.synchronize()
            drain_s = time.perf_counter() - t0
        finally:
            serve.keyed_draw = draw
        check_completions(done, reqs, cfg.vocab, f"keyed {name}")
        streams[name] = {c.rid: c.tokens.tolist() for c in done}
        tokens = sum(len(c.tokens) for c in done)
        out[name] = {"ticks": eng.tick_count, "drain_s": drain_s,
                     "tokens_per_s": tokens / drain_s}
        if not host:
            prog = eng._program(("decode",))
            values = {"tokens": eng.next_tok, "pos": eng.pos,
                      "keys": [decode.as_int64(k) for k in eng.slot_key]}
            first = prog(**values).clone()
            with sync_free():
                for _ in range(KEYED_REPLAYS):
                    prog(**values)
            torch.cuda.synchronize()
            check(torch.equal(prog.outputs, first) and prog.graph is not None,
                  "keyed tick replays differ or were not captured")
        del eng
    differ = [r for r in streams["graphed"]
              if streams["graphed"][r] != streams["host draws"][r]]
    check(not differ, f"keyed streams {differ} differ from the host draws'")
    return {**out, "streams_equal": True, "draws": len(margins),
            "min_cdf_margin": float(min(margins)),
            "sync_free_replays": KEYED_REPLAYS,
            "phase3_greedy_tokens_per_s": mono["stats"]["tokens_per_s"]}


def phase_train_programs(attention, decode, optim, serve, workload,
                         mono) -> dict:
    """Phase 37 (module docstring). Returns the per-step launches of the
    captured AdamW step."""
    t0 = time.perf_counter()
    train = programs_adamw(attention, optim, workload)
    moe = programs_moe_sgd(attention, workload)
    sampled = programs_sample(decode, workload)
    with torch.no_grad():
        keyed = programs_keyed(serve, decode, workload, mono)
    for name, rec in (("adamw", train["adamw"]), ("accum", train["accum"]),
                      ("mixtral_sgd", moe)):
        print(json.dumps({"train_program": name, **{
            k: {kk: vv for kk, vv in v.items() if kk != "trace"}
            if isinstance(v, dict) and "trace" in v else v
            for k, v in rec.items()}}))
    print(json.dumps({"sampled_sample": sampled}))
    print(json.dumps({"keyed_serving": keyed}))
    summary = {
        "train_programs_summary": True,
        "step_ms": {name: {k: rec[k]["step_ms"] for k in ("graphed", "body")}
                    for name, rec in (("adamw", train["adamw"]),
                                      ("accum", train["accum"]),
                                      ("mixtral_sgd", moe))},
        "bitwise": {name: rec["compare"]["bitwise"]
                    and rec["compare"]["losses_equal"]
                    for name, rec in (("adamw", train["adamw"]),
                                      ("accum", train["accum"]),
                                      ("mixtral_sgd", moe))},
        "idle_share": {name: {k: rec[k]["trace"].get(
            "idle_share_unprofiled") for k in ("graphed", "body")}
            for name, rec in (("adamw", train["adamw"]),
                              ("mixtral_sgd", moe))},
        "sample_step_ms": sampled["step_ms"],
        "sample_idle_share": sampled["idle_share"],
        "keyed_tokens_per_s": {k: keyed[k]["tokens_per_s"]
                               for k in ("graphed", "host draws")},
        "min_cdf_margin": keyed["min_cdf_margin"],
        "phase_s": time.perf_counter() - t0}
    print(json.dumps(summary))
    return {"adamw_per_step": train["adamw"]["launches_per_step"],
            "accum_per_step": train["accum"]["launches_per_step"],
            **summary}


EMIT_KEYS = ["metric", "value", "unit", "vs_baseline"]


def runner_line(bench, ctx, name) -> dict:
    """The runner's one-line group ``name`` run in this process on
    ``ctx``: its printed line echoed and parsed back, held to the
    reference's ``emit`` keys first, then the runner's ``line``, ``card``
    and ``peaks_gib``."""
    buf = io.StringIO()
    ctx.start(name)
    with contextlib.redirect_stdout(buf):
        bench.LINES[name](ctx)
    texts = buf.getvalue().splitlines()
    print("\n".join(texts))
    check(len(texts) == 1, f"runner line {name} printed {len(texts)} lines")
    rec = json.loads(texts[0])
    check(list(rec)[:4] == EMIT_KEYS and isinstance(rec["metric"], str)
          and rec["line"] == name and rec["card"] == ctx.card
          and all(isinstance(p, list) and len(p) == 2 and p[0] > 0
                  for p in rec["peaks_gib"].values()),
          f"runner line {name}: fields {rec}")
    return rec


def phase_runner(attention, bench, budget, smi: str) -> dict:
    """Phase 38 (module docstring). Returns the xl gate's launches over
    its steps, the steps, and the kernels' times at :data:`XL_SHAPE`."""
    t0 = time.perf_counter()
    ctx = bench.context()
    check(ctx.card == smi, f"the runner reads the card as {ctx.card!r}, "
          f"nvidia-smi as {smi!r}")
    decode_line = runner_line(bench, ctx, "decode")
    check(decode_line["unit"] == "tokens/s" and decode_line["value"] > 0
          and decode_line["vs_baseline"] == 1.0
          and 0 < decode_line["hbm_bandwidth_utilization"] < 1,
          f"decode line: {decode_line}")
    spec_line = runner_line(bench, ctx, "spec_solo")
    check(spec_line["plain_calls"] == ctx.sizes.spec_steps + 1
          and spec_line["target_calls"] < spec_line["plain_calls"]
          and spec_line["accepted"] <= spec_line["drafted"],
          f"spec_solo line: {spec_line}")
    if spec_line["value"] is None:      # the reference's divergence line
        check(spec_line["near_tie"]["margin"] <= bench.NEAR_TIE
              and "DIVERGED" in spec_line["metric"],
              f"spec_solo line: {spec_line}")
    else:
        check(spec_line["unit"] == "tokens/s" and spec_line["value"] > 0
              and spec_line["spec_s"] > 0 and spec_line["plain_s"] > 0,
              f"spec_solo line: {spec_line}")
    # the xl gate: pure-bf16 AdamW on full-width llama_like_xl, launches
    # counted through the captured step's replays
    ctx.start("adamw_xl gate")
    xl = ctx.model("llama_like_xl", ctx.sizes.big_seq)
    gate = ctx.measured("gate", bench.xl_gate, ctx, xl)
    steps = bench.XL_GATE_STEPS
    per_step = [2 * xl.n_layers, xl.n_layers, xl.n_layers]    # remat: K1 twice
    check(gate["flash_launches"] == [steps * n for n in per_step]
          and gate["mu_dtype"] == gate["nu_dtype"] == "bfloat16",
          f"xl gate: {gate}, wanted {per_step} launches a step")
    print(json.dumps({"xl_gate": gate, "per_step": per_step,
                      "peak_allocated_reserved_gib": ctx.peaks["gate"],
                      "budget_total_gib": budget.train_hbm_breakdown(
                          xl, 1, mu_dtype="bf16").total_gib}))
    ctx.start("xl timing")
    timing = phase_training_timing(attention, XL_SHAPE, "xl training shape")
    print(json.dumps({"phase_38_s": time.perf_counter() - t0}))
    return {"launches": gate["flash_launches"], "steps": steps,
            "timing": timing}


# -- the engine, generate(tp=) and sample(tp=) over a mesh as chains (39) -----

MESH_GRAPHED_TICKS = 24     # phase 20 drains the tp 2 engine graphed whole
MESH_TINY_STEPS = 7


def chain_counts(prog) -> list:
    """[segments, collectives its warm-up ran] of a program."""
    return [len(prog.segments), prog.warmup_collectives]


def program_segments(eng) -> dict:
    """:func:`chain_counts` by program of a card engine (key joined by
    '/'): [0, 0] for a program run through its body."""
    return {"/".join(map(str, key)): chain_counts(prog)
            for key, prog in eng._programs.items()}


def check_segments(segments: dict, what) -> None:
    """Every captured program over a mesh made collectives in its warm-up
    and broke its chain at each: one segment more than them
    (``tests/test_torch_mesh_program.py`` pins the collectives of one body
    call of each program on the CPU, kind by kind)."""
    for key, (got, collectives) in segments.items():
        check(collectives > 0 and got == collectives + 1,
              f"{what}: program {key} captured {got} segments for the "
              f"{collectives} collectives of its warm-up")


def bitwise(rec, what) -> None:
    check(rec["output_bitwise"] and rec["arena_bitwise"],
          f"{what}: {rec['program']}'s replay differs from its body: {rec}")


def mesh_serve(attention, serve, mesh, params, cfg, reqs, label, graphs,
               compare=None, trace=True, ticks=None, **kw) -> dict:
    """One rank's engine at phase 3's geometry on ``mesh``, graphed or
    through its bodies (``_graphs = False``): warmed (timed: a graphed
    engine captures there), ``reqs`` submitted, PROGRAM_TICKS ticks run,
    ``compare(eng)`` where given (replays held against bodies), then
    ticked until drained or, with ``ticks``, until its tick count reaches
    it, with tick 10 traced on rank 0 when ``trace``: the untraced ticks'
    mean (admissions included, as phase 35 takes it) and median. K1
    counted from the engine's construction (the comparisons leave the
    counters as they were)."""
    kind = "graphed" if graphs else "bodies"
    attention.FLASH_FWD_LAUNCHES = 0
    eng = serve.ServeEngine(params, cfg, mesh=mesh, **SERVE_GEOMETRY, **kw)
    eng._graphs = graphs
    warm_s = fenced_s(eng.warmup)
    for r in reqs:
        eng.submit(r)
    for _ in range(PROGRAM_TICKS):
        eng.tick()
    recs = compare(eng) if compare is not None else []
    traced_label = (f"{label} {kind} tick, {mesh.shape}"
                    if trace and mesh.rank == 0 else None)
    times = []
    with contextlib.redirect_stdout(io.StringIO()):
        summary, drain_s = drain_traced(eng, traced_label, "cuda",
                                        times=times, until=ticks)
    torch.cuda.synchronize()
    if ticks is None:
        check_completions(eng.completions, reqs, cfg.vocab,
                          f"{label} {kind} on {mesh.shape}")
    out = {"tokens": {c.rid: c.tokens for c in eng.completions},
           "comparisons": recs,
           "flash_launches": attention.FLASH_FWD_LAUNCHES,
           "prefills": eng.prefills + eng.draft_prefills,
           "ticks": eng.tick_count, "spec_stats": dict(eng.spec_stats),
           "tick_ms": 1e3 * drain_s / len(times), "warmup_s": warm_s,
           "median_tick_ms": 1e3 * float(np.median(times)),
           "segments": program_segments(eng),
           "breaks_run": sum(p.breaks_run for p in eng._programs.values()),
           "trace": summary}
    del eng
    torch.cuda.empty_cache()
    return out


def compare_plain(attention, cfg):
    def compare(eng):
        recs = [replay_vs_body(attention, eng._program(("decode",)),
                               eng.cache, {"tokens": eng.next_tok,
                                           "pos": eng.pos}, "decode_tick")]
        for bucket in SERVE_BUCKETS:
            recs.append(replay_vs_body(
                attention, eng._program(("prefill", bucket, False)),
                eng.cache, prefill_values(cfg, bucket), f"prefill_{bucket}"))
        return recs
    return compare


def compare_round(attention):
    def compare(eng):
        pos = eng._round_positions()
        draft = eng._program(("draft",))
        recs = [replay_vs_body(attention, draft, eng.draft_cache,
                               {"feed2": np.stack([eng.prev_tok,
                                                   eng.next_tok], axis=1),
                                "pos": pos}, "draft_tick")]
        scored = np.concatenate([eng.next_tok[:, None],
                                 draft.outputs.cpu().numpy()], axis=1)
        recs.append(replay_vs_body(attention, eng._program(("verify",)),
                                   eng.cache, {"scored": scored, "pos": pos},
                                   "verify_span"))
        return recs
    return compare


def mesh_tiny(attention, decode, serve, workload, mesh) -> dict:
    """Phase 39e on one rank: tiny f32 (TINY_GQA, TF32 off) at tp = 2,
    chunked, prefix, int8, request-keyed and sampled-round engines
    graphed and through their bodies (their streams and segments), and
    ``generate(tp=)``/``sample(tp=)`` graphed and through their step's
    body."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = dataclasses.replace(workload.ModelConfig.tiny(), **TINY_GQA)
    params = seeded_params(workload, base)
    rng = np.random.default_rng(2)
    reqs = [serve.Request(
        rid=i, prompt=rng.integers(0, base.vocab, size=int(rng.integers(4, 14)),
                                   dtype=np.int32),
        max_new_tokens=int(rng.integers(3, 8))) for i in range(5)]
    prefix = rng.integers(0, base.vocab, 12, dtype=np.int32)
    keyed = dict(temperature=0.8, top_k=24, seed=5, request_keyed=True)
    modes = {  # mode -> (cfg, engine kwargs, registered prefix)
        "chunked": (base, dict(chunk_prefill=5), False),
        "prefix": (base, dict(chunk_prefill=5), True),
        "int8": (dataclasses.replace(base, kv_cache_dtype="int8"), {}, False),
        "request_keyed": (base, keyed, False),
        "sampled_round": (base, dict(draft_params=params, draft_cfg=base,
                                     spec_k=3, **keyed), False)}
    out = {}
    for mode, (cfg, kw, use_prefix) in modes.items():
        mreqs = [dataclasses.replace(r, prefix_id="sys")
                 if use_prefix and r.rid % 2 == 0 else r for r in reqs]
        runs = {}
        for graphs in (True, False):
            eng = serve.ServeEngine(params, cfg, mesh=mesh, device="cuda",
                                    slots=2, max_seq=64, prompt_bucket=16,
                                    **kw)
            eng._graphs = graphs
            if use_prefix:
                eng.register_prefix("sys", prefix)
            for r in mreqs:
                eng.submit(r)
            runs[graphs] = ({c.rid: c.tokens.tolist()
                             for c in eng.run_until_drained()},
                            dict(eng.spec_stats), program_segments(eng))
        check(runs[True][:2] == runs[False][:2],
              f"tiny f32 {mode} at tp 2: graphed {runs[True][:2]} != bodies "
              f"{runs[False][:2]}")
        check_segments(runs[True][2], f"tiny {mode}")
        out[mode] = {"tokens": runs[True][0], "segments": runs[True][2]}
    shards = workload.shard_params(params, base, mesh)
    prompt = torch.as_tensor(rng.integers(0, base.vocab, (2, 9)),
                             device="cuda")
    steps, s0 = MESH_TINY_STEPS, prompt.shape[1]
    gen = decode.Generation(shards, base, 2, s0, steps, "cuda", mesh.tp)
    graphed = gen(prompt)
    segments = {"greedy_step": chain_counts(gen.step)}
    gen.step = decode._greedy_step(
        gen.params, gen.cache, torch.zeros(2, dtype=torch.long,
                                           device="cuda"),
        gen.pos, gen.out, s0, base, mesh.tp, graphed=False)
    check(torch.equal(graphed, gen(prompt)),
          "generate(tp=): graphed and body tokens differ")
    sampled = {}
    for graphed_step in (None, False):
        sampled[graphed_step] = tp_sample_loop(decode, shards, base, prompt,
                                               steps, mesh.tp, graphed_step)
    segments["sampled_step"] = sampled[None][1]
    check(torch.equal(sampled[None][0], sampled[False][0]),
          "sample(tp=): graphed and body tokens differ")
    public = decode.sample(shards, prompt, base, steps,
                           torch.Generator(device="cuda").manual_seed(11),
                           0.8, top_k=24, tp=mesh.tp)
    check(torch.equal(public, sampled[None][0]),
          "sample(tp=): the public call differs from its loop")
    check_segments(segments, "tiny decode steps at tp 2")
    out["decode"] = {"generate": graphed.tolist(),
                     "sample": public.tolist(), "segments": segments}
    return out


def tp_sample_loop(decode, params, cfg, prompt, steps, tp, graphed):
    """``decode.sample``'s loop over tp shards written out (the first draw
    tp rank 0's, broadcast), its step built with ``graphed``, the
    generator seeded 11 on every rank: (tokens, its :func:`chain_counts`)."""
    from tpusched_torch.mesh import broadcast
    gen = torch.Generator(device="cuda").manual_seed(11)
    b, s0 = prompt.shape
    sampling = (0.8, 24, 1.0)
    cache = decode.init_kv_cache(cfg, b, s0 + steps, "cuda", tp)
    logits, _ = decode.prefill(params, cache, prompt, cfg, tp)
    tok = broadcast(decode.sample_token(logits[:, s0 - 1], gen, *sampling),
                    tp)
    out = torch.empty((b, steps + 1), dtype=torch.long, device="cuda")
    out[:, 0] = tok
    pos = torch.full((), s0, dtype=torch.long, device="cuda")
    step = decode._sampled_step(params, cache, tok.clone(), pos, out, s0,
                                cfg, gen, sampling, graphed=graphed, tp=tp)
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    return out, chain_counts(step)


def bodies_drain(serve, params, cfg, mesh, reqs, what) -> dict:
    """``reqs`` drained at phase 3's geometry on ``mesh`` by an engine that
    calls its programs' bodies (no warm-up: a drain's streams do not
    depend on it): the streams by rid."""
    eng = serve.ServeEngine(params, cfg, mesh=mesh, **SERVE_GEOMETRY)
    eng._graphs = False
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    check_completions(done, reqs, cfg.vocab, what)
    return {c.rid: c.tokens for c in done}


def mesh_programs_rank(mesh):
    """Phase 39 on one of two gloo ranks sharing the card (module
    docstring): {"tp": 2}, then {"ep": 2} over the same ranks, each part
    timed."""
    from tpusched_torch import attention, decode, serve, workload
    from tpusched_torch import mesh as tmesh
    cfg = workload.ModelConfig.llama_like_big()
    moe = workload.ModelConfig.mixtral_like()
    params = seeded_params(workload, cfg)
    reqs = make_requests(cfg, serve)
    # a self-draft: the target's weights propose, so drafts are accepted
    # (a random llama_like draft agrees with no token) and the round's
    # accept and reject paths both run
    draft = dict(draft_params=params, draft_cfg=cfg, spec_k=SPEC_K)
    round_label = "llama_like_big self-draft round"
    parts = {
        "tp_serving": lambda: {
            "graphed": mesh_serve(
                attention, serve, mesh, params, cfg, reqs, "llama_like_big",
                True, compare_plain(attention, cfg), ticks=MESH_GRAPHED_TICKS),
            "bodies": mesh_serve(attention, serve, mesh, params, cfg, reqs,
                                 "llama_like_big", False)},
        "tp_round": lambda: {
            "graphed": mesh_serve(attention, serve, mesh, params, cfg, reqs,
                                  round_label, True, compare_round(attention),
                                  trace=False, **draft),
            "bodies": mesh_serve(attention, serve, mesh, params, cfg, reqs,
                                 round_label, False, trace=False, **draft)},
        "tiny": lambda: mesh_tiny(attention, decode, serve, workload, mesh),
        "ep_bodies": lambda: bodies_drain(
            serve, seeded_params(workload, moe), moe,
            tmesh.build_named_mesh(EP_SERVE_MESH, "gloo", "cuda"),
            make_requests(moe, serve), "mixtral_like ep bodies")}
    out = {}
    with torch.no_grad():
        for name, part in parts.items():
            t0 = time.perf_counter()
            out[name] = part()
            out[f"{name}_s"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
    return out


def mesh_line(run: dict) -> dict:
    """A drain's record for the printed line: launches, ticks, the tick's
    ms, breaks run, and where it was traced the traced tick's device busy
    time and idle share (against the traced wall and against the
    untraced mean tick)."""
    line = {"flash_launches": run["flash_launches"],
            "prefills": run["prefills"], "ticks": run["ticks"],
            "spec_stats": run["spec_stats"], "tick_ms": run["tick_ms"],
            "warmup_s": run["warmup_s"],
            "median_tick_ms": run["median_tick_ms"],
            "breaks_run": run["breaks_run"]}
    trace = run["trace"]
    if trace is None:
        return line
    return {**line, "traced_kernels": trace["kernels"],
            "traced_graph_launches": trace["graph_launches"],
            "traced_syncs": trace["syncs"],
            "device_busy_ms": 1e3 * trace["device_busy_s"],
            "traced_wall_ms": 1e3 * trace["wall_s"],
            "idle_share": trace["idle_share"],
            "idle_share_vs_tick_ms": 1.0 - 1e3 * trace["device_busy_s"]
            / run["tick_ms"], "trace_file": trace["file"]}


def mesh_refs(results: dict) -> dict:
    """Phase 39's references from the results of phases 20 and 26."""
    return {"tp": results["20-22"]["two"][0]["llama_like_big"]["tokens"],
            "tp_launches": [r["llama_like_big"]["launches"]
                            for r in results["20-22"]["two"]],
            "ep": results["26"]["tokens"]}


def phase_mesh_programs(workload, refs) -> dict:
    """Phase 39 (module docstring): one group of two gloo ranks sharing
    the card, then the checks, against ``refs()`` too where it gives them
    (read after the group, once phases 20 and 26 have run their checks):
    phase 20's graphed drain of the same engine (``tp``: rank 0's streams;
    ``tp_launches``: K1 a rank through its replays) and phase 26's
    (``ep``). Phase 32 holds fsdp's graphed drain against its bodies'
    itself. Returns K1's launches a rank for the kernels line."""
    t0 = time.perf_counter()
    group, = yield (spawn("39 mesh programs", mesh_programs_rank,
                          {"tp": 2}),)
    ranks = group.result
    refs = refs()
    cfg = workload.ModelConfig.llama_like_big()

    def same(a, b):
        return a.keys() == b.keys() and all(np.array_equal(a[i], b[i])
                                            for i in a)

    for part in ("tp_serving", "tp_round"):
        for kind in ("graphed", "bodies"):
            runs = [r[part][kind] for r in ranks]
            for run in runs:
                check(same(run["tokens"], runs[0]["tokens"]),
                      f"{part} {kind}: the ranks' streams differ")
                # K1 once a layer a prefill, the self-draft's included
                check(run["flash_launches"]
                      == flash_layers(cfg) * run["prefills"],
                      f"{part} {kind}: {run['flash_launches']} K1 launches "
                      f"for {run['prefills']} prefills")
                for rec in run["comparisons"]:
                    bitwise(rec, f"{part} at tp 2")
                if kind == "graphed":
                    check_segments(run["segments"], part)
        g, b = ranks[0][part]["graphed"], ranks[0][part]["bodies"]
        # the tp 2 engine's graphed run stops after MESH_GRAPHED_TICKS:
        # its completions so far; the round's drains whole
        whole = (part == "tp_serving"
                 or g["tokens"].keys() == b["tokens"].keys())
        check(whole and all(np.array_equal(t, b["tokens"][rid])
                            for rid, t in g["tokens"].items()),
              f"{part}: the graphed and the bodies' streams differ")
    rnd = [r["tp_round"] for r in ranks]
    stats = [(r["graphed"]["spec_stats"], r["bodies"]["spec_stats"])
             for r in rnd]
    check(all(g == b and g["accepted"] > 0 for g, b in stats)
          and all(r["graphed"]["ticks"] == r["bodies"]["ticks"] for r in rnd),
          f"tp round: the graphed and the bodies' stats differ, or no draft "
          f"was accepted: {stats}")
    bodies = [r["tp_serving"]["bodies"] for r in ranks]
    # reported, not held: the round's verify span scores 5 positions in one
    # pass, which may flip a bf16 near tie against the one-token tick
    round_plain = sum(np.array_equal(t, bodies[0]["tokens"][rid])
                      for rid, t in rnd[0]["bodies"]["tokens"].items())
    # 12 x (16 requests + 2 warm-up prefills) = 216 at full width
    want = cfg.n_layers * (len(bodies[0]["tokens"]) + len(SERVE_BUCKETS))
    check(all(r["flash_launches"] == want for r in bodies)
          and all(n == want for n in refs.get("tp_launches", [want])),
          f"tp 2 serving: K1 {[r['flash_launches'] for r in bodies]} a rank "
          f"through the bodies, {refs.get('tp_launches')} through phase "
          f"20's replays, wanted {want}")
    if "tp" in refs:
        check(same(bodies[0]["tokens"], refs["tp"]),
              "tp 2 serving: the bodies' drain differs from phase 20's "
              "graphed drain")
    for r in ranks[1:]:
        check(r["tiny"] == ranks[0]["tiny"], "tiny at tp 2: the ranks differ")
        check(same(r["ep_bodies"], ranks[0]["ep_bodies"]),
              "ep bodies: the ranks' streams differ")
    if "ep" in refs:
        check(same(ranks[0]["ep_bodies"], refs["ep"]),
              "mixtral_like on ep 2: the bodies' drain differs from phase "
              "26's graphed drain")
    line = {
        "mesh_programs": "llama_like_big", "mesh": {"tp": 2},
        "backend": "gloo", "ranks_agree": True,
        "replay_equals_body_bitwise": [
            rec["program"] for part in ("tp_serving", "tp_round")
            for rec in ranks[0][part]["graphed"]["comparisons"]],
        "segments": {part: ranks[0][part]["graphed"]["segments"]
                     for part in ("tp_serving", "tp_round")},
        "flash_launches_per_rank": {
            "phase_20_replays": refs.get("tp_launches"),
            "bodies": [r["flash_launches"] for r in bodies]},
        "bodies_streams_equal_phase_20_graphed": "tp" in refs,
        "graphed_ticks": MESH_GRAPHED_TICKS,
        **{f"{part}_{kind}": mesh_line(ranks[0][part][kind])
           for part in ("tp_serving", "tp_round")
           for kind in ("graphed", "bodies")},
        "round_draft": "self: llama_like_big on the target's weights",
        "round_requests": len(rnd[0]["bodies"]["tokens"]),
        "round_streams_equal_plain_bodies": round_plain,
        "note": GLOO_NOTE + "; says nothing of NCCL or NVLink",
        **group.note()}
    print(json.dumps(line))
    print(json.dumps({
        "mesh_programs": "tiny f32 tp 2, mixtral_like ep 2",
        "tiny_graphed_equal_bodies": sorted(ranks[0]["tiny"]),
        "tiny_segments": {m: v["segments"]
                          for m, v in ranks[0]["tiny"].items()},
        "ep_bodies_equal_phase_26_graphed": "ep" in refs,
        "fsdp": "phase 32: its snapshot drain through the bodies == its "
                "graphed in-memory drain",
        "seconds_rank_0": {k: v for k, v in ranks[0].items()
                           if k.endswith("_s")},
        "phase_39_s": time.perf_counter() - t0}))
    return {"tp2_serving_bodies_per_rank": [r["flash_launches"]
                                            for r in bodies],
            "tp2_round_replays_per_rank": [r["graphed"]["flash_launches"]
                                           for r in rnd],
            "tp2_round_bodies_per_rank": [r["bodies"]["flash_launches"]
                                          for r in rnd]}


# -- phase 40: the mesh train steps and the GPipe step as chains ------------

MESH_TRAIN_STEPS = 3
TINY_ACCUM_MESH = {"dp": 2, "tp": 2}
# name -> (mesh, group label), the group that takes the whole card first;
# each case's model, batch and optimizer are an earlier phase's
# (:func:`mesh_train_case`)
MESH_TRAIN_CASES = {
    "fsdp_sp_adamw": (SP_MESH, "40 fsdp x sp adamw"),
    "tp2_adamw": ({"tp": 2}, "40 tp 2 adamw"),
    "dp_ep_sgd": (EP_MESH, "40 dp x ep sgd"),
    "pp_gpipe": (PP_MESH, "40 pp"),
    "tiny_accum": (TINY_ACCUM_MESH, "40 tiny accum"),
}


def mesh_train_case(mesh, name):
    """Phase 40's case ``name`` on this rank: (this rank's initial shards,
    ``make(graphs, shards)`` -> (a call running one step and returning its
    loss, the step), its (K1, K2, K3) launches a step)."""
    from tpusched_torch import optim, pipeline, workload
    if name == "pp_gpipe":          # phase 27's
        cfg = pp_cfg(workload)
        shards = tuple(pipeline.shard_pipeline_params(
            pipeline.init_pipeline_params(
                cfg, torch.Generator(device="cuda").manual_seed(0), "cuda"),
            cfg, mesh))
        tokens = pp_tokens(cfg)
        per = cfg.n_layers // mesh.shape["pp"] * PP_MICRO

        def make(graphs, params):
            step, _, _ = pipeline.make_pipeline_train_step(mesh, cfg,
                                                           PP_MICRO, PP_LR)
            step._programs.graphs = graphs
            return (lambda: step(params, tokens)[1]), step
        return shards, make, (per, per, per)
    if name == "tp2_adamw":         # phase 22's (train_big)
        cfg = workload.ModelConfig.llama_like_big(seq=4096)
        tokens = torch.as_tensor(np.random.default_rng(0).integers(
            0, cfg.vocab, (1, cfg.seq)), device="cuda")
        want = (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)
    elif name == "fsdp_sp_adamw":   # phase 24's
        cfg = dataclasses.replace(sp_big_cfg(workload), attn="ringflash")
        tokens = sp_big_tokens(cfg)
        i = 1 + mesh.sp.index
        want = (2 * cfg.n_layers * i, cfg.n_layers * i, cfg.n_layers * i)
    elif name == "dp_ep_sgd":       # phase 26's
        cfg = ep_cfg(workload)
        tokens = torch.as_tensor(np.random.default_rng(26).integers(
            0, cfg.vocab, (2, cfg.seq)), device="cuda")
        want = (0, 0, 0)
    else:                           # tiny f32, 2 microbatches a stack
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = dataclasses.replace(workload.ModelConfig.tiny(), **TINY_GQA,
                                  remat=True)
        tokens = torch.as_tensor(np.random.default_rng(40).integers(
            0, cfg.vocab, (2, 4, cfg.seq)), device="cuda")
        want = (4 * cfg.n_layers, 2 * cfg.n_layers, 2 * cfg.n_layers)
    shards = workload.shard_params(seeded_params(workload, cfg), cfg, mesh)
    torch.cuda.empty_cache()

    def make(graphs, params):
        if name == "dp_ep_sgd":
            step, _, _ = workload.make_sharded_train_step(mesh, cfg,
                                                          lr=EP_LR)
            step._programs.graphs = graphs
            return (lambda: step(params, tokens)[1]), step
        if name == "tiny_accum":
            step, init, _, _ = workload.make_accum_train_step(
                mesh, cfg, optim.adamw(1e-3), 2)
        else:
            step, init, _, _ = workload.make_optax_train_step(
                mesh, cfg, optim.adamw(1e-4, mu_dtype=torch.float32))
        step._programs.graphs = graphs
        state = init(params)
        return (lambda: step(params, state, tokens)[2]), step
    return shards, make, want


def step_programs(step) -> list:
    """A train step's programs: the step program, or the accumulation's
    micro-step and update (without the bias-correction buffers)."""
    from tpusched_torch.program import Program
    progs = step._programs.programs
    return [p for p in (progs if isinstance(progs, tuple) else (progs,))
            if isinstance(p, Program)]


def mesh_train_run(attention, make, shards, graphs, snapshots=None):
    """MESH_TRAIN_STEPS steps of ``make(graphs, copy of shards)``, each
    fenced and timed, its (K1, K2, K3) launches counted; after each, the
    shards held bitwise against ``snapshots`` (that step's, from the other
    run) or kept as them. On the chained run, the cuts the capture took
    on autograd's thread (the backward's) are counted."""
    import threading
    from tpusched_torch import program, workload
    params = workload.tree_map(torch.clone, shards)
    if isinstance(shards, tuple):
        params = tuple(params)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    call, step = make(graphs, params)
    cut, off_main = program._Chain.cut, []

    def counted(chain, collective):
        off_main.append(threading.current_thread()
                        is not threading.main_thread())
        cut(chain, collective)

    program._Chain.cut = counted
    losses, step_s, launches, equal, kept = [], [], [], [], []
    try:
        for i in range(MESH_TRAIN_STEPS):
            zero_counts(attention)
            t0 = time.perf_counter()
            losses.append(call().item())              # the fence
            step_s.append(time.perf_counter() - t0)
            launches.append(bwd_counts(attention))
            print(f"phase 40 rank {torch.distributed.get_rank()} "
                  f"{'chained' if graphs else 'bodies'} step {i}: "
                  f"{step_s[-1]:.3f} s", file=sys.stderr, flush=True)
            leaves = workload.tree_leaves(params)
            if snapshots is None:
                kept.append([t.clone() for t in leaves])
            else:
                equal.append(all(torch.equal(a, b) for a, b in
                                 zip(leaves, snapshots[i])))
                snapshots[i] = None
    finally:
        program._Chain.cut = cut
    out = {"losses": losses, "step_s": step_s, "launches": launches,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "peak_reserved_gib": torch.cuda.max_memory_reserved() / 2**30}
    if graphs:
        progs = step_programs(step)
        out.update(
            shards_equal=equal, cuts_on_autograd_thread=sum(off_main),
            cuts=len(off_main),
            segments=[chain_counts(p) for p in progs],
            breaks_run=[p.breaks_run for p in progs],
            break_kinds=[dict(collections.Counter(b.kind for b in p.breaks))
                         for p in progs])
    del call, step, params
    torch.cuda.empty_cache()
    return out, kept


def bypass_fails(mesh, where: str) -> dict:
    """A collective that goes straight to ``torch.distributed`` past the
    mesh's hook inside a mesh train step's capture, in the forward (the
    first collective the capture meets on the main thread) or in the
    backward (the first it meets on autograd's thread): the capture must
    raise. Tiny f32 SGD on ``mesh``; run last on its ranks, which all
    bypass the same collective (it fails before any message)."""
    import threading
    from tpusched_torch import mesh as tm, workload
    cfg = dataclasses.replace(workload.ModelConfig.tiny(), **TINY_GQA)
    step, _, _ = workload.make_sharded_train_step(mesh, cfg)
    params = workload.shard_params(seeded_params(workload, cfg), cfg, mesh)
    tokens = dryrun_tokens(cfg)
    real, hit = tm._collective, []

    def bypass(kind, fn, tensor, **kwargs):
        off_main = threading.current_thread() is not threading.main_thread()
        if tm._chain is not None and not hit and (where == "forward"
                                                   or off_main):
            hit.append((kind, off_main))
            fn(tensor, **kwargs)
            return
        real(kind, fn, tensor, **kwargs)

    tm._collective = bypass
    raised = None
    try:
        step(params, tokens)
    except Exception as e:             # the capture's refusal, checked
        raised = f"{type(e).__name__}: {str(e)[:240]}"
    finally:
        tm._collective = real
    return {"where": where, "bypassed": hit, "raised": raised,
            "chain_closed": tm._chain is None,
            "segments": len(step._programs.programs.segments)}


def mesh_train_rank(mesh, name):
    """Phase 40's case ``name`` on one rank: three steps through the
    bodies, then three chained from the same initial shards; the tp 2
    ranks then bypass the hook in a capture's forward, the tiny ranks in
    its backward."""
    from tpusched_torch import attention
    shards, make, want = mesh_train_case(mesh, name)
    bodies, snapshots = mesh_train_run(attention, make, shards, False)
    chained, _ = mesh_train_run(attention, make, shards, True, snapshots)
    del shards
    torch.cuda.empty_cache()
    out = {"bodies": bodies, "chained": chained, "want": want,
           "coord": dict(mesh.coord)}
    if name == "tp2_adamw":
        out["bypass"] = bypass_fails(mesh, "forward")
    elif name == "tiny_accum":
        out["bypass"] = bypass_fails(mesh, "backward")
    return out


def phase_mesh_train_programs():
    """Phase 40 (module docstring): one group a case of MESH_TRAIN_CASES,
    each rank's steps through the bodies and chained, then the checks.
    Returns the launches for the kernels line."""
    t0 = time.perf_counter()
    groups = yield tuple(spawn(label, mesh_train_rank, sizes, name)
                         for name, (sizes, label)
                         in MESH_TRAIN_CASES.items())
    launches = {}
    for (name, (sizes, _)), group in zip(MESH_TRAIN_CASES.items(), groups):
        for r, run in enumerate(group.result):
            g, b = run["chained"], run["bodies"]
            what = f"{name} rank {r}"
            check(g["losses"] == b["losses"] and all(g["shards_equal"])
                  and len(g["shards_equal"]) == MESH_TRAIN_STEPS,
                  f"{what}: chained losses {g['losses']} against the "
                  f"bodies' {b['losses']}, shards equal {g['shards_equal']}")
            check(all(np.isfinite(b["losses"])), f"{what}: {b['losses']}")
            check(all(c == run["want"] for c in g["launches"] + b["launches"]),
                  f"{what}: (K1, K2, K3) a step chained {g['launches']}, "
                  f"bodies {b['launches']}, wanted {run['want']}")
            check_segments({str(i): c for i, c in enumerate(g["segments"])},
                           what)
            # the backward's cuts come from autograd's device thread; the
            # pipeline's backward makes none (its hand-offs are between)
            check(g["cuts"] > g["cuts_on_autograd_thread"] > 0
                  or name == "pp_gpipe",
                  f"{what}: {g['cuts_on_autograd_thread']} of {g['cuts']} "
                  f"cuts on autograd's thread")
            if "bypass" in run:
                bp = run["bypass"]
                check(bp["raised"] is not None and bp["bypassed"]
                      and bp["chain_closed"] and bp["segments"] == 0,
                      f"{what}: a collective past the hook in a capture's "
                      f"{bp['where']} did not fail: {bp}")
        ranks = group.result
        key = {"tp2_adamw": "per_rank_per_step", "dp_ep_sgd":
               "per_rank_per_step", "pp_gpipe": "per_stage_per_step",
               "tiny_accum": "per_rank_per_step",
               "fsdp_sp_adamw": "per_step_by_sp_index"}[name]
        # a replayed step's
        if name == "fsdp_sp_adamw":
            launches[name] = {key: {r["coord"]["sp"]:
                                    r["chained"]["launches"][-1]
                                    for r in ranks}}
        else:
            launches[name] = {key: [r["chained"]["launches"][-1]
                                    for r in ranks]}

        def mean(xs):
            return sum(xs[1:]) / len(xs[1:])
        print(json.dumps({
            "mesh_train_program": name, "mesh": sizes, "backend": "gloo",
            "steps": MESH_TRAIN_STEPS,
            "losses": ranks[0]["chained"]["losses"],
            "chained_equal_bodies_bitwise": True,
            "launches_per_step": launches[name],
            "segments_warmup_collectives": [r["chained"]["segments"]
                                            for r in ranks],
            "break_kinds_rank_0": ranks[0]["chained"]["break_kinds"],
            "breaks_run_rank_0": ranks[0]["chained"]["breaks_run"],
            "cuts_on_autograd_thread_rank_0":
                ranks[0]["chained"]["cuts_on_autograd_thread"],
            "step_s_chained_per_rank": [r["chained"]["step_s"]
                                        for r in ranks],
            "step_s_bodies_per_rank": [r["bodies"]["step_s"] for r in ranks],
            "replayed_step_ms_rank_0": {
                "chained": 1e3 * mean(ranks[0]["chained"]["step_s"]),
                "bodies": 1e3 * mean(ranks[0]["bodies"]["step_s"])},
            "peak_mem_gib_per_rank": {k: [r[k]["peak_mem_gib"] for r in ranks]
                                      for k in ("chained", "bodies")},
            "peak_reserved_gib_per_rank": {
                k: [r[k]["peak_reserved_gib"] for r in ranks]
                for k in ("chained", "bodies")},
            "bypass": [r.get("bypass") for r in ranks] if "bypass" in ranks[0]
            else None,
            "step_s_note": GLOO_NOTE, **group.note()}))
    print(json.dumps({"phase_40_s": time.perf_counter() - t0}))
    return launches


def ab_turn(tree: str, other_root: str) -> None:
    """One turn of ``--ab``, in a process of its own: builds the kernels of
    the ``tpusched_torch`` on PYTHONPATH, then prints one JSON line of
    their times (ms per launch, :func:`cuda_ms`) at bf16, causal, in this
    order: K1 at the serving shape (1, 1024, 16, 4, 128), K3 at the
    training shape (1, 4096, 16, 4, 128) before K2 was ever launched, K2,
    K3 again, K1 at the training shape, K1 at the serving shape again; K1
    at the serving shape inside a CUDA graph (:func:`graph_launch_ms`, the
    device's time without the host's enqueue) first and last. Last, K3
    four times more on the same tensors, through this tree's library and
    then the library of the tree under ``other_root`` (built there if
    missing), in turns: both trees' K3 share one C signature, so this holds
    everything but the library the same."""
    import importlib.util
    import pathlib

    from tpusched_torch import _build, attention
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(3)
    qs, ks, vs = rand_qkv(gen, 1, 1024, 16, 4, 128, torch.bfloat16)
    q, k, v = rand_qkv(gen, 1, 4096, 16, 4, 128, torch.bfloat16)
    out, lse = attention.flash_forward(q, k, v, True)
    do = torch.randn_like(q)
    dd = attention._to_bh((do.float() * out.float()).sum(
        dim=-1, keepdim=True)).contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    runs = {
        "k1_serving": lambda: attention.flash_forward(qs, ks, vs, True),
        "k1_training": lambda: attention.flash_forward(q, k, v, True),
        "k2": lambda: attention._launch_bwd("dkdv", q, k, v, do, lse, dd,
                                            (dk, dv), True),
        "k3": lambda: attention._launch_bwd("dq", q, k, v, do, lse, dd,
                                            (dq,), True),
    }
    readings = [["k1_serving_graph", graph_launch_ms(runs["k1_serving"])]]
    for name in ("k1_serving", "k3", "k2", "k3", "k1_training", "k1_serving"):
        readings.append([name, cuda_ms(runs[name])])
    readings.append(["k1_serving_graph", graph_launch_ms(runs["k1_serving"])])
    spec = importlib.util.spec_from_file_location(
        "_ab_other_build", pathlib.Path(other_root, "tpusched_torch", "_build.py"))
    other_build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other_build)
    for which, build in (("own", _build), ("other", other_build)) * 2:
        attention._build = build          # what _launch_bwd loads K3 from
        readings.append([f"k3_{which}_library", cuda_ms(runs["k3"])])
    attention._build = _build
    print(json.dumps({"tree": tree, "package": attention.__file__,
                      "build_s": build_s, "readings": readings}))


def ab(other: str) -> None:
    """``--ab DIR``: the flash kernels of the ``tpusched_torch`` under DIR
    (for example ``git archive <commit> tpusched_torch`` unpacked there)
    and of this checkout, timed in turns on one card: DIR, this, this, DIR,
    each turn an :func:`ab_turn` in a fresh process that builds its tree's
    kernels under that tree's ``build/``. Two versions are compared only
    inside one such call."""
    import os
    import pathlib
    roots = {"other": pathlib.Path(other).resolve(),
             "this": pathlib.Path(__file__).resolve().parent}
    check((roots["other"] / "tpusched_torch").is_dir(),
          f"no tpusched_torch under {other}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.splitlines()[0])
    for tree, across in (("other", "this"), ("this", "other"),
                         ("this", "other"), ("other", "this")):
        env = {**os.environ, "PYTHONPATH": str(roots[tree])}
        # this file by path, with -P: only PYTHONPATH names the package
        subprocess.run([sys.executable, "-P", __file__, "--ab-turn", tree,
                        str(roots[across])], env=env, check=True, timeout=600)


def main(argv) -> int:
    sys.stdout.reconfigure(line_buffering=True)   # a cut run keeps its lines
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    if len(argv) == 2 and argv[0] == "--ab":
        ab(argv[1])
        return 0
    if len(argv) == 3 and argv[0] == "--ab-turn":
        ab_turn(argv[1], argv[2])
        return 0
    if argv:
        print(__doc__, file=sys.stderr)
        return 2
    from tpusched_torch import (_build, attention, bench, budget,
                                checkpoint, data, decode, entry, measure,
                                optim, serve, spec_decode, workload)
    # whole lines from every thread: the rank groups' threads print too
    sys.stdout = LockedLines(sys.stdout)

    t_script = time.perf_counter()
    smi = phase_environment(_build)
    max_abs_err = phase_kernel_vs_plain(attention)
    bwd_err, xl_bwd_err = phase_backward_vs_plain(attention)
    decode_timing = phase_decode_attention(attention, decode)
    t_start = time.perf_counter()
    mono = phase_serving(attention, serve, workload)
    phase_parity(attention, decode, serve, workload)
    phase_grad_parity(attention, workload)
    train = phase_training(attention, measure, optim, workload)
    train_launches = train["launches"]
    serving_timing = phase_timing(attention)
    timing = phase_training_timing(attention)
    # the MoE family, after the kernel timings so that those run as before
    moe_mono = phase_serving(attention, serve, workload, "mixtral_like")
    phase_parity(attention, decode, serve, workload, "naive", n_experts=4)
    phase_parity(attention, decode, serve, workload, "flash", n_experts=4)
    moe_train = phase_moe_training(measure, workload)
    exact_decode = phase_moe_decode(measure, workload)
    # int8 KV, chunked prefill, prefix caching and the SLO harness, then
    # the profiler traces, after every earlier phase so that those run as
    # before
    t_new = time.perf_counter()
    chunked = phase_chunked_serving(attention, serve, workload, mono)
    slo_launches, slo_streams = phase_slo(attention, serve, workload)
    prefix_launches = slo_launches["prefix"]
    int8_launches, int8_peak = phase_int8_serving(
        attention, serve, workload, mono, exact_decode, measure)
    phase_parity(attention, decode, serve, workload, "flash",
                 chunk_prefill=5)
    phase_parity(attention, decode, serve, workload, "flash",
                 chunk_prefill=5, prefix_len=12)
    phase_parity(attention, decode, serve, workload, "flash",
                 kv_cache_dtype="int8")
    phase_parity(attention, decode, serve, workload, "flash", n_experts=4,
                 chunk_prefill=5)
    phase_trace(decode, workload)
    t_spec = time.perf_counter()
    t_12_16 = t_spec - t_new
    # speculative decoding and request-keyed sampling, after every earlier
    # phase so that those run as before
    spec_solo = phase_spec_solo(attention, decode, spec_decode, workload)
    spec_serving = phase_spec_serving(attention, decode, serve, workload,
                                      mono)
    phase_spec_parity(attention, decode, serve, spec_decode, workload)
    print(json.dumps({"phases_s": time.perf_counter() - t_start,
                      "phases_12_16_s": t_12_16,
                      "phases_17_19_s": time.perf_counter() - t_spec}))
    # phases 20-34, 39 and 40, after every earlier phase so that those run
    # as before. First, alone on the card, the work whose numbers a check
    # or a table reads: the kernels timed at the ranks' and the ring's
    # shapes (phase 7's way), the one-process references of phases 23, 24,
    # 26 and 27, phases 29 and 30's one-process card work and phase 31's
    # calibrate; then every phase's rank groups side by side
    t_gloo = time.perf_counter()
    tp_timing = {"serving_tp2": phase_timing(attention, (1, 1024, 8, 2, 128)),
                 "serving_tp4": phase_timing(attention, (1, 1024, 4, 1, 128))}
    rank_train = phase_training_timing(attention, (1, 4096, 8, 2, 128),
                                       "per-rank training shape at tp 2")
    pair_err = ring_pair_backward(attention)
    ring_timing = phase_training_timing(
        attention, RING_CHUNK, "ring shape, non-causal pairs", causal=False)
    ring_timing["flash_bwd_dq"]["max_abs_err"] = pair_err[0]
    ring_timing["flash_bwd_dkdv"]["max_abs_err"] = pair_err[1]
    ring_refs = ring_plain(attention)
    sp_ref = sp_big_steps(attention, optim, workload, sp_big_cfg(workload))
    torch.cuda.empty_cache()
    ep_ref = ep_steps(attention, workload)
    torch.cuda.empty_cache()
    pp_whole = pp_whole_loss(workload)
    trained, ckpt_per_step, ckpt_s = checkpoint_alone(
        attention, checkpoint, data, optim, workload, train)
    handoff = handoff_alone(attention, checkpoint, measure, serve, workload,
                            trained)
    del trained
    torch.cuda.empty_cache()
    calib_s = phase_calibrate(measure)
    alone_s = time.perf_counter() - t_gloo
    workdir = pathlib.Path(__file__).resolve().parent / "build"
    zero_counts(attention)
    results = {}
    phases = {
        "20-22": phase_tp(attention, decode, serve, workload, mono, moe_mono,
                          train),
        "23": phase_ring(attention, pair_err, ring_refs),
        "24": phase_fsdp_sp(workload, train, sp_ref),
        "25": phase_dryrun(workload),
        "26": phase_ep(decode, serve, workload, moe_mono, moe_train, ep_ref),
        "27": phase_pp(workload, train, pp_whole),
        "28": phase_dryrun_ep_pp(workload),
        "29": phase_checkpoint(workload, ckpt_s),
        "30": phase_handoff(decode, workload, handoff),
        "32": phase_fsdp_serving(checkpoint, decode, serve, workload, mono),
        "33": phase_pp_fsdp(workload, results),
        "34": phase_entry(entry, workload, workdir),
        "39": phase_mesh_programs(workload, lambda: mesh_refs(results)),
        "40": phase_mesh_train_programs()}
    groups_line = run_side_by_side(phases, results)
    del handoff
    tp = results["20-22"]
    phase_budget(budget, workload, mono, train, int8_peak, tp, calib_s)
    print(json.dumps(groups_line))
    print(json.dumps({"phases_20_34_s": time.perf_counter() - t_gloo,
                      "alone_s": alone_s,
                      "side_by_side_s": groups_line["section_s"],
                      "note": "phases 20-34, 39 and 40: the card work timed "
                              "alone, then the rank groups side by side"}))
    # the compiled programs, after every earlier phase so that those run as
    # before
    t_programs = time.perf_counter()
    zero_counts(attention)
    programs = phase_programs(attention, decode, serve, workload, mono,
                              exact_decode)
    streams = programs["streams"]
    # the chunk, prefix and sampled-round programs, after every earlier
    # phase so that those run as before
    zero_counts(attention)
    later = phase_chunk_prefix_sampled(attention, decode, serve, spec_decode,
                                       workload, mono, chunked, slo_streams)
    # the train steps, sampled sample and the keyed tick as programs,
    # after every earlier phase so that those run as before
    zero_counts(attention)
    train_programs = phase_train_programs(attention, decode, optim, serve,
                                          workload, mono)
    # the runner's lines and the xl gate, after every earlier phase so
    # that those run as before
    zero_counts(attention)
    runner = phase_runner(attention, bench, budget, smi)
    mesh_graphed = results["39"]
    xl_timing = runner["timing"]
    xl_timing["flash_bwd_dq"]["max_abs_err"] = xl_bwd_err[0]
    xl_timing["flash_bwd_dkdv"]["max_abs_err"] = xl_bwd_err[1]
    xl = {name: {"xl_shape": {
        "shape": list(XL_SHAPE), "causal": True,
        "launches": {"gate_per_step": runner["launches"][j]
                     // runner["steps"],
                     "gate_steps": runner["steps"]}, **xl_timing[name]}}
        for j, name in enumerate(("flash_fwd", "flash_bwd_dkdv",
                                  "flash_bwd_dq"))}
    graphed_launches = {
        "prefix_registration_replay": later["full_width"][
            "prefix_registration_launches"],
        "chunked_replays": 0,
        "slo_replays": slo_launches,
        "slo_eager_bodies": later["streams"]["slo_bodies_flash_launches"],
        "serving_replays": streams["graphed"]["flash_launches"],
        "serving_eager_bodies": streams["eager bodies"]["flash_launches"],
        "prefills": streams["graphed"]["prefills"],
        "speculative_replays": programs["speculative"]["graphed"][
            "flash_launches"]}
    dryrun, pp_fsdp = results["34"], results["33"]
    fsdp_serving, handoff_launches = results["32"], results["30"]
    ring_launches, pp_step, pp_tiny = (results["24"], results["27"]["per"],
                                       results["28"])
    dryrun_launches = [{"dense_per_rank_by_sp_index": {
        i: c[j] for i, c in sorted(dryrun.items())}} for j in range(3)]
    mesh_train = [{name: {k: {i: c[j] for i, c in by.items()}
                          if isinstance(by, dict) else [c[j] for c in by]
                          for k, by in v.items()}
                   for name, v in results["40"].items()} for j in range(3)]
    pp_fsdp_launches = {"llama_like_big_per_stage_per_step": pp_fsdp}
    ckpt = {name: {"ckpt_launches": {"per_step": ckpt_per_step[j],
                                     "steps": 6}}
            for j, name in enumerate(("flash_fwd", "flash_bwd_dkdv",
                                      "flash_bwd_dq"))}
    pp_launches = {"llama_like_big_per_stage_per_step": pp_step,
                   "tiny_flash_per_stage_per_step": pp_tiny}
    ring = {name: {"ring_launches": {"per_step_by_sp_index": {
        i: c[j] for i, c in sorted(ring_launches.items())}},
        "ring_shape": {"shape": list(RING_CHUNK), "causal": False,
                       **ring_timing[name]}}
        for j, name in enumerate(("flash_fwd", "flash_bwd_dkdv",
                                  "flash_bwd_dq"))}
    two, four = tp["two"][0], tp["four"][0]
    tp_fwd = {"serving_tp2_per_rank": two["llama_like_big"]["launches"],
              "serving_tp4_per_rank": four["llama_like_big"]["launches"],
              "mixtral_tp2_per_rank": two["mixtral_like"]["launches"],
              "tiny_tp2_per_rank": {m: r["flash_launches"]
                                    for m, r in two["tiny"].items()},
              "training_tp2_per_rank": two["train"]["launches"][0]}
    def graphed_train(j):         # phase 37: through the captured steps
        return {"adamw_per_step": train_programs["adamw_per_step"][j],
                "accum_per_step": train_programs["accum_per_step"][j]}

    print(json.dumps({"phases_35_38_s": time.perf_counter() - t_programs,
                      "script_s": time.perf_counter() - t_script}))
    source = "tpusched_torch/csrc/"
    replaces = "tpusched/jaxbridge/attention.py:"
    # flash_fwd's own fields are the serving path's, at its (1, 1024, 16, 4,
    # 128) shape, as in the first slice; "training_shape" holds the training
    # path's launches, error and times at (1, 4096, 16, 4, 128).
    print(json.dumps({"kernels": [
        {"name": "flash_fwd", "route": "cuda", "source": source + "flash_fwd.cu",
         "replaces": replaces + "91", "launches": mono["launches"],
         "max_abs_err": max_abs_err, **serving_timing,
         "prefix_launches": prefix_launches,
         "int8_prefill_launches": int8_launches,
         "spec_launches": {"solo": spec_solo, "serving": spec_serving},
         "training_shape": {"launches": train_launches[0],
                            **timing["flash_fwd"]},
         "tp_launches": tp_fwd,
         "tp_shapes": {**tp_timing,
                       "training_tp2": rank_train["flash_fwd"]},
         **ring["flash_fwd"], "pp_launches": pp_launches,
         **ckpt["flash_fwd"], "handoff_launches": handoff_launches,
         "fsdp_serving_launches": fsdp_serving,
         "pp_fsdp_launches": pp_fsdp_launches,
         "dryrun_launches": dryrun_launches[0],
         "graphed_launches": graphed_launches,
         "graphed_train_launches": graphed_train(0),
         "mesh_graphed_launches": mesh_graphed,
         "mesh_graphed_train_launches": mesh_train[0], **xl["flash_fwd"]},
        {"name": "decode_attn", "route": "cuda",
         "source": source + "decode_attn.cu",
         "replaces": "no Pallas kernel: the einsums of "
                     "tpusched/jaxbridge/decode.py:83-102",
         "serving_launches": {"decode_attn_launches": mono[
             "decode_launches"], "decode_ticks": mono["decode_ticks"]},
         **decode_timing},
        {"name": "flash_bwd_dkdv", "route": "cuda",
         "source": source + "flash_bwd.cu", "replaces": replaces + "218",
         "launches": train_launches[1], "max_abs_err": bwd_err[1],
         **timing["flash_bwd_dkdv"],
         "tp_launches": {"training_tp2_per_rank": two["train"]["launches"][1]},
         "tp_shapes": {"training_tp2": rank_train["flash_bwd_dkdv"]},
         **ring["flash_bwd_dkdv"], "pp_launches": pp_launches,
         **ckpt["flash_bwd_dkdv"], "pp_fsdp_launches": pp_fsdp_launches,
         "dryrun_launches": dryrun_launches[1],
         "graphed_train_launches": graphed_train(1),
         "mesh_graphed_train_launches": mesh_train[1],
         **xl["flash_bwd_dkdv"]},
        {"name": "flash_bwd_dq", "route": "cuda",
         "source": source + "flash_bwd.cu", "replaces": replaces + "265",
         "launches": train_launches[2], "max_abs_err": bwd_err[0],
         **timing["flash_bwd_dq"],
         "tp_launches": {"training_tp2_per_rank": two["train"]["launches"][2]},
         "tp_shapes": {"training_tp2": rank_train["flash_bwd_dq"]},
         **ring["flash_bwd_dq"], "pp_launches": pp_launches,
         **ckpt["flash_bwd_dq"], "pp_fsdp_launches": pp_fsdp_launches,
         "dryrun_launches": dryrun_launches[2],
         "graphed_train_launches": graphed_train(2),
         "mesh_graphed_train_launches": mesh_train[2],
         **xl["flash_bwd_dq"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
