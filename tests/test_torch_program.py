"""tpusched_torch.program and the programs built on it, on the CPU.

A program's body must run with its cursors on the device and read nothing
back to the host, or a CUDA graph could not hold it: each body runs here
on the ``meta`` device, where any host read raises. The decode path with
tensor cursors, 0-d or (b,), must equal its int-cursor path bitwise and
jaxbridge's within 1e-5 relative (f32; dense, 4-expert dropless and int8
caches); the engine's programs keep their buffers and the arena in place;
greedy ``generate``, one step program replayed a token, gives jaxbridge's
tokens exactly."""
from __future__ import annotations

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusched.jaxbridge import decode as jdec, workload as jwl
from tpusched_torch import decode, interop, optim, serve, spec_decode
from tpusched_torch import workload as wl
from tpusched_torch.program import Program
from tpusched_torch.serve import Request, ServeEngine

torch.set_num_threads(1)

KINDS = {"dense": {}, "moe": {"n_experts": 4},
         "int8": {"kv_cache_dtype": "int8"}}
B, S0, MAX_SEQ, K = 3, 8, 20, 3


@functools.lru_cache(maxsize=None)
def _pair(kind, seed=0):
    jcfg = dataclasses.replace(jwl.ModelConfig.tiny(), n_kv_heads=1,
                               **KINDS[kind])
    cfg = dataclasses.replace(wl.ModelConfig.tiny(), n_kv_heads=1,
                              **KINDS[kind])
    jp = jwl.init_params(jax.random.PRNGKey(seed), jcfg)
    p = interop.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    return jcfg, jp, cfg, p


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.int32)


def _close(got, ref, rel=1e-5):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-6))


def _clone(cache):
    return [{n: t.clone() for n, t in c.items()} for c in cache]


def _prefilled(kind):
    jcfg, jp, cfg, p = _pair(kind)
    prompt = _tokens(1, (B, S0))
    _, jc = jdec.prefill(jp, jdec.init_kv_cache(jcfg, B, MAX_SEQ),
                         jnp.asarray(prompt), jcfg)
    _, pc = decode.prefill(p, decode.init_kv_cache(cfg, B, MAX_SEQ, "cpu"),
                           torch.from_numpy(prompt).long(), cfg)
    return jc, pc


def _run(fn, p, cache, pos, cfg):
    """The port's ``fn`` from the prefilled state at cursor ``pos``."""
    if fn == "decode_step":
        return decode.decode_step(p, cache, torch.from_numpy(
            _tokens(2, (B,))).long(), pos, cfg)
    if fn == "score_span":
        return decode.score_span(p, cache, torch.from_numpy(
            _tokens(3, (B, 3))).long(), pos, cfg)
    return decode.draft_rollout(p, cache, torch.from_numpy(
        _tokens(4, (B, 2))).long(), pos, cfg, K)


def _run_ref(fn, jp, cache, pos, jcfg):
    if fn == "decode_step":
        return jdec.decode_step(jp, cache, jnp.asarray(_tokens(2, (B,))),
                                pos, jcfg)
    if fn == "score_span":
        return jdec.score_span(jp, cache, jnp.asarray(_tokens(3, (B, 3))),
                               pos, jcfg)
    return jdec.draft_rollout(jp, cache, jnp.asarray(_tokens(4, (B, 2))),
                              pos, jcfg, K)


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("fn", ["decode_step", "score_span",
                                "draft_rollout"])
def test_device_cursors_equal_int_cursor_and_reference(fn, kind):
    """One step from a prefilled cache at row 8: a 0-d and a (b,) tensor
    cursor give the int cursor's outputs and cache bitwise; per-row
    cursors (8, 5, 7) and the aligned one match jaxbridge's within 1e-5."""
    jcfg, jp, cfg, p = _pair(kind)
    jc, pc = _prefilled(kind)
    out_int, cache_int = _run(fn, p, _clone(pc), S0, cfg)
    for pos in (torch.tensor(S0), torch.full((B,), S0)):
        out, cache = _run(fn, p, _clone(pc), pos, cfg)
        assert torch.equal(out, out_int)
        for layer, want in zip(cache, cache_int):
            for name in want:
                assert torch.equal(layer[name], want[name])
    rows = np.array([8, 5, 7], np.int32)
    for pos, ref_pos in ((S0, S0), (torch.from_numpy(rows).long(), rows)):
        out, cache = _run(fn, p, _clone(pc), pos, cfg)
        ref, ref_cache = _run_ref(fn, jp, jc, jnp.asarray(ref_pos), jcfg)
        if fn == "draft_rollout":
            np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        else:
            _close(out.numpy(), ref)
        for layer, want in zip(cache, ref_cache):
            for name in want:
                _close(layer[name].float().numpy(), want[name])


def _meta_program(name, kind):
    """The program ``name`` over tiny weights, an arena and buffers all on
    the meta device (the slot prefill and the prefix's K/V through their
    plain attention; solo speculation's programs over a batch-1 cache)."""
    cfg = dataclasses.replace(_pair(kind)[2], attn="naive")
    params = wl.tree_map(lambda t: t.to("meta"), _pair(kind)[3])
    cache = decode.init_kv_cache(cfg, B, MAX_SEQ, "meta")
    program = functools.partial(Program, graphed=False)
    axes = (None, None, None)
    sampling = (0.8, 24, 0.9)
    if name == "prefill_chunk":
        return serve._build_prefill_chunk(params, cache, cfg, 4, axes,
                                          program), (cfg.vocab,)
    if name == "prefix_kv":
        return serve._build_prefix_kv(params, cfg, S0, "meta", axes,
                                      program), (
            cfg.n_layers, 2, 1, S0, cfg.kv_heads, cfg.head_dim)
    if name == "prefix_insert":
        kv = decode.init_kv_cache(dataclasses.replace(
            cfg, kv_cache_dtype=None), 1, S0, "meta")
        return serve._build_prefix_insert(cache, kv, program), None
    if name in ("draft_ingest", "draft_step"):
        width = 2 if name == "draft_ingest" else 1
        return decode._adjusted_span_program(
            params, cache, cfg, (B, width), sampling, program,
            axes), (B, cfg.vocab)
    if name == "verify_sampled":
        return decode._adjusted_span_program(
            params, cache, cfg, (B, K + 1), sampling, program, axes,
            last=False), (B, K + 1, cfg.vocab)
    solo = decode.init_kv_cache(cfg, 1, MAX_SEQ, "meta")
    if name == "solo_draft":
        return spec_decode._greedy_draft_program(params, solo, cfg, 2, K,
                                                 program), (1, K)
    if name == "solo_span":
        return spec_decode._greedy_span_program(params, solo, cfg, K,
                                                program), (1, K + 1)
    if name == "decode_tick":
        return serve._build_decode_tick(params, cache, cfg, B, axes,
                                        program), (B, cfg.vocab)
    if name == "keyed_tick":
        return serve._build_decode_tick(params, cache, cfg, B, axes,
                                        program, keyed=sampling), (B,)
    if name in TRAIN_BODIES:
        return _meta_train_program(name, cfg, params)
    if name == "prefill_slot":
        return serve._build_prefill_slot(params, cache, cfg, S0, axes,
                                         program), (cfg.vocab,)
    if name == "draft_tick":
        return serve._build_draft_tick(params, cache, cfg, B, K, axes,
                                       program), (B, K)
    if name == "verify_span":
        return serve._build_verify_span(params, cache, cfg, B, K, axes,
                                        program), (B, K + 1)
    meta = dict(dtype=torch.long, device="meta")
    out = torch.zeros((B, 5), **meta)
    if name == "sampled_step":
        return decode._sampled_step(
            params, cache, torch.zeros(B, **meta), torch.zeros((), **meta),
            out, S0, cfg, torch.Generator(), sampling, graphed=False), None
    return decode._greedy_step(params, cache, torch.zeros(B, **meta),
                               torch.zeros((), **meta), out, S0,
                               cfg), None


TRAIN_BODIES = ("sgd_step", "adamw_step", "accum_micro", "accum_update")


def _meta_train_program(name, cfg, params):
    """A single-card train step's program over meta weights, optimizer
    state and tokens (naive attention; the MoE kind through the capacity
    path), the tree set as a step's call sets it for its bodies."""
    tokens = torch.zeros((B, S0), dtype=torch.long, device="meta")
    ts = wl.TrainShardings(None, cfg)
    b = types.SimpleNamespace(params=params, state=None)
    if name == "sgd_step":
        return wl._sgd_program(b, ts, tokens, 1e-2, graphed=False), ()
    tx = optim.adamw(1e-3, mu_dtype=torch.float32)
    b.state = tx.init(params)
    if name == "adamw_step":
        return wl._adamw_program(b, ts, tx, tokens, graphed=False)[0], ()
    micro, update, _ = wl._accum_programs(b, ts, tx, tokens, 4,
                                          graphed=False)
    return (micro, None) if name == "accum_micro" else (update, ())


def _meta_exponential(exponential_):
    """``Tensor.exponential_`` without its generator: the meta device has
    no generator to draw from (it draws nothing)."""
    def draw(self, lambd=1.0, *, generator=None):
        return exponential_(self, lambd)
    return draw


def _refused(fn):
    def refuse(*args, **kwargs):
        raise AssertionError(f"torch.{fn} inside a program body")
    return refuse


@pytest.mark.parametrize("kind", list(KINDS))
@pytest.mark.parametrize("name", ["decode_tick", "prefill_slot",
                                  "draft_tick", "verify_span",
                                  "greedy_step", "prefill_chunk",
                                  "prefix_kv", "prefix_insert",
                                  "draft_ingest", "draft_step",
                                  "verify_sampled", "solo_draft",
                                  "solo_span", "keyed_tick", "sampled_step",
                                  *TRAIN_BODIES])
def test_program_bodies_read_nothing_back_to_the_host(name, kind,
                                                      monkeypatch):
    """Every body runs start to finish with weights, arena and inputs on
    the meta device, where ``int()``, ``.item()`` or numpy of a tensor
    raises, and with ``torch.tensor``/``as_tensor``/``from_numpy``
    refused: the step holds no host read and no upload that a CUDA graph
    could not record. No op of these bodies lacks a meta kernel; the
    sampled step's draw runs without its generator there. The train
    bodies take their gradients through autograd, the MoE kind's through
    the capacity path (``F.one_hot`` given its class count)."""
    prog, shape = _meta_program(name, kind)
    assert all(t.device.type == "meta" for t in prog.inputs.values())
    with monkeypatch.context() as m:
        # nor does it make a tensor of a host value: that is an upload,
        # which a capture refuses from pageable memory
        for fn in ("tensor", "as_tensor", "from_numpy"):
            m.setattr(torch, fn, _refused(fn))
        if name == "sampled_step":
            m.setattr(torch.Tensor, "exponential_",
                      _meta_exponential(torch.Tensor.exponential_))
        out = prog.body()
    if shape is None:        # the steps and the insert write in place
        assert out is None
    else:
        assert out.device.type == "meta" and tuple(out.shape) == shape


def test_meta_device_catches_a_host_read():
    """The law the test above rests on: a host read of a meta tensor
    raises."""
    t = torch.zeros((), dtype=torch.long, device="meta")
    for read in (int, bool, lambda x: x.item(), lambda x: x.tolist(),
                 lambda x: x.numpy(), lambda x: x.cpu()):
        with pytest.raises((RuntimeError, NotImplementedError, TypeError)):
            read(t)


def _ptrs(eng):
    held = {key: [t.data_ptr() for t in prog.inputs.values()]
            for key, prog in eng._programs.items()}
    outs = {key: prog.outputs.data_ptr()
            for key, prog in eng._programs.items()
            if prog.outputs is not None}
    arena = [t.data_ptr() for arena in (eng.cache, getattr(
        eng, "draft_cache", [])) for c in arena for t in c.values()]
    return held, outs, arena


ENGINES = {"plain": {}, "draft": {"spec_k": K},
           "chunked": {"chunk_prefill": 5},
           "sampled": {"spec_k": K, "temperature": 0.8, "top_k": 24,
                       "request_keyed": True}}


@pytest.mark.parametrize("kind", list(ENGINES))
def test_programs_keep_buffers_and_arena_in_place(kind):
    """Across 10 ticks (admissions, chunks, decode ticks, greedy or
    sampled rounds) every program keeps its input and output buffers and
    the arena keeps its tensors: inputs are copied in, never rebound.
    ``warmup()`` builds every program of the configuration; the chunked
    engine also registers a prefix, whose K/V program joins them, and
    serves tenants of it."""
    _, _, cfg, p = _pair("dense")
    kw = dict(ENGINES[kind])
    if "spec_k" in kw:
        kw.update(draft_params=p, draft_cfg=cfg)
    eng = ServeEngine(p, cfg, slots=2, max_seq=48, prompt_bucket=(8, 16),
                      device="cpu", **kw)
    eng.warmup()
    assert sorted(eng._programs) == sorted(eng._program_keys())
    rng = np.random.default_rng(5)
    prefix = None
    if kind == "chunked":
        eng.register_prefix("sys", rng.integers(0, cfg.vocab, 6))
        prefix = "sys"
    for i in range(4):
        eng.submit(Request(rid=i, prompt=rng.integers(
            0, cfg.vocab, int(rng.integers(3, 15)), dtype=np.int32),
            max_new_tokens=6, prefix_id=prefix if i % 2 else None))
    held, outs, arena = _ptrs(eng)
    for _ in range(10):
        eng.tick()
        now = _ptrs(eng)
        assert now[0] == held and now[2] == arena
        # a program's outputs exist from its first call on, then stay
        assert {k: now[1][k] for k in outs} == outs
        outs = now[1]


def test_program_copies_inputs_in_and_outputs_out():
    """On the CPU a call copies its values into the buffers, runs the body
    and copies the result into the outputs the first call made: the
    second call's result is its own input's, in the first call's
    tensors."""
    x = torch.zeros(3, dtype=torch.long)
    prog = Program(lambda: x * 2, {"x": x}, graphed=False)
    first = prog(x=np.array([1, 2, 3]))
    assert first.tolist() == [2, 4, 6]
    second = prog(x=torch.tensor([4, 5, 6]))
    assert second is first and second.tolist() == [8, 10, 12]
    assert prog.inputs["x"] is x and x.tolist() == [4, 5, 6]
    with pytest.raises(ValueError, match="shape"):
        prog(x=np.zeros(4))


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_greedy_generate_step_program_equals_reference(kind):
    """``generate`` prefills, then replays its step program once a token,
    the position advanced on the device and each token written into the
    output there: jaxbridge's tokens exactly (tiny f32)."""
    jcfg, jp, cfg, p = _pair(kind, seed=3)
    prompt = _tokens(6, (2, 9))
    ref = np.asarray(jdec.generate(jp, jnp.asarray(prompt), jcfg, steps=7))
    got = decode.generate(p, torch.from_numpy(prompt).long(), cfg, steps=7)
    assert got.dtype == torch.long and got.shape == (2, 8)
    np.testing.assert_array_equal(got.numpy(), ref)
