"""K4, single-token attention over the serving arena, on the CPU.

The kernel (``csrc/decode_attn.cu``) runs only on the card, where
``chip_smoke.py`` holds it against its plain version. Here the plain
version, the kernel's chunked arithmetic written in PyTorch, is held
against the decode step's einsum (``decode._einsum_attention``, the path
every other caller keeps), and the routing, the launch counter and the C
signature are checked without a card."""
from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import pytest
import torch

from tpusched_torch import _build, attention, decode, program, tracing
from tpusched_torch.workload import ModelConfig, init_params

torch.set_num_threads(1)

MAX_SEQ = 200        # four 64-row chunks, the last ragged
CHUNK = 64


def _arena(seed, b, kv, n_rep, hd, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, 1, kv * n_rep, hd))
    ck = rng.standard_normal((b, MAX_SEQ, kv, hd))
    cv = rng.standard_normal((b, MAX_SEQ, kv, hd))
    return tuple(torch.from_numpy(x).to(dtype) for x in (q, ck, cv))


# cursors of the (b,) form: the first row only, the arena's last row, an
# idle slot parked past the arena, one row short of a chunk, a chunk
# exactly, lengths that are no multiple of the chunk
CURSORS = [0, MAX_SEQ - 1, MAX_SEQ + 37, CHUNK - 1, CHUNK, 130, 77]


def _pos(form):
    if form == "vector":
        return torch.tensor(CURSORS)
    if form == "0-d":
        return torch.tensor(130)
    return 131                                        # a Python int


@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("kv,n_rep", [(1, 1), (1, 4), (2, 1), (2, 4), (8, 1),
                                      (8, 4)])
@pytest.mark.parametrize("form", ["vector", "0-d", "int"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_matches_the_einsum(dtype, form, kv, n_rep, hd):
    """The chunked plain version against the einsum over the whole cache:
    in f32 to rounding; in bf16 both against the einsum in f32 on the same
    bf16 inputs, the plain version's worst error at most 1.25× the einsum's
    (which rounds the logits to bf16) plus a bf16 half-ulp of the output."""
    b = len(CURSORS)
    q, ck, cv = _arena(kv * 10 + n_rep, b, kv, n_rep, hd, dtype)
    pos = _pos(form)
    got = attention.decode_attention_plain(q, ck, cv, pos, n_rep, CHUNK)
    assert got.shape == q.shape and got.dtype == dtype
    if dtype == torch.float32:
        want = decode._einsum_attention(q, ck, cv, pos, n_rep)
        torch.testing.assert_close(got, want, atol=2e-6, rtol=2e-5)
        # the default chunk is the policy's, here one 64-row step
        torch.testing.assert_close(
            attention.decode_attention_plain(q, ck, cv, pos, n_rep), got,
            atol=2e-6, rtol=2e-5)
        return
    ref = decode._einsum_attention(q.float(), ck.float(), cv.float(), pos,
                                   n_rep)
    einsum = decode._einsum_attention(q, ck, cv, pos, n_rep)
    err = (got.float() - ref).abs().max().item()
    err_einsum = (einsum.float() - ref).abs().max().item()
    assert err <= 1.25 * err_einsum + 2.0 ** -9 * ref.abs().max().item()
    torch.testing.assert_close(got.float(), ref, atol=2e-2, rtol=2e-2)


def test_plain_reads_nothing_past_the_cursor():
    """Rows past a slot's cursor do not reach its output, however large:
    the arena beyond them filled with 1e30 changes nothing."""
    q, ck, cv = _arena(3, len(CURSORS), 2, 4, 128, torch.float32)
    pos = torch.tensor(CURSORS)
    want = attention.decode_attention_plain(q, ck, cv, pos, 4, CHUNK)
    rows = torch.arange(MAX_SEQ)
    dead = rows[None, :] > pos.clamp(max=MAX_SEQ - 1)[:, None]
    ck2, cv2 = ck.clone(), cv.clone()
    ck2[dead], cv2[dead] = 1e30, 1e30
    got = attention.decode_attention_plain(q, ck2, cv2, pos, 4, CHUNK)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


@pytest.mark.parametrize("device,s_q,dtype,hd,takes", [
    ("cuda", 1, torch.bfloat16, 128, True),
    ("cuda", 1, torch.float16, 128, True),
    ("cpu", 1, torch.bfloat16, 128, False),
    ("meta", 1, torch.bfloat16, 128, False),
    ("cuda", 2, torch.bfloat16, 128, False),
    ("cuda", 5, torch.bfloat16, 128, False),
    ("cuda", 1, torch.float32, 128, False),
    ("cuda", 1, torch.int8, 128, False),
    ("cuda", 1, torch.bfloat16, 64, False),
    ("cuda", 1, torch.bfloat16, 32, False),
    ("cuda", 1, torch.bfloat16, 256, False),
], ids=["bf16", "fp16", "cpu", "meta", "s_q2", "s_q5", "f32", "int8", "hd64",
        "hd32", "hd256"])
def test_routing_predicate(device, s_q, dtype, hd, takes):
    assert attention.decode_kernel_takes(torch.device(device), s_q, dtype,
                                         hd) is takes


def test_cached_attention_routes_by_the_predicate(monkeypatch):
    """Where the predicate says so, the decode step's attention goes to
    ``attention.decode_attention`` (on the CPU its plain version), with the
    step's cursor; elsewhere to the einsum. The predicate is asked with
    q's device, s_q, the cache's dtype and the head dim."""
    q, ck, cv = _arena(4, len(CURSORS), 2, 4, 128, torch.bfloat16)
    pos = torch.tensor(CURSORS)
    asked, routed = [], []
    real = attention.decode_attention
    monkeypatch.setattr(attention, "decode_kernel_takes",
                        lambda *a: asked.append(a) or True)
    monkeypatch.setattr(attention, "decode_attention",
                        lambda *a: routed.append(a[3]) or real(*a))
    got = decode._cached_attention(q, ck, cv, pos, 4)
    assert asked == [(q.device, 1, torch.bfloat16, 128)]
    assert len(routed) == 1 and routed[0] is pos
    torch.testing.assert_close(
        got, attention.decode_attention_plain(q, ck, cv, pos, 4), atol=0,
        rtol=0)
    monkeypatch.setattr(attention, "decode_kernel_takes", lambda *a: False)
    got = decode._cached_attention(q, ck, cv, pos, 4)
    assert len(routed) == 1
    torch.testing.assert_close(
        got, decode._einsum_attention(q, ck, cv, pos, 4), atol=0, rtol=0)


def test_decode_step_asks_one_token_and_spans_more(monkeypatch):
    """Through a model: ``decode_step`` asks the predicate with s_q 1 a
    layer, ``score_span`` (the chunk program's and the verify span's path)
    with its span; on the CPU both stay on the einsum."""
    cfg = ModelConfig.tiny()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    cache = decode.init_kv_cache(cfg, 2, 32, "cpu")
    asked = []
    real = attention.decode_kernel_takes
    monkeypatch.setattr(attention, "decode_kernel_takes",
                        lambda *a: asked.append(a[1]) or real(*a))
    launches = attention.DECODE_ATTN_LAUNCHES
    decode.decode_step(params, cache, torch.tensor([1, 2]),
                       torch.tensor([3, 5]), cfg)
    decode.score_span(params, cache, torch.tensor([[1, 2, 3]] * 2), 6, cfg)
    assert asked == [1] * cfg.n_layers + [3] * cfg.n_layers
    assert attention.DECODE_ATTN_LAUNCHES == launches


def test_launch_counter_is_registered(monkeypatch):
    """Program replays add the launches their capture recorded of every
    counter in ``program._COUNTERS``; ``tracing.counters()`` reports K4's."""
    assert "DECODE_ATTN_LAUNCHES" in program._COUNTERS
    monkeypatch.setattr(attention, "DECODE_ATTN_LAUNCHES", 64)
    assert tracing.counters()["decode_attn_launches"] == 64
    assert program._counts()[program._COUNTERS.index(
        "DECODE_ATTN_LAUNCHES")] == 64


class _FakeLib:
    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        def entry(*args):
            self.calls.setdefault(name, []).append(args)
            return 0
        return entry


@pytest.fixture
def fake_lib(monkeypatch):
    """K4's entry point's arguments, recorded instead of launched."""
    calls = {}
    monkeypatch.setattr(_build, "load", lambda name: _FakeLib(calls))
    monkeypatch.setattr(attention, "_stream",
                        lambda device: ctypes.c_void_p(0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(attention, "DECODE_ATTN_LAUNCHES", 0)
    return calls


@pytest.mark.parametrize("form", ["vector", "0-d", "int"])
def test_wrapper_passes_what_the_c_signature_declares(form, fake_lib):
    """The launch hands ``tpusched_decode_attn`` exactly the arguments
    ``_build.SIGNATURES`` declares, each convertible to its C type: the
    arena's own pointer and strides (no copy), the chunk of
    ``decode_chunk``, one cursor or one a slot; and counts two launches."""
    b, kv, n_rep, hd = 64, 8, 4, 128
    ck = torch.zeros((b, 4096, kv, hd), dtype=torch.bfloat16)
    cv = torch.zeros_like(ck)
    q = torch.zeros((b, 1, kv * n_rep, hd), dtype=torch.bfloat16)
    pos = {"vector": torch.arange(b), "0-d": torch.tensor(7), "int": 7}[form]
    out = attention._decode_attention_cuda(q, ck, cv, pos, n_rep)
    assert out.shape == q.shape and out.dtype == q.dtype
    assert set(fake_lib) == set(_build.SIGNATURES["decode_attn"])
    (args,) = fake_lib["tpusched_decode_attn"]
    argtypes, _ = _build.SIGNATURES["decode_attn"]["tpusched_decode_attn"]
    assert len(args) == len(argtypes)
    for argtype, arg in zip(argtypes, args):
        argtype.from_param(arg)
    assert args[1:3] == (ck.data_ptr(), cv.data_ptr())
    assert args[7:14] == (b, 4096, kv * n_rep, kv, hd,
                          attention.decode_chunk(b, 4096, kv, n_rep),
                          int(form == "vector"))
    assert args[14:22] == (q.stride(0), q.stride(2), *ck.stride()[:3],
                           *cv.stride()[:3])
    assert attention.DECODE_ATTN_LAUNCHES == 2


@pytest.mark.parametrize("what", ["f32", "hd64", "s_q2", "unaligned",
                                  "heads", "pos"])
def test_wrapper_refuses_what_the_kernel_does_not_take(what, fake_lib):
    b, kv, n_rep, hd, dtype, s_q = 4, 2, 4, 128, torch.bfloat16, 1
    if what == "f32":
        dtype = torch.float32
    if what == "hd64":
        hd = 64
    if what == "s_q2":
        s_q = 2
    q = torch.zeros((b, s_q, kv * n_rep, hd), dtype=dtype)
    ck = torch.zeros((b, 256, kv, hd + (4 if what == "unaligned" else 0)),
                     dtype=dtype)[..., :hd]
    cv = torch.zeros((b, 256, kv, hd), dtype=dtype)
    pos = torch.zeros(3 if what == "pos" else b, dtype=torch.long)
    with pytest.raises(ValueError):
        attention._decode_attention_cuda(q, ck, cv, pos,
                                         n_rep + (what == "heads"))
    assert not fake_lib and attention.DECODE_ATTN_LAUNCHES == 0


@pytest.mark.parametrize("b,max_seq,kv,n_rep,chunk,cell", [
    (64, 4096, 8, 4, 512, True),      # mistral-7b's arena
    (48, 4096, 8, 4, 512, True),      # mixtral-8x7b's
    (64, 4096, 4, 4, 256, False),     # a tp-2 rank's
    (64, 4096, 2, 4, 128, False),     # a tp-4 rank's
    (1, 2048, 8, 4, 64, False),       # generate
    (128, 4096, 8, 8, 1024, False),   # a group of 8
    (64, 4096, 8, 1, 512, False),
])
def test_decode_chunk(b, max_seq, kv, n_rep, chunk, cell):
    """The chunk: whole 64-row steps, halved from its start only while a
    full arena gives fewer blocks than ``_DECODE_MIN_BLOCKS``; at the
    cells' arenas its f32 partials (written and read back) stay under 2%
    of its K/V bytes."""
    got = attention.decode_chunk(b, max_seq, kv, n_rep)
    assert got == chunk and got % attention.DECODE_STEP == 0
    if got < 128 * max(n_rep, 4):
        assert b * kv * -(-max_seq // (2 * got)) < attention._DECODE_MIN_BLOCKS
    if cell:
        assert 2 * n_rep * 4 / (got * 2 * 2) < 0.02
