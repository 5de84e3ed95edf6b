"""tpusched_torch.attention against tpusched.jaxbridge.attention on the CPU.

The same numpy inputs go through the JAX reference (its Pallas flash kernels
in interpret mode, as tests/test_attention.py runs them) and through the
port's CPU path, which is the CUDA kernels' plain versions."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusched.jaxbridge import attention as jattn
from tpusched_torch import attention

torch.set_num_threads(1)


def _qkv(seed, b=2, s=256, h=4, kv=4, d=32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, n, d)).astype(np.float32)
                 for n in (h, kv, kv))


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (4, 1)],
                         ids=["mha", "gqa", "mqa"])
def test_flash_plain_matches_reference_kernel(h, kv, causal):
    """Out and lse of the port's flash forward (plain version on the CPU)
    vs the reference's Pallas forward, multi-block (128 of 256 rows), f32,
    at the reference's own interpret-tier bar."""
    q, k, v = _qkv(0, h=h, kv=kv)
    ref_out, ref_lse = jattn._flash_forward(*_j(q, k, v), causal, 128, 128,
                                            None)
    out, lse = attention.flash_forward(*_t(q, k, v), causal)
    assert out.shape == ref_out.shape and lse.shape == ref_lse.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_naive_matches_reference(h, kv, causal):
    q, k, v = _qkv(1, s=48, h=h, kv=kv)
    ref = np.asarray(jattn.naive_attention(*_j(q, k, v), causal))
    got = attention.naive_attention(*_t(q, k, v), causal).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5, rtol=2e-5)


def test_naive_bf16_masks_without_overflow():
    """f32's min does not fit bf16: the causal mask must still apply, and
    the result match the reference's bf16 path."""
    q, k, v = _qkv(2, s=32, h=4, kv=2)
    ref = np.asarray(jattn.naive_attention(
        *(x.astype(jnp.bfloat16) for x in _j(q, k, v))).astype(jnp.float32))
    got = attention.naive_attention(
        *(x.to(torch.bfloat16) for x in _t(q, k, v))).float().numpy()
    np.testing.assert_allclose(got, ref, atol=2e-2, rtol=2e-2)


def test_flash_plain_matches_naive_on_ragged_length():
    """The plain version takes any length, as the CUDA kernel does (the
    reference falls back to naive where its blocks do not divide)."""
    q, k, v = _t(*_qkv(3, s=100, h=4, kv=2))
    np.testing.assert_allclose(attention.flash_attention(q, k, v).numpy(),
                               attention.naive_attention(q, k, v).numpy(),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("s", [1, 8, 100, 128, 256, 384, 640, 1000, 1280,
                               2048, 4096, 6144])
def test_flash_blocks_match_reference(s):
    for bq, bk in ((512, 2048), (128, 128), (256, 512), (64, 64)):
        assert attention._flash_blocks(s, bq, bk) == \
            jattn._flash_blocks(s, bq, bk)


def test_bh_layout_round_trip():
    x = torch.from_numpy(_qkv(4, s=8, h=3, kv=3)[0])
    bh = attention._to_bh(x)
    assert bh.shape == (2 * 3, 8, 32)
    np.testing.assert_array_equal(bh.numpy(),
                                  np.asarray(jattn._to_bh(jnp.asarray(x))))
    np.testing.assert_array_equal(attention._from_bh(bh, 2, 3).numpy(),
                                  x.numpy())


def test_repeat_kv_matches_reference():
    x = _qkv(5, s=8, h=2, kv=2)[0]
    np.testing.assert_array_equal(
        attention.repeat_kv(torch.from_numpy(x), 3).numpy(),
        np.asarray(jattn.repeat_kv(jnp.asarray(x), 3)))


def test_bad_gqa_group_raises_like_reference():
    q, k, v = _qkv(6, s=16, h=4, kv=3)
    with pytest.raises(ValueError, match="kv heads must divide q heads"):
        attention.flash_attention(*_t(q, k, v))
    with pytest.raises(ValueError, match="kv heads must divide q heads"):
        jattn.flash_attention(*_j(q, k, v))
    q, k, v = _qkv(6, s=16, h=4, kv=2)
    with pytest.raises(ValueError, match="match between k/v"):
        attention.flash_attention(*_t(q, k, v[:, :, :1]))


def test_cpu_path_launches_no_kernel():
    before = attention.FLASH_FWD_LAUNCHES
    attention.flash_attention(*_t(*_qkv(7, s=16)))
    assert attention.FLASH_FWD_LAUNCHES == before


@pytest.mark.parametrize("case,exc,match", [
    ("grad", ValueError, "dO is torch.float16"),
    ("head_dim", ValueError, "head_dim"),
    ("dtype", ValueError, "flash kernel takes"),
    ("mixed", ValueError, "is torch.float16"),
    ("stride", ValueError, "contiguous"),
    ("bf16_row_stride", ValueError, "16-byte"),
    ("bf16_start", ValueError, "16-byte"),
])
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(case, exc,
                                                              match):
    """The CUDA wrapper's checks run before anything touches the card."""
    q, k, v = _t(*_qkv(8, b=1, s=16, h=2, kv=2, d=32))
    if case == "grad":
        # gradients are taken now; the backward wrapper refuses a dO the
        # kernels cannot read
        out, lse = attention.flash_attention_plain(q, k, v)
        with pytest.raises(exc, match=match):
            attention._flash_backward_cuda(q, k, v, out, lse, out.half(),
                                           True, None)
        return
    if case == "head_dim":
        q, k, v = _t(*_qkv(8, b=1, s=16, h=2, kv=2, d=48))
    elif case == "dtype":
        q, k, v = (x.half() for x in (q, k, v))
    elif case == "mixed":
        v = v.half()
    elif case == "bf16_row_stride":
        q, k, v = (x.bfloat16() for x in (q, k, v))
        k = torch.nn.functional.pad(k, (0, 2))[..., :32]
    elif case == "bf16_start":
        q, k, v = (x.bfloat16() for x in (q, k, v))
        v = torch.cat([v.reshape(-1), v.reshape(-1)[:1]])[1:].reshape(v.shape)
    else:
        q = torch.from_numpy(_qkv(8, b=1, s=16, h=2, kv=2, d=64)[0])[..., ::2]
    with pytest.raises(exc, match=match):
        attention._flash_forward_cuda(q, k, v, True)


def test_non_cuda_device_is_refused():
    q, k, v = (x.to("meta") for x in _t(*_qkv(9, b=1, s=8, h=2, kv=2)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        attention.flash_forward(q, k, v)


def _dd(q, k, v, do, causal, seed):
    """A D that is not Σ dO∘O, as ring attention hands in."""
    out, _ = attention.flash_attention_plain(*_t(q, k, v), causal)
    d = (torch.from_numpy(do) * out).sum(-1, keepdim=True)
    noise = np.random.default_rng(seed).standard_normal(d.shape)
    return attention._to_bh(d + torch.from_numpy(noise.astype(np.float32)))


@pytest.mark.parametrize("given_dd", [False, True], ids=["dd", "given_dd"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2), (4, 1)],
                         ids=["mha", "gqa", "mqa"])
def test_flash_backward_plain_matches_reference_kernels(h, kv, causal,
                                                        given_dd):
    """dq, dk, dv of the backward kernels' plain version vs the reference's
    two Pallas backward kernels, multi-block (128 of 256 rows), f32, 2e-4:
    the reference's own bar. With ``given_dd`` both take the caller's D."""
    q, k, v = _qkv(10, h=h, kv=kv)
    do = _qkv(11, h=h, kv=kv)[0]
    ref_out, ref_lse = jattn._flash_forward(*_j(q, k, v), causal, 128, 128,
                                            None)
    out, lse = attention.flash_forward(*_t(q, k, v), causal)
    dd = _dd(q, k, v, do, causal, 12) if given_dd else None
    ref = jattn._flash_backward(
        *_j(q, k, v), ref_out, ref_lse, jnp.asarray(do), causal, 128, 128,
        None, dd=None if dd is None else jnp.asarray(dd.numpy()))
    got = attention._flash_backward(*_t(q, k, v), out, lse,
                                    torch.from_numpy(do), causal, dd)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-4,
                                   rtol=2e-4)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [192, 320])
def test_flash_backward_plain_matches_reference_at_64_row_blocks(s, causal):
    """The same parity at lengths that are multiples of 64 but not of 128,
    the edges the bf16 d=128 dQ kernel's 128-row block and 64-key tiles
    cut: the reference runs at 64-row blocks (interpret mode), GQA 4:2,
    f32, 2e-4."""
    q, k, v = _qkv(17, b=1, s=s, h=4, kv=2)
    do = _qkv(18, b=1, s=s, h=4, kv=2)[0]
    ref_out, ref_lse = jattn._flash_forward(*_j(q, k, v), causal, 64, 64,
                                            None)
    out, lse = attention.flash_forward(*_t(q, k, v), causal)
    ref = jattn._flash_backward(*_j(q, k, v), ref_out, ref_lse,
                                jnp.asarray(do), causal, 64, 64, None)
    got = attention._flash_backward(*_t(q, k, v), out, lse,
                                    torch.from_numpy(do), causal)
    for g, r in zip(got, ref):
        assert g.shape == r.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-4,
                                   rtol=2e-4)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("h,kv", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_flash_gradients_match_jax_grad(h, kv, causal):
    """Gradients through the port's flash_attention (the autograd Function
    on the CPU) vs jax.grad through the reference's custom_vjp, whose
    backward runs the Pallas kernels in interpret mode."""
    q, k, v = _qkv(13, h=h, kv=kv)
    w = _qkv(14, h=h, kv=kv)[0]

    def jloss(q_, k_, v_):
        return jnp.sum(jattn.flash_attention(q_, k_, v_, causal, 128, 128)
                       * w)
    ref = jax.grad(jloss, argnums=(0, 1, 2))(*_j(q, k, v))
    qt, kt, vt = (x.requires_grad_(True) for x in _t(q, k, v))
    (attention.flash_attention(qt, kt, vt, causal)
     * torch.from_numpy(w)).sum().backward()
    for g, r in zip((qt.grad, kt.grad, vt.grad), ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=2e-4,
                                   rtol=2e-4)


def test_flash_backward_plain_matches_autograd_of_naive():
    """The explicit backward equals autograd through naive attention, on a
    ragged length the reference's blocks could not take."""
    q, k, v = (x.requires_grad_(True) for x in _t(*_qkv(15, s=100, h=4,
                                                        kv=2)))
    w = torch.from_numpy(_qkv(16, s=100, h=4, kv=2)[0])
    (attention.naive_attention(q, k, v) * w).sum().backward()
    out, lse = attention.flash_attention_plain(q.detach(), k.detach(),
                                               v.detach())
    got = attention.flash_backward_plain(q.detach(), k.detach(), v.detach(),
                                         out, lse, w)
    for g, r in zip(got, (q.grad, k.grad, v.grad)):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=2e-5,
                                   rtol=2e-5)


def test_cpu_backward_launches_no_kernel():
    before = (attention.FLASH_BWD_DKDV_LAUNCHES,
              attention.FLASH_BWD_DQ_LAUNCHES)
    q = torch.from_numpy(_qkv(17, s=16)[0]).requires_grad_(True)
    k, v = _t(*_qkv(17, s=16)[1:])
    attention.flash_attention(q, k, v).sum().backward()
    assert q.grad is not None
    assert (attention.FLASH_BWD_DKDV_LAUNCHES,
            attention.FLASH_BWD_DQ_LAUNCHES) == before


@pytest.mark.parametrize("case,match", [
    ("do_shape", "dO has shape"),
    ("lse_dtype", "lse must be float32"),
    ("dd_shape", "dd must be float32"),
    ("head_dim", "head_dim"),
])
def test_backward_wrapper_refuses_what_the_kernels_do_not_take(case, match):
    """The CUDA backward wrapper's checks run before anything touches the
    card."""
    d = 48 if case == "head_dim" else 32
    q, k, v = _t(*_qkv(18, b=1, s=16, h=2, kv=2, d=d))
    out, lse = attention.flash_attention_plain(q, k, v)
    do, dd = out, None
    if case == "do_shape":
        do = out[:, :8]
    elif case == "lse_dtype":
        lse = lse.double()
    elif case == "dd_shape":
        dd = lse[:, :8]
    with pytest.raises(ValueError, match=match):
        attention._flash_backward_cuda(q, k, v, out, lse, do, True, dd)


def test_non_cuda_backward_is_refused():
    q, k, v = (x.to("meta") for x in _t(*_qkv(19, b=1, s=8, h=2, kv=2)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        attention._flash_backward(q, k, v, q, q, q)


def _reachable(j: int, i: int, causal: bool, block: int) -> bool:
    """The reference's condition for key block j and q block i
    (jaxbridge/attention.py:235, ``reachable`` in
    _flash_bwd_dkdv_kernel), at K2's block of 64 rows."""
    return (j * block < (i + 1) * block) if causal else True


def _schedule_triples(b, s, h, kv, causal):
    """The (b·kv, key tile, group head, q-tile) walks of K2's schedule, as
    the kernel expands each segment, by block."""
    table = attention._dkdv_schedule(b, s, kv, causal)
    assert table.dtype == np.int32 and table.shape[1:] == (2, 4)
    blocks = []
    for segments in table:
        walk = []
        for bkv, key_tile, first, end in segments:
            if key_tile < 0:
                continue
            walk += [(bkv, key_tile, r, qt) for r in range(h // kv)
                     for qt in range(first, end)]
        blocks.append(walk)
    return blocks


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("h,kv", [(16, 4), (8, 8), (8, 1)],
                         ids=["gqa", "mha", "mqa"])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 200, 1000, 4096])
def test_dkdv_schedule_covers_every_reachable_triple_once(s, h, kv, causal):
    """K2's schedule walks every (key tile, group head, q-tile) triple the
    reference reaches exactly once, and nothing else, for every KV head."""
    b, tile = 2, attention.DKDV_TILE
    n = -(-s // tile)
    blocks = _schedule_triples(b, s, h, kv, causal)
    # the block count flash_bwd.cu's hopper::launch holds the table to
    assert len(blocks) == b * kv * ((n + 1) // 2 if causal else n)
    got = [t for walk in blocks for t in walk]
    want = [(bkv, j, r, i) for bkv in range(b * kv) for j in range(n)
            for r in range(h // kv) for i in range(n)
            if _reachable(j, i, causal, tile)]
    assert len(got) == len(set(got))
    assert sorted(got) == sorted(want)


def test_dkdv_schedule_balances_the_training_shape():
    """At (1, 4096, 16, 4, 128, causal) the longest block walks at most
    1.3× the mean (the reference's one block per key tile: 1.97×)."""
    work = [len(w) for w in _schedule_triples(1, 4096, 16, 4, True)]
    assert len(work) == 128
    assert max(work) <= 1.3 * (sum(work) / len(work))


class _FakeLib:
    """Records the arguments each C entry point is called with."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        def entry(*args):
            self.calls[name] = args
            return 0
        return entry


@pytest.fixture
def fake_lib(monkeypatch):
    """The C entry points' arguments by name, recorded instead of launched;
    the launch counters are restored afterwards."""
    import contextlib
    import ctypes

    from tpusched_torch import _build
    calls = {}
    monkeypatch.setattr(_build, "load", lambda name: _FakeLib(calls))
    monkeypatch.setattr(attention, "_stream",
                        lambda device: ctypes.c_void_p(0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    for name in ("FLASH_FWD_LAUNCHES", "FLASH_BWD_DKDV_LAUNCHES",
                 "FLASH_BWD_DQ_LAUNCHES"):
        monkeypatch.setattr(attention, name, getattr(attention, name))
    return calls


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("path", ["forward", "backward"])
def test_wrappers_pass_what_the_c_signatures_declare(path, causal, fake_lib):
    """Each launch hands its entry point exactly the arguments
    _build.SIGNATURES declares, each convertible to its C type, and K2 its
    schedule: the table of _dkdv_schedule and its block count."""
    from tpusched_torch import _build
    calls = fake_lib
    b, s, h, kv = 1, 130, 4, 2
    q, k, v = (x.bfloat16() for x in _t(*_qkv(20, b=b, s=s, h=h, kv=kv,
                                             d=128)))
    if path == "forward":
        attention._flash_forward_cuda(q, k, v, causal)
        lib = "flash_fwd"
    else:
        out, lse = attention.flash_attention_plain(q, k, v, causal)
        attention._flash_backward_cuda(q, k, v, out, lse, out, causal, None)
        lib = "flash_bwd"
    assert set(calls) == set(_build.SIGNATURES[lib])
    for name, args in calls.items():
        argtypes, _ = _build.SIGNATURES[lib][name]
        assert len(args) == len(argtypes), name
        for argtype, arg in zip(argtypes, args):
            argtype.from_param(arg)
    if path == "backward":
        args = calls["tpusched_flash_bwd_dkdv"]
        table = attention._dkdv_table(b, s, kv, causal, q.device)
        assert args[-3:-1] == (table.data_ptr(), table.shape[0])
        np.testing.assert_array_equal(
            table.numpy(), attention._dkdv_schedule(b, s, kv, causal))


@pytest.mark.parametrize("dtype,d", [(torch.float32, 128), (torch.bfloat16, 64),
                                     (torch.bfloat16, 32)],
                         ids=["f32-d128", "bf16-d64", "bf16-d32"])
def test_k2_schedule_goes_only_to_the_kernel_that_reads_it(dtype, d,
                                                          fake_lib):
    """Only the bf16 d=128 K2 walks a schedule; every other K2 gets a null
    table and a zero block count, and no table is made for it."""
    attention._DKDV_TABLES.clear()
    q, k, v = (x.to(dtype) for x in _t(*_qkv(21, b=1, s=70, h=4, kv=2, d=d)))
    out, lse = attention.flash_attention_plain(q, k, v, True)
    attention._flash_backward_cuda(q, k, v, out, lse, out, True, None)
    assert fake_lib["tpusched_flash_bwd_dkdv"][-3:-1] == (None, 0)
    assert not attention._DKDV_TABLES
