"""tpusched_torch.attention against tpusched.jaxbridge.attention on the CPU.

The same numpy inputs go through the JAX reference (its Pallas flash kernel
in interpret mode, as tests/test_attention.py runs it) and through the
port's CPU path, which is the CUDA kernel's plain version."""
from __future__ import annotations

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
    ("grad", RuntimeError, "forward-only"),
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
        q.requires_grad_(True)
    elif case == "head_dim":
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
