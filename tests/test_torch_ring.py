"""Sequence-parallel attention: the port's ring_attention and
ring_flash_attention on gloo ranks (CPU) against jaxbridge's
make_ring_attention and make_ring_flash_attention on a virtual CPU sp mesh
(Pallas in interpret mode), at sp = 2 and 4, causal and not, MHA and GQA
(4 heads over 2): out within 2e-5 and the gradients of sum(out²) within
2e-4, the reference's own tolerances (tests/test_attention.py). The
masked-outlier input (keys of the second half ×100) gives finite gradients
within 3e-3/2e-3; the skip is counted: at causal sp = n, rank r runs the
flash forward and backward 1 + r times, every pair that is not wholly in
its future. One spawn of four ranks runs every case
(``torch_ranks.ring_rank``); the ranks import no JAX."""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from tpusched.jaxbridge import attention as jattn
from tpusched.jaxbridge import mesh as jmeshlib
from tpusched_torch import mesh as tmesh

torch.set_num_threads(1)


def _qkv(seed, b=2, s=64, h=2, kv=2, d=64, outlier=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    if outlier:
        # future keys whose raw logits dwarf the first half's global lse
        k[:, s // 2:] *= 100.0
    return q, k, v


# name -> (sp, causal, flash, seed, qkv options)
CASES = {f"{'flash' if flash else 'ring'}_sp{sp}_{'causal' if causal else 'full'}":
         (sp, causal, flash, 10 * sp + 2 * causal + flash, {})
         for sp in (2, 4) for causal in (True, False) for flash in (False, True)}
CASES.update({
    "flash_sp2_gqa": (2, True, True, 40, dict(h=4, kv=2)),
    "ring_sp4_gqa": (4, True, False, 41, dict(h=4, kv=2)),
    "flash_sp4_gqa_full": (4, False, True, 42, dict(h=4, kv=2)),
    "flash_sp2_outlier": (2, True, True, 43, dict(outlier=True)),
})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = {name: (sp, causal, flash, *_qkv(seed, **opts))
             for name, (sp, causal, flash, seed, opts) in CASES.items()}
    return tmesh.launch(torch_ranks.ring_rank, {"sp": 4}, cases,
                        backend="gloo", device="cpu",
                        workdir=str(tmp_path_factory.mktemp("ranks")))


def _joined(ranks, name, sp):
    """Each output joined over the sp ranks of the first group, in index
    order (rank r of {"sp": 4} and rank 2·d + r of {"dp": 2, "sp": 2})."""
    group = [ranks[r][name] for r in range(sp)]
    assert [g["index"] for g in group] == list(range(sp))
    return {k: np.concatenate([g[k] for g in group], axis=1)
            for k in ("out", "dq", "dk", "dv")}


def _reference(name):
    sp, causal, flash, seed, opts = CASES[name]
    mesh = jmeshlib.build_named_mesh({"sp": sp})
    q, k, v = (jnp.asarray(x) for x in _qkv(seed, **opts))
    if flash:
        ring = jattn.make_ring_flash_attention(mesh, causal=causal,
                                               block_q=32, block_k=32)
    else:
        ring = jattn.make_ring_attention(mesh, causal=causal)
    out = jax.jit(ring)(q, k, v)
    grads = jax.jit(jax.grad(lambda q, k, v: jnp.sum(ring(q, k, v) ** 2),
                             argnums=(0, 1, 2)))(q, k, v)
    return {"out": out, **dict(zip(("dq", "dk", "dv"), grads))}


@pytest.mark.parametrize("name", [n for n in CASES if "outlier" not in n])
def test_ring_matches_reference(ranks, name):
    """Out within 2e-5 and dq, dk, dv within 2e-4 of the reference's ring
    on the same mesh size; both groups of the sp = 2 mesh agree."""
    sp = CASES[name][0]
    got, ref = _joined(ranks, name, sp), _reference(name)
    np.testing.assert_allclose(got["out"], ref["out"], atol=2e-5, rtol=2e-5)
    for g in ("dq", "dk", "dv"):
        np.testing.assert_allclose(got[g], ref[g], atol=2e-4, rtol=2e-4,
                                   err_msg=g)
    if sp == 2:
        for r in range(2):
            for key in ("out", "dq", "dk", "dv"):
                np.testing.assert_array_equal(ranks[r][name][key],
                                              ranks[2 + r][name][key])


def test_masked_outlier_gradients_stay_finite(ranks):
    """Keys of the second half ×100: for the first chunk's queries they are
    masked, but their raw logits exceed the row's global lse, so a kernel
    run on the excluded pair would overflow exp(s − lse) to inf and 0·inf
    would poison dQ. The pair is skipped: every gradient is finite and
    within 3e-3/2e-3 of the reference's."""
    got, ref = _joined(ranks, "flash_sp2_outlier", 2), _reference(
        "flash_sp2_outlier")
    for g in ("dq", "dk", "dv"):
        assert np.isfinite(got[g]).all(), g
        np.testing.assert_allclose(got[g], ref[g], atol=3e-3, rtol=2e-3,
                                   err_msg=g)


@pytest.mark.parametrize("name", ["flash_sp4_causal", "flash_sp2_causal",
                                  "flash_sp4_full", "ring_sp4_causal"])
def test_excluded_pairs_launch_nothing(ranks, name):
    """Causal: rank r runs the flash forward and backward on the diagonal
    pair and on each earlier chunk, 1 + r times, and never on a future
    chunk; non-causal: sp times. The naive ring runs neither."""
    sp, causal, flash = CASES[name][:3]
    for rank in ranks[:sp]:
        got = rank[name]
        want = (1 + got["index"] if causal else sp) if flash else 0
        assert got["calls"] == {"forward": want, "backward": want}
