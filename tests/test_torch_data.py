"""tpusched_torch.data against tpusched.jaxbridge.data on the CPU:
``pack_documents`` gives the reference's arrays exactly (its own cases and
seeded random documents); ``TokenBatcher`` yields the reference's stream,
value for value, as int64 tensors, resumes at ``start_step``, and gives the
same global batch on every rank of a {"dp": 2} mesh, where the train step
on it equals the step on the reference's batch."""
from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

import torch_ranks
from tpusched.jaxbridge import data as jdata
from tpusched.jaxbridge import workload as jwl
from tpusched_torch import data, mesh as tmesh, workload as wl

torch.set_num_threads(1)


def _random_docs(seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 500, int(rng.integers(0, 40))).tolist()
            for _ in range(int(rng.integers(0, 12)))]


PACK_CASES = {
    "reference": ([[1, 2, 3], [4, 5], [6, 7, 8, 9, 10, 11, 12]], 8, 99, 0),
    "long_document": ([list(range(1, 20))], 8, 99, 0),
    "empty": ([], 8, 99, 0),
    "pad_7": ([[5, 6], [7]], 4, 1, 7),
    **{f"random_{seed}": (_random_docs(seed), 16, 0, 3)
       for seed in range(8)},
}


@pytest.mark.parametrize("name", list(PACK_CASES))
def test_pack_documents_matches_reference(name):
    docs, seq, eos, pad = PACK_CASES[name]
    got = data.pack_documents(docs, seq, eos, pad)
    want = jdata.pack_documents(docs, seq, eos, pad)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("start_step", [0, 2])
def test_token_batcher_is_the_reference_stream(seed, start_step):
    cfg, jcfg = wl.ModelConfig.tiny(), jwl.ModelConfig.tiny()
    got = list(itertools.islice(
        data.TokenBatcher(cfg, 4, seed=seed, start_step=start_step,
                          device="cpu"), 3))
    want = list(itertools.islice(
        jdata.TokenBatcher(jcfg, 4, seed=seed, start_step=start_step), 3))
    for g, w in zip(got, want):
        assert g.dtype == torch.int64 and g.device.type == "cpu"
        assert g.shape == (4, cfg.seq)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_token_batcher_resumes_mid_stream():
    cfg = wl.ModelConfig.tiny()
    whole = list(itertools.islice(data.TokenBatcher(cfg, 2, seed=5,
                                                    device="cpu"), 4))
    resumed = list(itertools.islice(
        data.TokenBatcher(cfg, 2, seed=5, start_step=2, device="cpu"), 2))
    for a, b in zip(whole[2:], resumed):
        assert torch.equal(a, b)
    other = next(iter(data.TokenBatcher(cfg, 2, seed=6, device="cpu")))
    assert not torch.equal(other, whole[0])


def test_token_batcher_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data.TokenBatcher(wl.ModelConfig.tiny(), 2)


def test_token_batcher_on_a_dp_mesh(tmp_path):
    """Two gloo ranks draw the same global batches, the reference's; the
    SGD step on the port's first batch gives the loss of the step on the
    reference's (the values are equal)."""
    cfg, jcfg = wl.ModelConfig.tiny(), jwl.ModelConfig.tiny()
    want = [np.asarray(b) for b in itertools.islice(
        jdata.TokenBatcher(jcfg, 4, seed=3), 2)]
    ranks = tmesh.launch(torch_ranks.batcher_rank, {"dp": 2}, cfg, 2,
                         want[0], backend="gloo", device="cpu",
                         workdir=str(tmp_path))
    for r in ranks:
        for got, ref in zip(r["batches"], want):
            np.testing.assert_array_equal(got, ref)
        assert r["losses"][0] == r["losses"][1]
    assert ranks[0]["losses"] == ranks[1]["losses"]
