import numpy as np
import pytest

from benchmark import traffic

MIX = traffic.load("traffic", "chat")
CELL = {"rate_per_s": 8.0}


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 123456789012])
def test_same_seed_same_requests(seed):
    a = traffic.generate(MIX, CELL, seed, 5.0, 32000)
    b = traffic.generate(MIX, CELL, seed, 5.0, 32000)
    assert len(a) == len(b) == traffic.request_count(MIX, CELL, 5.0)
    for x, y in zip(a, b):
        assert x["due_s"] == y["due_s"] and x["max_new"] == y["max_new"]
        assert np.array_equal(x["prompt"], y["prompt"])


def test_seeds_share_the_work_in_another_order():
    a = traffic.generate(MIX, CELL, 1, 30.0, 32000)
    b = traffic.generate(MIX, CELL, 2, 30.0, 32000)
    assert sorted(len(r["prompt"]) for r in a) == sorted(
        len(r["prompt"]) for r in b)
    assert sorted(r["max_new"] for r in a) == sorted(r["max_new"] for r in b)
    assert a[-1]["due_s"] == pytest.approx(b[-1]["due_s"])
    assert [len(r["prompt"]) for r in a] != [len(r["prompt"]) for r in b]
    assert not all(np.array_equal(x["prompt"][:4], y["prompt"][:4])
                   for x, y in zip(a, b))


@pytest.mark.parametrize("mix", ["chat", "batch"])
def test_lengths_clipped_and_median(mix):
    m = traffic.load("traffic", mix)
    for key in ("prompt", "output"):
        spec = m[key]
        xs = traffic.quantile_lengths(spec, 1001)
        assert xs.min() == spec["min"] and xs.max() == spec["max"]
        assert int(np.median(xs)) == spec["median"]


def test_arrivals_poisson_mean_and_offline_all_due_at_once():
    gaps = traffic.quantile_gaps(8.0, 4000)
    assert gaps.mean() == pytest.approx(1 / 8.0, rel=2e-3)
    batch = traffic.load("traffic", "batch")
    reqs = traffic.generate(batch, {}, 3, 40.0, 32000)
    assert len(reqs) == batch["requests"]
    assert all(r["due_s"] == 0.0 for r in reqs)
    assert all(0 <= r["prompt"].min() and r["prompt"].max() < 32000
               for r in reqs)


def test_arrivals_cluster_and_long_prompts_meet_as_under_poisson():
    """The shuffle keeps what a tail feels: arrivals a second apart are
    counted as Poisson counts them (variance about the mean), and two long
    prompts follow each other as often as independent draws would."""
    counts, pairs, n_pairs = [], 0, 0
    for seed in range(40):
        reqs = traffic.generate(MIX, {"rate_per_s": 2.0}, 2**32 + seed,
                                400.0, 32000)
        due = np.array([r["due_s"] for r in reqs])
        counts += list(np.bincount(due.astype(int))[:400])
        n = np.array([len(r["prompt"]) for r in reqs])
        top = n >= np.quantile(n, 0.875)
        pairs += int((top[1:] & top[:-1]).sum())
        n_pairs += len(n) - 1
    counts = np.array(counts)
    assert counts.mean() == pytest.approx(2.0, rel=0.02)
    assert 0.9 < counts.var() / counts.mean() < 1.1
    assert pairs / n_pairs == pytest.approx(1 / 64, rel=0.25)


@pytest.mark.parametrize("strata", [0, 32])
def test_offline_order_uniform_or_stratified(strata):
    """Without ``strata`` the lengths are the uniform shuffle; with it the
    same lengths, each block of ``strata`` requests holding one of each
    stratum, so that every seed's head of the queue meets the same work."""
    mix = dict(traffic.load("traffic", "batch"), strata=strata)
    n = mix["requests"]
    want = traffic.quantile_lengths(mix["output"], n)
    heads = []
    for seed in (5, 2**33 + 1):
        got = np.array([r["max_new"] for r in
                        traffic.generate(mix, {}, seed, 40.0, 32000)])
        assert sorted(got) == sorted(want)
        if not strata:
            assert np.array_equal(
                got, traffic.rng(seed, 2).permutation(want))
            continue
        edges = np.sort(want).reshape(strata, -1)
        for block in got.reshape(-1, strata):
            assert all(edges[i, 0] <= v <= edges[i, -1]
                       for i, v in enumerate(sorted(block)))
        heads.append(got[:384].sum())
    if strata:
        assert abs(heads[0] - heads[1]) <= 0.01 * heads[0]
