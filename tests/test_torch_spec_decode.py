"""tpusched_torch.spec_decode and the draft/keyed functions of
tpusched_torch.decode on the CPU, against tpusched.jaxbridge.

Greedy speculation is deterministic, so the port's tokens AND its stats
(target calls, drafted, accepted) must equal jaxbridge's on the same f32
weights. Sampled speculation draws from the port's own counter-based keys
(JAX's threefry cannot be reproduced in torch), so it is held to the
reference's laws instead: keyed draws are deterministic and uniform,
accept/residual emits exactly the target's distribution, and a self-draft
reproduces ``sample_position_keyed`` token for token."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusched.jaxbridge import decode as jdec, spec_decode as jsd
from tpusched.jaxbridge import workload as jwl
from tpusched_torch import decode, interop, spec_decode as sd
from tpusched_torch import workload as wl
from tpusched_torch.program import Program

torch.set_num_threads(1)

# the reference tests' draft: one layer, d_model 32 (head_dim 16, which only
# the plain attention takes; the card's flash kernel takes 32, 64, 128)
DRAFT = dict(n_layers=1, d_model=32, n_heads=2, d_ff=64)
# chi-square thresholds at p = 1e-4 for 7 and 19 degrees of freedom (an
# 8-token distribution with one token masked has 7 cells of mass: 6 d.o.f.,
# so 7 is the looser side)
CHI2_7, CHI2_19 = 29.8775, 50.7955


def _pair(jcfg, seed):
    cfg = wl.ModelConfig(**{f.name: getattr(jcfg, f.name)
                            for f in dataclasses.fields(wl.ModelConfig)
                            if f.name not in ("dtype", "param_dtype")})
    jp = jwl.init_params(jax.random.PRNGKey(seed), jcfg)
    return jcfg, jp, cfg, interop.params_from_numpy(
        jax.tree.map(np.asarray, jp), cfg, "cpu")


def _truncated(jcfg, jp, cfg, p):
    """A draft that partly agrees with its target: the target's first layer
    with its embedding, norm and head, so acceptance runs are neither 0 nor
    k (a random draft accepts nothing, a self-draft everything)."""
    return (dataclasses.replace(jcfg, n_layers=1), {**jp, "layers": jp[
        "layers"][:1]}, dataclasses.replace(cfg, n_layers=1),
            {**p, "layers": p["layers"][:1]})


@pytest.fixture(scope="module")
def models():
    target = _pair(jwl.ModelConfig.tiny(), 0)
    return {"target": target,
            "random": _pair(dataclasses.replace(jwl.ModelConfig.tiny(),
                                                **DRAFT), 100),
            "self": target,
            "truncated": _truncated(*target)}


def _prompt(seed, n, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, (1, n),
                                                dtype=np.int32)


def _same_error(ref, port):
    """Both raise ValueError with the same message."""
    with pytest.raises(ValueError) as want:
        ref()
    with pytest.raises(ValueError) as got:
        port()
    assert str(got.value) == str(want.value)


# -- greedy speculation: tokens and stats equal jaxbridge's ---------------------

@pytest.mark.parametrize("draft", ["random", "self"])
@pytest.mark.parametrize("steps", [1, 7, 12])
@pytest.mark.parametrize("k", [1, 3, 4])
def test_speculative_generate_matches_reference(models, k, steps, draft):
    jcfg, jp, cfg, p = models["target"]
    djcfg, djp, dcfg, dp = models[draft]
    prompt = _prompt(1, 9)
    ref, ref_stats = jsd.speculative_generate(jp, jcfg, djp, djcfg,
                                              jnp.asarray(prompt), steps, k=k)
    got, stats = sd.speculative_generate(p, cfg, dp, dcfg,
                                         torch.from_numpy(prompt).long(),
                                         steps, k=k)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert stats == ref_stats
    np.testing.assert_array_equal(got, decode.generate(
        p, torch.from_numpy(prompt).long(), cfg, steps).numpy())
    if draft == "self":
        assert stats["accept_rate"] == 1.0
        rounds = -(-(steps) // (k + 1))   # the prefill emits the first token
        assert stats["target_calls"] == 1 + rounds


def test_partial_acceptance_matches_reference(models):
    """The truncated draft accepts some proposals and rejects others, the
    path between the random draft's n_ok = 0 and the self-draft's n_ok = k."""
    jcfg, jp, cfg, p = models["target"]
    djcfg, djp, dcfg, dp = models["truncated"]
    prompt = _prompt(1, 6)
    ref, ref_stats = jsd.speculative_generate(jp, jcfg, djp, djcfg,
                                              jnp.asarray(prompt), 20, k=3)
    got, stats = sd.speculative_generate(p, cfg, dp, dcfg,
                                         torch.from_numpy(prompt).long(), 20,
                                         k=3)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert stats == ref_stats
    assert 0 < stats["accepted"] < stats["drafted"]


def test_speculative_generate_moe_target_matches_reference(models):
    """An MoE target verifies through the dropless decode path."""
    jcfg, jp, cfg, p = _pair(dataclasses.replace(
        jwl.ModelConfig.tiny(), n_experts=4, moe_top_k=2), 5)
    djcfg, djp, dcfg, dp = models["random"]
    prompt = _prompt(7, 8)
    for k in (3, 4):
        ref, ref_stats = jsd.speculative_generate(
            jp, jcfg, djp, djcfg, jnp.asarray(prompt), 6, k=k)
        got, stats = sd.speculative_generate(
            p, cfg, dp, dcfg, torch.from_numpy(prompt).long(), 6, k=k)
        np.testing.assert_array_equal(got, np.asarray(ref))
        assert stats == ref_stats
    got, stats = sd.speculative_generate(
        p, cfg, p, cfg, torch.from_numpy(prompt).long(), 6, k=3)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert stats["accept_rate"] == 1.0


@pytest.mark.parametrize("per_row", [False, True])
def test_draft_rollout_matches_reference(models, per_row):
    """The draft phase alone: ingest a 2-row feed at a scalar or per-row
    cursor, propose k tokens; proposals equal jaxbridge's."""
    jcfg, jp, cfg, p = models["target"]
    prompt = np.random.default_rng(3).integers(0, 256, (2, 10),
                                               dtype=np.int32)
    feed = np.random.default_rng(4).integers(0, 256, (2, 2), dtype=np.int32)
    pos = np.asarray([8, 6], np.int32) if per_row else 8
    _, jc = jdec.prefill(jp, jdec.init_kv_cache(jcfg, 2, 24),
                         jnp.asarray(prompt), jcfg)
    ref, _ = jdec.draft_rollout(jp, jc, jnp.asarray(feed), jnp.asarray(pos),
                                jcfg, 4)
    cache = decode.init_kv_cache(cfg, 2, 24, "cpu")
    decode.prefill(p, cache, torch.from_numpy(prompt).long(), cfg)
    got, _ = decode.draft_rollout(p, cache, torch.from_numpy(feed).long(),
                                  pos, cfg, 4)
    assert got.shape == (2, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sampling_draft_rollout_probs_match_reference(models):
    """The first proposal's adjusted distribution equals jaxbridge's within
    1e-5 (later rows follow different sampled tokens), and every row of
    proposal_probs is the float64 distribution its proposal was drawn from."""
    jcfg, jp, cfg, p = models["target"]
    prompt = _prompt(5, 7)
    _, jc = jdec.prefill(jp, jdec.init_kv_cache(jcfg, 1, 20),
                         jnp.asarray(prompt), jcfg)
    _, ref_probs, _ = jdec.sampling_draft_rollout(
        jp, jc, jnp.asarray(prompt[:, -1:]), 6, jcfg, 3,
        jax.random.PRNGKey(0), temperature=0.8, top_k=24, top_p=0.9)
    cache = decode.init_kv_cache(cfg, 1, 20, "cpu")
    decode.prefill(p, cache, torch.from_numpy(prompt).long(), cfg)
    toks, probs, _ = decode.sampling_draft_rollout(
        p, cache, torch.from_numpy(prompt[:, -1:]).long(), 6, cfg, 3, 11,
        temperature=0.8, top_k=24, top_p=0.9)
    assert toks.shape == (1, 3) and probs.shape == (1, 3, cfg.vocab)
    assert probs.dtype == np.float64
    np.testing.assert_allclose(probs[0, 0], np.asarray(ref_probs)[0, 0],
                               atol=1e-5)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-12)
    for i in range(3):
        # each proposal lies in its top-k support and has nonzero mass
        assert probs[0, i, toks[0, i]] > 0
        assert (probs[0, i] > 0).sum() <= 24


def _program_calls(monkeypatch):
    """Every ``Program`` call, as (the program, the names of its inputs)."""
    calls = []
    real = Program.__call__

    def spy(self, **values):
        calls.append((self, tuple(sorted(self.inputs))))
        return real(self, **values)

    monkeypatch.setattr(Program, "__call__", spy)
    return calls


@pytest.mark.parametrize("draft", ["random", "self", "truncated"])
def test_a_speculation_keeps_its_programs_across_calls(models, draft,
                                                       monkeypatch):
    """A ``Speculation`` called on three prompts of its length gives
    jaxbridge's tokens and stats each time, running the programs it built
    at construction (no program is made by a call); a prompt of another
    length is refused."""
    jcfg, jp, cfg, p = models["target"]
    djcfg, djp, dcfg, dp = models[draft]
    spec = sd.Speculation(p, cfg, dp, dcfg, 8, 11, 3, "cpu")
    built = []
    monkeypatch.setattr(Program, "__init__", lambda *a, **kw: built.append(a))
    for seed in (4, 5, 4):
        prompt = _prompt(seed, 8)
        got, stats = spec(torch.from_numpy(prompt).long())
        ref, ref_stats = jsd.speculative_generate(jp, jcfg, djp, djcfg,
                                                  jnp.asarray(prompt), 11,
                                                  k=3)
        np.testing.assert_array_equal(got, np.asarray(ref))
        assert stats == ref_stats
    assert built == []
    with pytest.raises(ValueError, match="shape"):
        spec(torch.from_numpy(_prompt(4, 9)).long())


@pytest.mark.parametrize("draft", ["random", "self"])
def test_speculative_generate_runs_its_rounds_as_programs(models, draft,
                                                          monkeypatch):
    """Each greedy round is two program calls, the draft's (one program
    per catch-up length: a self-draft, accepting everything, feeds 2 rows
    after its first round) and the target span's, each built once a
    call; the tokens and stats stay jaxbridge's."""
    jcfg, jp, cfg, p = models["target"]
    djcfg, djp, dcfg, dp = models[draft]
    prompt = _prompt(4, 8)
    calls = _program_calls(monkeypatch)
    got, stats = sd.speculative_generate(p, cfg, dp, dcfg,
                                         torch.from_numpy(prompt).long(), 11,
                                         k=3)
    ref, ref_stats = jsd.speculative_generate(jp, jcfg, djp, djcfg,
                                              jnp.asarray(prompt), 11, k=3)
    np.testing.assert_array_equal(got, np.asarray(ref))
    assert stats == ref_stats
    rounds = stats["target_calls"] - 1
    assert len(calls) == 2 * rounds
    drafts = [prog for prog, names in calls[0::2]]
    assert all(names == ("feed", "pos") for _, names in calls[0::2])
    assert all(names == ("pos", "scored") for _, names in calls[1::2])
    assert len({id(prog) for prog, _ in calls[1::2]}) == 1
    widths = {prog.inputs["feed"].shape[1] for prog in drafts}
    assert widths == ({1, 2} if draft == "self" else {1})
    assert len({id(prog) for prog in drafts}) == len(widths)


def test_speculative_sample_runs_its_rounds_as_programs(models,
                                                        monkeypatch):
    """Each sampled round is the draft's ingest, k - 1 one-token steps and
    the verify span, the serving engine's three programs at batch 1; a
    self-draft still reproduces ``sample_position_keyed``."""
    jcfg, jp, cfg, p = models["target"]
    prompt = torch.from_numpy(_prompt(3, 6)).long()
    ref = decode.sample_position_keyed(p, prompt, cfg, 14, 9,
                                       temperature=0.8, top_k=32)
    calls = _program_calls(monkeypatch)
    got, stats = sd.speculative_sample(p, cfg, p, cfg, prompt, 14, 9, k=3,
                                       temperature=0.8, top_k=32)
    np.testing.assert_array_equal(got, ref.numpy())
    rounds = stats["target_calls"] - 1
    assert len(calls) == (1 + 2 + 1) * rounds
    shapes = [tuple(prog.inputs["tokens"].shape) for prog, _ in calls]
    for r in range(rounds):
        ingest, *steps, span = shapes[4 * r:4 * r + 4]
        assert ingest in ((1, 1), (1, 2)) and span == (1, 4)
        assert steps == [(1, 1), (1, 1)]
    assert len({id(prog) for prog, _ in calls}) <= 4


# -- the numpy functions, copied: equal to the reference's ----------------------

def test_numpy_functions_equal_reference():
    rng = np.random.default_rng(9)
    for _ in range(20):
        v, k = int(rng.integers(4, 64)), int(rng.integers(1, 6))
        p = rng.dirichlet(np.full(v, 0.3), size=k)
        q = rng.dirichlet(np.full(v, 0.5), size=k)
        np.testing.assert_array_equal(sd.residual_distribution(p[0], q[0]),
                                      jsd.residual_distribution(p[0], q[0]))
        span = rng.integers(0, v, k)
        acc, res = rng.random(k), rng.random(k)
        assert sd.accept_span(span, p, q, acc, res) == jsd.accept_span(
            span, p, q, acc, res)
        adj = rng.standard_normal((k, v)) * 4
        adj[:, 0] = -3.0e38                # a masked entry
        np.testing.assert_array_equal(sd.probs_from_adjusted(adj),
                                      jsd.probs_from_adjusted(adj))
    q = rng.dirichlet(np.full(16, 1.0))
    np.testing.assert_allclose(sd.residual_distribution(q, q), q, atol=1e-12)


# -- the keyed randomness: its laws ------------------------------------------

def test_fold_in_and_keyed_uniform_are_deterministic_and_uniform():
    n = 20000
    u = np.asarray([decode.keyed_uniform(7, r) for r in range(n)])
    assert u.tolist() == [decode.keyed_uniform(7, r) for r in range(n)]
    assert ((u >= 0) & (u < 1)).all()
    counts = np.bincount((u * 20).astype(int), minlength=20)
    assert ((counts - n / 20) ** 2 / (n / 20)).sum() < CHI2_19
    # another key, another stream; negative data (a warmup rid) is a key too
    assert decode.keyed_uniform(8, 0) != decode.keyed_uniform(7, 0)
    keys = {decode.fold_in(5, rid) for rid in range(-3, 1000)}
    assert len(keys) == 1003 and all(0 <= x < 2 ** 64 for x in keys)


def test_salted_streams_are_uncorrelated():
    rows = range(1, 20001)
    base = np.asarray([decode.keyed_uniform(3, r) for r in rows])
    for salt in (decode.ACCEPT_SALT, decode.RESIDUAL_SALT):
        other = np.asarray([decode.keyed_uniform(3, salt + r) for r in rows])
        assert abs(np.corrcoef(base, other)[0, 1]) < 4 / np.sqrt(len(base))
    acc = [decode.keyed_uniform(3, decode.ACCEPT_SALT + r) for r in rows]
    res = [decode.keyed_uniform(3, decode.RESIDUAL_SALT + r) for r in rows]
    assert abs(np.corrcoef(acc, res)[0, 1]) < 4 / np.sqrt(len(acc))
    assert decode.ACCEPT_SALT == jdec.ACCEPT_SALT
    assert decode.RESIDUAL_SALT == jdec.RESIDUAL_SALT


def _synthetic(seed):
    """An 8-token draft p and target q with one token masked out of each."""
    rng = np.random.default_rng(seed)
    adj_p, adj_q = rng.standard_normal(8) * 1.5, rng.standard_normal(8)
    adj_p[3] = adj_q[6] = -3.0e38
    return adj_p, adj_q


def test_keyed_categorical_matches_its_distribution():
    _, adj = _synthetic(1)
    q = decode.probs_from_adjusted(adj)
    n = 20000
    draws = np.asarray([decode.keyed_categorical(adj, 99, r)
                        for r in range(n)])
    assert draws[6:].tolist() == [decode.keyed_categorical(adj, 99, r)
                                  for r in range(6, n)]
    counts = np.bincount(draws, minlength=8)
    assert counts[6] == 0                 # the masked token never appears
    keep = q > 0
    assert ((counts[keep] - n * q[keep]) ** 2 / (n * q[keep])).sum() < CHI2_7


def _keyed_pairs(n, seed):
    """``n`` (key, row) pairs: keys below and at or above 2**63 (both ends
    included), rows small, negative, large and past ``ACCEPT_SALT`` and
    ``RESIDUAL_SALT``, as the speculative round keys them."""
    rng = np.random.default_rng(seed)
    keys = [int(k) for k in rng.integers(0, 2**63, n // 2, dtype=np.uint64)]
    keys += [2**63 + int(k) for k in rng.integers(0, 2**63, n - n // 2,
                                                   dtype=np.uint64)]
    keys[:4] = [0, 2**63 - 1, 2**63, 2**64 - 1]
    base = rng.integers(0, 1 << 20, n)
    kind = np.arange(n) % 5
    rows = np.where(kind == 0, base, np.where(
        kind == 1, -base - 1, np.where(
            kind == 2, decode.ACCEPT_SALT + base, np.where(
                kind == 3, decode.RESIDUAL_SALT + base,
                rng.integers(-2**62, 2**62, n)))))
    return keys, [int(r) for r in rows]


def test_device_keyed_draw_equals_keyed_categorical():
    """The serving engine's device draw (``keyed_draw``) against the
    host's law (``keyed_categorical``) on 10**4 (key, row) pairs, each
    over its own adjusted row of 64 logits (a quarter of them top-k
    masked with ``NEG_INF``): the uniforms are the host's bit for bit,
    and every token is the host's."""
    n, vocab = 10_000, 64
    keys, rows = _keyed_pairs(n, 17)
    rng = np.random.default_rng(18)
    adj = (rng.standard_normal((n, vocab)) * 3).astype(np.float32)
    masked = adj < np.sort(adj, axis=1)[:, [vocab - 8]]
    adj[(np.arange(n) % 4 == 0)[:, None] & masked] = np.float32(-3.4e38)
    k = torch.tensor([decode.as_int64(x) for x in keys])
    r = torch.tensor(rows)
    u = decode.keyed_uniform_device(k, r).numpy()
    assert u.tolist() == [decode.keyed_uniform(a, b)
                          for a, b in zip(keys, rows)]
    got = decode.keyed_draw(torch.from_numpy(adj), k, r)
    assert got.dtype == torch.long
    assert got.tolist() == [decode.keyed_categorical(a, x, y)
                            for a, x, y in zip(adj, keys, rows)]


def test_accept_span_with_keyed_uniforms_emits_target_distribution():
    """One proposal drawn from p with its row's key, accepted with the
    ACCEPT_SALT uniform, else resampled from the residual with the
    RESIDUAL_SALT one: the emitted token is distributed as q."""
    adj_p, adj_q = _synthetic(2)
    p, q = decode.probs_from_adjusted(adj_p), decode.probs_from_adjusted(
        adj_q)
    n, key = 20000, 12345
    emitted = []
    for r in range(n):
        x = decode.keyed_categorical(adj_p, key, r)
        n_ok, rej = sd.accept_span(
            [x], p[None], q[None],
            [decode.keyed_uniform(key, decode.ACCEPT_SALT + r)],
            [decode.keyed_uniform(key, decode.RESIDUAL_SALT + r)])
        emitted.append(x if n_ok else rej)
    counts = np.bincount(emitted, minlength=8)
    assert counts[6] == 0
    keep = q > 0
    assert ((counts[keep] - n * q[keep]) ** 2 / (n * q[keep])).sum() < CHI2_7


# -- sampled speculation: its laws ----------------------------------------------

@pytest.mark.parametrize("k", [1, 3, 4])
def test_self_draft_speculative_sample_is_position_keyed(models, k):
    jcfg, jp, cfg, p = models["target"]
    prompt = torch.from_numpy(_prompt(1, 7)).long()
    ref = decode.sample_position_keyed(p, prompt, cfg, 18, 42,
                                       temperature=0.8, top_k=32)
    got, stats = sd.speculative_sample(p, cfg, p, cfg, prompt, 18, 42, k=k,
                                       temperature=0.8, top_k=32)
    np.testing.assert_array_equal(got, ref.numpy())
    assert stats["accept_rate"] == 1.0
    assert stats["target_calls"] < stats["plain_calls"]


def test_sample_position_keyed_keys_rows():
    """The token at row p draws (key, p): a longer run extends a shorter
    one, and the rows' keys, not the step count, decide the tokens."""
    _, _, cfg, p = _pair(jwl.ModelConfig.tiny(), 0)
    prompt = torch.from_numpy(_prompt(2, 6)).long()
    a = decode.sample_position_keyed(p, prompt, cfg, 5, 3, temperature=0.9)
    b = decode.sample_position_keyed(p, prompt, cfg, 12, 3, temperature=0.9)
    assert a.shape == (1, 6) and torch.equal(a, b[:, :6])
    c = decode.sample_position_keyed(p, prompt, cfg, 12, 4, temperature=0.9)
    assert not torch.equal(b, c)
    greedy_like = decode.sample_position_keyed(p, prompt, cfg, 5, 3,
                                               temperature=1.0, top_p=0.0)
    assert torch.equal(greedy_like, decode.generate(p, prompt, cfg, 5))


def test_weak_draft_speculative_sample(models):
    """A real draft: deterministic for a key, different across keys, in
    the vocabulary, with rejections (the residual path runs)."""
    jcfg, jp, cfg, p = models["target"]
    _, _, dcfg, dp = models["truncated"]
    prompt = torch.from_numpy(_prompt(2, 5)).long()

    def run(key):
        return sd.speculative_sample(p, cfg, dp, dcfg, prompt, 15, key, k=3,
                                     temperature=0.9)
    a, sa = run(7)
    b, _ = run(7)
    c, _ = run(8)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)
    assert a.shape == (1, 16) and ((a >= 0) & (a < cfg.vocab)).all()
    assert 0 <= sa["accepted"] < sa["drafted"]


# -- validation: the reference's messages ---------------------------------------

def test_validation_matches_reference(models):
    jcfg, jp, cfg, p = models["target"]
    djcfg, djp, dcfg, dp = models["random"]
    two = np.zeros((2, 4), np.int32)
    one = np.zeros((1, 4), np.int32)
    bad_j = dataclasses.replace(djcfg, vocab=512)
    bad = dataclasses.replace(dcfg, vocab=512)
    cases = [
        (dict(prompt=two), {}),
        (dict(prompt=one, vocab_bad=True), {}),
        (dict(prompt=one), dict(k=0)),
    ]
    for args, kw in cases:
        dj, d = (bad_j, bad) if args.get("vocab_bad") else (djcfg, dcfg)
        _same_error(
            lambda: jsd.speculative_generate(jp, jcfg, djp, dj, jnp.asarray(
                args["prompt"]), 2, **kw),
            lambda: sd.speculative_generate(p, cfg, dp, d, torch.from_numpy(
                args["prompt"]).long(), 2, **kw))
    _same_error(
        lambda: jsd.speculative_sample(jp, jcfg, jp, jcfg, jnp.asarray(one),
                                       4, jax.random.PRNGKey(0),
                                       temperature=0.0),
        lambda: sd.speculative_sample(p, cfg, p, cfg, torch.from_numpy(
            one).long(), 4, 0, temperature=0.0))
    with pytest.raises(ValueError, match="single-sequence"):
        sd.speculative_sample(p, cfg, p, cfg, torch.from_numpy(two).long(),
                              4, 0)
