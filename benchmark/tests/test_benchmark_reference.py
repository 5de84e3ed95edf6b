"""The plain reference against tpusched_torch at a tiny size on the CPU,
in float32, on the benchmark's own weights."""
import pytest
import torch

from benchmark import model
from benchmark.reference import judge, model as ref
from benchmark.tests.conftest import tiny_conf


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_reference_equals_port_forward(moe):
    from tpusched_torch import workload
    conf = tiny_conf(moe)
    w = model.make_weights(conf, 2**31 + 11, "cpu")
    cfg = model.arch(conf).port_config(conf)
    tokens = torch.randint(0, conf["vocab_size"], (40,),
                           generator=torch.Generator().manual_seed(3))
    port = workload.forward(w, tokens[None], cfg, dropless=True)[0]
    mine = ref.logits(w, conf, tokens, torch.arange(40))
    torch.testing.assert_close(mine, port, atol=2e-5, rtol=2e-5)


def test_rotary_base_and_eps_follow_the_file():
    conf = tiny_conf()
    w = model.make_weights(conf, 5, "cpu")
    tokens = torch.arange(30) % conf["vocab_size"]
    rows = torch.arange(30)
    a = ref.logits(w, conf, tokens, rows)
    b = ref.logits(w, dict(conf, rope_theta=1e6), tokens, rows)
    c = ref.logits(w, dict(conf, rms_norm_eps=1e-1), tokens, rows)
    assert (a - b).abs().max() > 1e-3 and (a - c).abs().max() > 1e-3


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_control_reads_wider_than_the_reference(moe):
    """The control (fp8 products) picks tokens the float32 reference ranks
    below its best; the reference's own greedy tokens read 0."""
    conf = tiny_conf(moe)
    w = model.make_weights(conf, 17, "cpu")
    items = []
    g = torch.Generator().manual_seed(1)
    for _ in range(4):
        prompt = torch.randint(0, conf["vocab_size"], (20,), generator=g)
        seq = prompt.clone()
        for _ in range(30):            # the reference's own greedy tokens
            nxt = ref.logits(w, conf, seq, torch.tensor([len(seq) - 1]))
            seq = torch.cat([seq, nxt.argmax(-1)])
        items.append((prompt.numpy(), seq[20:].numpy()))
    g = judge.gaps(w, conf, items, "cpu")
    assert g.size == 120 and g.max() == 0.0
    assert judge.gaps(w, conf, items, "cpu", control="fp8").max() > 1e-3


def test_a_leaf_made_again_alone_is_the_same(monkeypatch):
    conf = tiny_conf(moe=True)
    monkeypatch.setattr(model, "CHUNK", 1000)
    w = model.make_weights(conf, 2**33 + 1, "cpu")
    for path in [("embed",), ("ln_f",), ("layers", 1, "router"),
                 ("layers", 0, "w_down")]:
        leaf = (w[path[0]] if len(path) == 1
                else w["layers"][path[1]][path[2]])
        assert torch.equal(model.initial_leaf(conf, 2**33 + 1, path, "cpu"),
                           leaf)
