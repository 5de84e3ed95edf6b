import pytest

from benchmark import flops
from benchmark.archs import mistral, mixtral

DENSE = dict(hidden_size=8, intermediate_size=12, vocab_size=10,
             num_hidden_layers=2, num_attention_heads=2,
             num_key_value_heads=1, torch_dtype="bfloat16")
MOE = dict(DENSE, num_local_experts=4, num_experts_per_tok=2)


def test_prefill_by_hand():
    sh = mistral.counts(DENSE)
    # per layer: wq 8x8, wk 8x4, wv 8x4, wo 8x8 = 192; mlp 3 x 8 x 12 = 288
    assert [x.matrix for x in sh.layers] == [480, 480]
    n = 5
    attn = 4 * 2 * 4 * (5 * 6 // 2)           # 4 x heads x hd x pairs
    assert flops.prefill_flops(sh, n) == 2 * (2 * 480 * n + attn) + 2 * 8 * 10


def test_moe_counts_routed_experts_only():
    sh = mixtral.counts(MOE)
    per_token = 192 + 8 * 4 + 2 * 288
    assert [x.matrix for x in sh.layers] == [per_token, per_token]
    assert (flops.decode_flops(sh, [3, 0])
            == 2 * (2 * 2 * per_token + 2 * 8 * 10)
            + 2 * 32 * (4 + 1))


def test_decode_bytes_by_hand():
    sh = mistral.counts(DENSE)
    weights = 2 * (192 + 16) + 80 + 8 + 2 * 288
    kv = (3 + 1 + 0 + 1) * 2 * 2 * 4
    assert flops.decode_bytes(sh, [3, 0]) == 2 * (weights + 2 * 8 + kv)
    shm = mixtral.counts(MOE)
    full = flops.decode_bytes(shm, [3, 0])
    two = flops.decode_bytes(shm, [3, 0], experts_routed=[2, 2])
    assert full - two == 2 * (2 * 2 * 288)


@pytest.mark.parametrize("kernel,ops", [("K1", 4), ("K2", 8), ("K3", 6)])
def test_flash_call_by_hand(kernel, ops):
    b, s, h, kv, hd = 1, 4, 2, 1, 8
    got_ops, got_bytes = flops.flash_call(kernel, b, s, h, kv, hd)
    assert got_ops == ops * 10 * h * hd
    q, k = s * h * hd * 2, s * kv * hd * 2
    lse = 4 * h * s
    want = {"K1": 2 * q + 2 * k + lse, "K2": 2 * q + 4 * k + 2 * lse,
            "K3": 3 * q + 2 * k + 2 * lse}[kernel]
    assert got_bytes == want


def test_peaks_and_bound():
    assert flops.peaks("NVIDIA H100 80GB HBM3") == (989e12, 3.35e12)
    assert flops.peaks("cpu") is None
    assert flops.bound_s(989e12, 1.0, (989e12, 3.35e12)) == 1.0
    assert flops.bound_s(1.0, 3.35e12, (989e12, 3.35e12)) == 1.0
