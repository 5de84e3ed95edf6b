"""K1 (``flash_fwd_sm90``, the prefill's flash attention) in the traced
admit ticks: the summed bound time of its calls over their summed device
time. A prefill makes one call of each layer that calls flash attention
(``Counts.flash_layers``), in order, at its prompt bucket's shape (1,
bucket, heads, kv_heads, head_dim), causal; the tick's prefills run in the
order of its admits. A tick whose calls do not number so is left out."""
from benchmark import flops, readers

K1 = "flash_fwd_sm90"


def read(records):
    tr, peak, c = records["trace"], records["peak"], records["counts"]
    if tr is None or peak is None:
        return None
    layers = c.flash_layers
    bound = took = 0.0
    for t, a, b in readers.traced_ticks(records, admitting=True):
        calls = tr.ops_in(a, b, K1)
        if len(calls) != len(layers) * len(t["admits"]):
            continue
        for i, (x, y, _, _) in enumerate(calls):
            bucket = t["admits"][i // len(layers)][1]
            ops, nbytes = c.flash_call("K1", layers[i % len(layers)], 1,
                                       bucket)
            bound += flops.bound_s(ops, nbytes, peak)
            took += y - x
    if took <= 0:
        return None
    return 100.0 * bound / took
