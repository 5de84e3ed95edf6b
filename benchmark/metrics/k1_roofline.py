"""K1 (``flash_fwd_sm90``, the prefill's flash attention) in the traced
admit ticks: the summed bound time of its calls over their summed device
time. A tick's calls are a layer count for each prefill, in the order the
prefills ran, each at its prompt bucket's shape (1, bucket, heads,
kv_heads, head_dim), causal; a tick whose calls do not number so is left
out."""
from benchmark import flops, readers

K1 = "flash_fwd_sm90"


def read(records):
    tr, peak, sh = records["trace"], records["peak"], records["shapes"]
    if tr is None or peak is None:
        return None
    bound = took = 0.0
    for t, a, b in readers.traced_ticks(records, admitting=True):
        calls = tr.ops_in(a, b, K1)
        if len(calls) != sh.layers * len(t["admits"]):
            continue
        for i, (x, y, _, _) in enumerate(calls):
            bucket = t["admits"][i // sh.layers][1]
            ops, nbytes = flops.flash_call("K1", 1, bucket, sh.h, sh.kv,
                                           sh.hd, sh.item)
            bound += flops.bound_s(ops, nbytes, peak)
            took += y - x
    if took <= 0:
        return None
    return 100.0 * bound / took
