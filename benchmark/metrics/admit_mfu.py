"""Model FLOPs of the traced admit ticks (each admitted prompt's prefill
at its true length, an MoE layer's routed experts only, and the tick's
decode step) over their device-busy time, as a share of the card's bf16
peak."""
from benchmark import flops, readers


def read(records):
    tr, peak, c = records["trace"], records["peak"], records["counts"]
    if tr is None or peak is None:
        return None
    work = busy = 0.0
    for t, a, b in readers.traced_ticks(records, admitting=True):
        work += sum(flops.prefill_flops(c, n) for n, _ in t["admits"])
        work += flops.decode_flops(c, t["contexts"])
        busy += tr.busy_in(a, b)
    if busy <= 0:
        return None
    return 100.0 * work / busy / peak[0]
