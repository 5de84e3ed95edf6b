"""Bytes the traced decode ticks need over their device-busy time, as a
share of the card's HBM bandwidth: the weights once and each decoding
slot's live K/V rows at its own length (``flops.decode_bytes``)."""
from benchmark import flops, readers


def read(records):
    tr, peak, c = records["trace"], records["peak"], records["counts"]
    if tr is None or peak is None:
        return None
    need = busy = 0.0
    for t, a, b in readers.traced_ticks(records, admitting=False):
        need += flops.decode_bytes(c, t["contexts"])
        busy += tr.busy_in(a, b)
    if busy <= 0:
        return None
    return 100.0 * need / busy / peak[1]
