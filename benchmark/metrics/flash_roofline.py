"""K1, K2 and K3 (``flash_fwd_sm90``, ``flash_bwd_dkdv_sm90``,
``flash_bwd_dq_sm90``) in the traced train steps: the summed bound time
of their calls, each at the step's shape (batch, seq, heads, kv_heads,
head_dim), causal (``flops.flash_call``), over their summed device time."""
from benchmark import flops, readers

KERNELS = {"K1": "flash_fwd_sm90", "K2": "flash_bwd_dkdv_sm90",
           "K3": "flash_bwd_dq_sm90"}


def read(records):
    tr, peak, sh = records["trace"], records["peak"], records["shapes"]
    if tr is None or peak is None:
        return None
    bound = took = 0.0
    for _, a, b in readers.traced_steps(records):
        for kernel, name in KERNELS.items():
            ops, nbytes = flops.flash_call(kernel, records["batch"],
                                           records["seq"], sh.h, sh.kv,
                                           sh.hd, sh.item)
            for x, y, _, _ in tr.ops_in(a, b, name):
                bound += flops.bound_s(ops, nbytes, peak)
                took += y - x
    if took <= 0:
        return None
    return 100.0 * bound / took
