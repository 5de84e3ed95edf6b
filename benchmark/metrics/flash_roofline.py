"""K1, K2 and K3 (``flash_fwd_sm90``, ``flash_bwd_dkdv_sm90``,
``flash_bwd_dq_sm90``) in the traced train steps: the summed bound time
of their calls over their summed device time. Each pass over the model
makes one call of a kernel for each layer that calls flash attention
(``Counts.flash_layers``), so a step's j-th call of a kernel is taken as
that of flash layer j modulo their number, at the step's shape (batch,
seq, heads, kv_heads, head_dim), causal (``Counts.flash_call``)."""
from benchmark import flops, readers

KERNELS = {"K1": "flash_fwd_sm90", "K2": "flash_bwd_dkdv_sm90",
           "K3": "flash_bwd_dq_sm90"}


def read(records):
    tr, peak, c = records["trace"], records["peak"], records["counts"]
    layers = c.flash_layers
    if tr is None or peak is None or not layers:
        return None
    bound = took = 0.0
    for _, a, b in readers.traced_steps(records):
        for kernel, name in KERNELS.items():
            for j, (x, y, _, _) in enumerate(tr.ops_in(a, b, name)):
                ops, nbytes = c.flash_call(kernel, layers[j % len(layers)],
                                           records["batch"], records["seq"])
                bound += flops.bound_s(ops, nbytes, peak)
                took += y - x
    if took <= 0:
        return None
    return 100.0 * bound / took
