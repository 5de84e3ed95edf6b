"""The train step's model FLOPs (``flops.train_step_flops``: 6 x the
matrices' entries x tokens and causal attention, the remat recompute not
counted) times the window's steps, over the time they took (as
``train_tokens_per_s`` counts them), as a share of the card's bf16 peak."""
from benchmark import flops


def read(records):
    peak, steps = records["peak"], records.get("steps")
    if peak is None or not steps:
        return None
    work = flops.train_step_flops(records["counts"], records["batch"],
                                  records["seq"]) * len(steps)
    return 100.0 * work / records["span_s"] / peak[0]
