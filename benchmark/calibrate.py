"""Readings that set a cell's limit, on the card, in one process:

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 --seconds 20 [--control 1]

Each seed runs the cell's whole path at its own load for ``--seconds``
(weights, engine and warm-up anew), then judges it against the float32
reference as a benchmark run does. With ``--control 1`` the fp8 reference
is also put in the program's place and judged by the same check and
limits (``control_correct``, which has to come out false), and an MoE
cell's routing is looked at (``serving.routing_look``). One JSON line a
seed.
"""
import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", type=int, default=0)
    args = ap.parse_args(argv)
    from benchmark import harness
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds, False, t0,
                             control=bool(args.control))
        look = r["notes"].get("gaps", {})
        print(json.dumps({"seed": seed, "correct": r["correct"],
                          "control_correct": look.get("control_correct"),
                          "compared": r["compared"], "metrics": r["metrics"],
                          "notes": r["notes"],
                          "peak": r["device"]["memory_peak_bytes"],
                          "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
