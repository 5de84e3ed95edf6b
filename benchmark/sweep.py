"""The knee of an open-loop cell, on the card, in one process:

    python3 -m benchmark.sweep --workload <cell> --rates 6,8,10 --seconds 30 --seed 7

Runs the cell at each offered rate (the cell file's rate replaced) and
prints its tails and its queue: the knee is the highest rate at which the
queue stays short and the second half's time to first token is not above
the first half's.
"""
import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    from benchmark import harness
    bench = harness.Bench(harness.PACKAGE.parent)
    cell = bench.data("cells", args.workload)
    for rate in (float(x) for x in args.rates.split(",")):
        t0 = time.perf_counter()
        r = harness.run_cell(args.workload, args.seed, args.seconds, False,
                             t0, cell_override={"rate_per_s": rate,
                                                "engine": cell["engine"]},
                             check=False)
        print(json.dumps({"rate_per_s": rate, "metrics": r["metrics"],
                          "notes": r["notes"], "attempted": r["attempted"],
                          "failed": r["failed"],
                          "wall_s": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
