"""The readings the check's limits are set from, in one process: for
each seed, the cell set up and served for a short window at its own
load, the program's sampled answers and the control's (the reference
in TF32, put in the program's place, on the same queries) compared with
the reference.  One JSON line a seed; with ``--explain``, after it one
line (``"mismatch"``) for each sampled answer that parts from the
reference (``judge.explain``).  ``--every-query`` judges one answer of
each query served in place of the configuration's sample.

    python3 portbench/readings.py --workload star-bulk --seconds 4 \
        --seeds 11 12 13
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--explain", action="store_true")
    ap.add_argument("--every-query", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from portbench.run import fixed_caches
    fixed_caches(ROOT)
    import torch
    from portbench import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        bench = harness.setup(ROOT, args.workload, seed, dev)
        win = bench.load.window(args.seconds)
        bench.release()
        t = time.perf_counter()
        res = harness.check(bench, win.calls, seed, control=True,
                            explain=args.explain,
                            every_query=args.every_query)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "served": sum(c.pool_idx.shape[0]
                                        for c in win.calls),
                          "program": res["program"],
                          "control": res["control"],
                          "check_s": time.perf_counter() - t}),
              flush=True)
        for m in res.get("mismatches", []):
            print(json.dumps({"mismatch": args.workload, "seed": seed, **m}),
                  flush=True)
        del bench
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
