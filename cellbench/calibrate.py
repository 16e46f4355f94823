"""The readings that a cell's limits are set from: the program's compared
numbers and the lower-precision control's, on many seeds, in one process.

    python3 cellbench/calibrate.py --workload <name> --seeds 11 12 13 --seconds 4 [--control]

For each seed, one run of the cell with a short window (`run.run`, the
same set-up, timed path and checked batches), then with `--control` the
reference at the precision below the configuration's judged on the same
batches in the program's place. Prints one JSON line per seed, then the
largest program reading and the smallest control reading of each number.
The benchmark's own runs never run the control.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from cellbench import judge, run

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    spec = run.Spec(ROOT, args.workload)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    import cv2

    torch.set_num_threads(1)
    cv2.setNumThreads(1)
    prog, ctrl = {k: [] for k in judge.NUMBERS}, {k: [] for k in judge.NUMBERS}
    for seed in args.seeds:
        res = run.run(spec, seed, args.seconds, 0, dev, control=args.control, readings=True,
                      log=lambda *a, **k: None)
        line = {"seed": seed, "correct": res["correct"], "program": res["numbers"], "compared": res["compared"]}
        if args.control:
            line["control"], line["control_compared"] = res["control"], res["control_compared"]
        print(json.dumps(line), flush=True)
        for k in judge.NUMBERS:
            prog[k].append(line["program"][k])
            if args.control:
                ctrl[k].append(res["control"][k])
    summary = {k: {"program_max": max(prog[k]), "control_min": min(ctrl[k]) if ctrl[k] else None}
               for k in judge.NUMBERS}
    print(json.dumps({"workload": args.workload, "seeds": len(args.seeds), "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
