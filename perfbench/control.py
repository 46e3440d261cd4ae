"""Read a cell's control on the card: the plain reference computed in the
nearest precision below the configuration's (TF32 for float32) in the
program's place, compared with the float32 reference by the cell's own
numbers. A sound benchmark's control comes out not correct.

    python3 perfbench/control.py --workload <cell> --seeds 11 12 13

Prints one JSON line per seed: each number beside the cell's limit.
``--fault half_batch`` reads a training fault the same way.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default=None,
                    help="plant this fault in the reference in the "
                    "program's place instead (training: half_batch)")
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    if not torch.cuda.is_available():
        print("perfbench control: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl = harness.workload(args.workload)
    driver = harness.load_module("drivers", wl["driver"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        cell = harness.Cell(args.workload, wl, harness.config(wl["config"]),
                            seed, 0.0, False, torch.device("cuda", 0), t0)
        numbers = (driver.control(cell, args.fault) if args.fault
                   else driver.control(cell))
        print(json.dumps(dict(
            workload=args.workload, seed=seed, fault=args.fault,
            seconds=time.perf_counter() - t0,
            numbers={k: dict(value=float(v), limit=cell.limit(k))
                     for k, v in numbers.items()})), flush=True)
        del cell
        harness.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
