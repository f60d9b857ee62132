"""Readings that a cell's limits are set from, many seeds in one process.

    python3 -m perfbench.calibrate --workload <cell> --seeds 1,2,3 [--seconds 3]
        [--control] [--fault unchanged|half_batch|altered] [--out PATH]

Each seed is one ``harness.run`` on the card with a short window at the
cell's own load: the program's readings, or with ``--control`` those of
the plain reference at TF32 in the program's place, or with ``--fault``
those of the program with that fault planted (``faults.py``). One JSON
line per seed: the numbers compared, the end-to-end metrics and set-up.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

from perfbench import faults


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m perfbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=faults.FAULTS)
    p.add_argument("--out", default=None, help="also append the lines to this file")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("perfbench.calibrate needs a CUDA device", file=sys.stderr)
        return 2
    from highresnet_tpu_torch.runtime import setup_device

    from perfbench import harness

    device = setup_device("cuda")
    for seed in (int(s) for s in args.seeds.split(",")):
        plant = faults.plant(args.fault) if args.fault else contextlib.nullcontext()
        with plant:
            r = harness.run(args.workload, seed, args.seconds, False, device,
                            time.perf_counter(), control=args.control)
        line = json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                           "fault": args.fault,
                           "numbers": {k: c["value"] for k, c in r["checks"].items()},
                           "metrics": {k: m["value"] for k, m in r["metrics"].items()},
                           "memory_peak_bytes": r["device"]["memory_peak_bytes"]})
        print(line, flush=True)
        if args.out:
            with Path(args.out).open("a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
