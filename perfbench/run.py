"""Run one benchmark cell once on the card and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's files are found by name under
``perfbench/`` (``cells.py``). The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device`` and, traced, ``breakdown``; last of all ``checks``, each
number compared for ``correct`` with its limit, which also end standard
error. Without a card, or with fewer cards than the cell asks for, or
with JAX or the JAX package loaded once the window has closed, it prints
no result and exits with a code other than 0.
"""

import time

START = time.perf_counter()  # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python3 -m perfbench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def report(result) -> None:
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    args = parse_args(argv)
    from perfbench import cells

    chips = cells.load_cell(args.workload).chips
    # every cache the program or its libraries may write stays in the checkout
    os.environ.setdefault("TRITON_CACHE_DIR", str(CHECKOUT / "build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CHECKOUT / "build" / "torch_extensions"))
    # one host thread: the calls' host work is launches and copies, and idle
    # OpenMP workers on the shared cores only add noise
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    from highresnet_tpu_torch.runtime import card_line, setup_device

    from perfbench import harness

    device = setup_device("cuda")
    result = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), device, START)
    found = harness.loaded_forbidden()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"card: {card_line()}", file=sys.stderr)
    report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
