#!/usr/bin/env python3
"""Run one cell of the benchmark of the PyTorch/CUDA port once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout on a machine with the CUDA devices the cell
asks for. Sets up the cell (scenes from the seed, the program built and
warmed up), measures for `--seconds`, holds the window's answers against the
plain reference, and prints one JSON line last on standard output: with
`--trace 0` the cell's end-to-end metrics, with `--trace 1` its per-layer
metrics and a device breakdown. The numbers the check compared, each beside
its limit, are the last lines on standard error and the result's last key.
Exits non-zero, printing no result, without the devices, without the
program, or when a JAX module was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()
BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
CACHE = os.path.join(ROOT, ".bench_cache")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # every cache of the program at a fixed place inside the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [BENCH, ROOT]
    try:
        import hortimapping_tpu_torch  # noqa: F401  (the system under test)
    except ImportError as e:
        print(f"run.py: the program is not in this checkout ({e})", file=sys.stderr)
        return 2

    from lib.harness import forbidden_modules, run_cell

    result, lines, notes = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                                    t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f"run.py: JAX modules loaded in this process: {found}", file=sys.stderr)
        return 3
    print("notes " + json.dumps(notes), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
