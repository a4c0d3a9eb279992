#!/usr/bin/env python3
"""The readings the check's limits are set from, on the chip: a cell run on
many seeds in one process, each run's numbers printed beside its limits.

    python3 benchmark/control.py --workload <cell> --seconds <s> --seed <n> [--seed <n> ...]
        [--as control|program|lane_unchanged] [--override <file.json>] [--out <file.jsonl>]

`--as control` (the default): the plain reference, one precision below the
configuration's, in the place of the program's kernels and of its normal
equations' algebra (`lib/control.py`); every seed has to come out not
correct, and its readings set the upper end of each limit. `--as program`:
sound runs of the program, whose largest readings set the lower end.
`--as lane_unchanged`: the program with the last lane of every LM step
(of either solver) returning its input iterate (a fault at one lane of a
full batch). `--override`: a JSON file whose `config` and `workload`
blocks are merged into the cell's files (as the tests' overrides are), so
that a configuration with no cell yet can be read on the chip.
`--out` appends each run's numbers and every compared step to a file.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)


def lower(ctx):
    from lib import control

    undo = control.install(ctx.reference, control.lowered(ctx.config["precision"]),
                           trust_region=ctx.config["solver"]["trust_region"])
    return lambda: control.uninstall(undo)


def lane_unchanged(ctx):
    from hortimapping_tpu_torch.optim import lm

    orig = lm.lm_iteration

    def f(params, spec, cfg, obs, state, *a, **k):
        new = orig(params, spec, cfg, obs, state, *a, **k)
        lat, T = new.latent.clone(), new.T_ow.clone()
        lat[-1], T[-1] = state.latent[-1], state.T_ow[-1]
        return new._replace(latent=lat, T_ow=T)

    orig_tr = lm.lm_iteration_tr

    def g(params, spec, cfg, obs, ts, *a, **k):
        new = orig_tr(params, spec, cfg, obs, ts, *a, **k)
        lat, T = new.base.latent.clone(), new.base.T_ow.clone()
        lat[-1], T[-1] = ts.base.latent[-1], ts.base.T_ow[-1]
        return new._replace(base=new.base._replace(latent=lat, T_ow=T))

    lm.lm_iteration, lm.lm_iteration_tr = f, g

    def undo():
        lm.lm_iteration, lm.lm_iteration_tr = orig, orig_tr
    return undo


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--as", dest="mode", choices=("control", "program", "lane_unchanged"),
                    default="control")
    ap.add_argument("--override")
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path[:0] = [BENCH, ROOT]
    from lib.harness import run_cell

    overrides = None
    if args.override:
        with open(args.override) as f:
            given = json.load(f)
        overrides = {k: given[k] for k in ("config", "workload") if k in given}

    seen = {}

    def before(ctx):
        seen["ctx"] = ctx
        if args.mode == "control":
            return lower(ctx)
        if args.mode == "lane_unchanged":
            return lane_unchanged(ctx)
        return lambda: None

    for seed in args.seed:
        res, lines, notes = run_cell(ROOT, args.workload, seed, args.seconds, False, before=before,
                                     overrides=overrides)
        row = {"as": args.mode, "workload": args.workload, "seed": seed, "correct": res["correct"],
               "check": res["check"], "notes": notes}
        if args.override:
            row["override"] = args.override
        print(json.dumps(row), flush=True)
        if args.out:
            row["steps"] = getattr(seen["ctx"], "check_steps", [])
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
