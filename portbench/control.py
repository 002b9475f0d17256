#!/usr/bin/env python3
"""Readings that a cell's correctness limits are set from.

    python3 portbench/control.py --workload <cell> --seeds 12 \
        --control-seeds 3 [--faults half,unchanged] [--seconds 1.5] \
        [--first-seed N] [--out DIR]

In one process on the card: the port's sound runs on ``--seeds`` seeds
(the lower reading of each compared number is their largest), the
control on ``--control-seeds`` more (the port's lower-precision path, the
traffic's ``control`` overrides; the upper reading is its smallest), and
each planted fault named on as many.  Each run is a whole run of the cell
with a window of ``--seconds``; only its compared numbers are kept.  One
JSON line a run, then a summary line, go to standard output (and to
``DIR/<cell>.control.jsonl``).  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def readings(name: str, seeds, seconds: float, device, emit, **kw) -> list:
    from portbench.harness import cell

    out = []
    for seed in seeds:
        r = cell.run_cell(name, seed, seconds, False, device, guard=False, **kw)
        row = {"cell": name, "seed": seed, "correct": r["correct"],
               "failed": r["failed"],
               **{k: v["value"] for k, v in r["checks"].items()}, **kw}
        emit(row)
        out.append(row)
    return out


def summary(sound: list, runs: dict) -> dict:
    keys = [k for k in sound[0] if k.endswith("_gap")]

    def worst(rows, k, pick):
        vals = [r[k] if r[k] is not None else float("inf") for r in rows]
        return pick(vals) if vals else None

    return {k: {"lower": worst(sound, k, max),
                **{f"upper_{what}": worst(rows, k, min)
                   for what, rows in runs.items()}} for k in keys}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=1.5)
    p.add_argument("--first-seed", type=int, default=2_147_483_000)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    for path in (ROOT, ROOT / "src"):
        sys.path.insert(0, str(path))
    log = None
    if args.out:
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        log = open(out / f"{args.workload}.control.jsonl", "a")

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if log:
            log.write(line + "\n")
            log.flush()

    s0 = args.first_seed
    sound = readings(args.workload, range(s0, s0 + args.seeds), args.seconds,
                     args.device, emit)
    s0 += args.seeds
    runs = {"control": readings(
        args.workload, range(s0, s0 + args.control_seeds), args.seconds,
        args.device, emit, control=True)}
    for fault in filter(None, args.faults.split(",")):
        s0 += args.control_seeds
        runs[fault] = readings(args.workload,
                               range(s0, s0 + args.control_seeds),
                               args.seconds, args.device, emit, fault=fault)
    emit({"cell": args.workload, "summary": summary(sound, runs)})
    if log:
        log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
