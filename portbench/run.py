#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on a CUDA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--record DIR]

From the root of a checkout.  Set-up builds the port's objects for the
cell and warms every shape the cell's traffic uses; the window then runs
for ``--seconds`` (with ``--trace 1``, the traffic's ``trace_seconds``
at most, under the profiler).  The last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
``breakdown`` (traced runs) and last ``checks``, each number compared
with the reference beside its limit; the same numbers close standard
error.  ``--record DIR`` also writes the line to a file there.

Exits non-zero, with no result, without a CUDA card (or fewer cards
than the cell asks for), and when the process holds JAX or the JAX
package once the window has closed.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--record", default=None,
                   help="directory to write the result line to as well")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    for path in (ROOT, ROOT / "src"):
        if str(path) not in sys.path:
            sys.path.insert(0, str(path))
    # every compiler cache at a fixed place inside the checkout
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    from portbench.harness import chip

    started = chip.process_start()
    import torch

    with open(ROOT / "BENCHMARK.json") as f:
        cells = {w["name"]: w for w in json.load(f)["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from portbench.harness import cell

    try:
        result = cell.run_cell(args.workload, args.seed % (1 << 64),
                               args.seconds, bool(args.trace), "cuda:0",
                               started=started)
    except cell.ForeignModules as e:
        print(f"refused: {e}", file=sys.stderr)
        return 3
    line = json.dumps(result)
    if args.record:
        out = pathlib.Path(args.record)
        out.mkdir(parents=True, exist_ok=True)
        name = f"{args.workload}.{args.seed}.trace{args.trace}.json"
        (out / name).write_text(line + "\n")
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr, flush=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
