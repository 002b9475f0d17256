#!/usr/bin/env python3
"""Per-layer readings from the port's own spans, and what recording costs.

    python3 portbench/port_spans.py --workload <cell> --seed <n> \
        [--seconds 3] [--windows on,off,on,off] [--out DIR]

In one process on the card: the cell's set-up once, then one traced
window a word of ``--windows``, each as long as the traffic's
``trace_seconds`` at most.  Window i runs on seed ``--seed`` + i, so a
sweep scores fresh candidate sets in every window.  Every window runs
under the profiler as a ``--trace 1`` run of the benchmark does
(``harness/spans.SpanTracer``), with the port's span recorder
(``repro_torch.tracing``) open (``on``) or shut (``off``), so the rates
of the two read the recorder's cost.

One JSON line a window goes to standard output (and to
``DIR/<cell>.spans.jsonl``): the rates the window read; the cell's
per-layer metrics with the span metrics of ``per_layer()`` that list it;
the idle gaps labelled with the port's spans, the share of idle seconds
that a port span names, and for the rest the spans on either side; and
the cross-checks of the span metrics against the readings taken from
outside.  ``per_layer()`` gives the span metrics' entries as
``BENCHMARK.json`` would list them, each cell taken from what its
traffic's driver declares (``span_metrics`` in ``drivers/``); the
benchmark's own runs read none of them yet.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _metric(name, unit, source, layer, moves) -> dict:
    return {"name": name, "unit": unit, "better": "lower", "source": source,
            "layer": layer, "moves": moves}


# the span metrics' entries less their cells (``per_layer``)
METRICS = [
    _metric("serve.queue_wait_ms", "ms", "program_span", "serving engine",
            "serve_p95_ms"),
    _metric("serve.serial_host_ms", "ms", "program_span", "serving engine",
            "serve_req_s"),
    _metric("serve.launches_per_batch", "count", "device_trace",
            "serving engine", "serve_req_s"),
    _metric("dse.inputs_build_ms", "ms", "program_span", "design flow",
            "emulate_samples_per_s"),
    _metric("dse.prep_ms", "ms", "program_span", "design flow",
            "emulate_samples_per_s"),
    _metric("train.upload_wait_ms", "ms", "program_span", "training driver",
            "train_samples_per_s"),
]


def declared(cell) -> dict:
    """The span metrics the cell's driver declares for its traffic: name
    -> whether every window reads it (``drivers/__init__.py``)."""
    from portbench.harness import spec

    return spec.driver_module(cell).span_metrics(cell.traffic)


def per_layer(root: pathlib.Path = ROOT) -> list:
    """``METRICS``, each with ``workloads``: the cells of
    ``BENCHMARK.json`` whose driver declares it, in their order there."""
    from portbench.harness import spec

    cells = [spec.resolve(w["name"], root=root)
             for w in spec.load_benchmark(root)["workloads"]]
    of = {c.name: declared(c) for c in cells}
    return [dict(m, workloads=[c.name for c in cells
                               if m["name"] in of[c.name]])
            for m in METRICS]


def port_named_share(idle_gaps) -> float:
    """The share of the listed idle seconds whose label names a port span."""
    total = sum(s for _, s in idle_gaps)
    named = sum(s for label, s in idle_gaps if label.split(" / ")[1] != "-")
    return named / total if total > 0 else None


def unnamed(data, top: int = 5) -> list:
    """Idle gaps no port work span names, by the work spans that end
    before and start after their middles: [[before, after, seconds,
    count]], the most seconds first."""
    import bisect

    from portbench.harness.spans import _Sweep

    work = sorted((s.t0, s.t1, s.name) for s in data.spans if not s.wait
                  and not s.name.startswith("portbench."))
    open_at = _Sweep(work)
    starts = [w[0] for w in work]
    ends = sorted((w[1], w[2]) for w in work)
    totals: dict = {}
    for mid, length in sorted(data.gaps):
        if open_at.at(mid):
            continue
        i = bisect.bisect_right(ends, (mid, ""))
        j = bisect.bisect_right(starts, mid)
        key = (ends[i - 1][1] if i else "-",
               work[j][2] if j < len(work) else "-")
        seconds, count = totals.get(key, (0.0, 0))
        totals[key] = (seconds + length, count + 1)
    rows = sorted(totals.items(), key=lambda kv: -kv[1][0])[:top]
    return [[a, b, s, n] for (a, b), (s, n) in rows]


def cross_checks(data, metrics: dict) -> dict:
    """Each span metric beside the reading it should agree with."""
    from portbench.harness.spans import children, mean, ms, named

    out = {}
    kids = children(data)
    batches = named(data, "serve.batch")
    if batches and "serve.serial_host_ms" in metrics:
        out["serial_host_s"] = metrics["serve.serial_host_ms"] \
            * len(batches) * 1e-3
        out["idle_s"] = data.window_s - data.busy_s
    if "dse.inputs_build_ms" in metrics and "dse.new_set_ms" in metrics:
        out["inputs_build_over_new_set"] = (metrics["dse.inputs_build_ms"]
                                            / metrics["dse.new_set_ms"])
    chunks = named(data, "train.chunk")
    if chunks and "train.upload_wait_ms" in metrics:
        rest = mean((ms(c) - sum(ms(k) for k in kids[c.id]
                                 if k.name == "train.upload"))
                    / c.attrs["steps"] for c in chunks)
        out["upload_plus_rest_ms"] = metrics["train.upload_wait_ms"] + rest
        out["dispatch_ms"] = metrics.get("train.dispatch_ms")
    return out


def run(name: str, seed: int, seconds: float, windows, device, emit,
        smoke: bool = False) -> list:
    """The cell's windows, one row each (see the module docstring)."""
    import torch

    from portbench.harness import chip, spec
    from portbench.harness.spans import SpanTracer
    from portbench.harness.trace import TOP

    cell = spec.resolve(name, smoke=smoke)
    device = torch.device(device)
    tracer = SpanTracer(True, device)
    driver = spec.driver_module(cell).Driver(cell, seed, device, tracer)
    driver.setup()
    seconds = min(float(seconds), float(cell.traffic["trace_seconds"]))
    metrics_of = cell.per_layer + [m for m in per_layer()
                                   if name in m["workloads"]]
    rows = []
    for i, word in enumerate(windows):
        tracer.record = word == "on"
        driver.seed = seed + i
        with tracer.window():
            window = driver.run(seconds)
        data = tracer.data
        data.readings = window.readings
        metrics = {}
        for m in metrics_of:
            value = spec.metric_reader(m["name"]).read(data, m, cell)
            if value is not None:
                metrics[m["name"]] = value
        row = {"cell": name, "seed": seed + i, "window": i, "recorder": word,
               "rates": window.end_to_end, "metrics": metrics,
               "window_s": data.window_s, "busy_s": data.busy_s,
               "idle_gap_s": sum(s for _, s in data.idle_gaps),
               "port_named_share": port_named_share(data.idle_gaps),
               "idle_gaps": data.idle_gaps[:TOP], "unnamed": unnamed(data),
               "spans": len(data.spans), "drift_us": data.drift_us,
               "span_launches": data.span_launches,
               "cross": cross_checks(data, metrics),
               "events": data.events, "digest_s": data.digest_s}
        emit(row)
        rows.append(row)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    emit({"cell": name, "device": chip.device_record(device, cell.chips,
                                                     peak)})
    driver.release()
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=2_147_483_123)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--windows", default="on,off,on,off")
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    for path in (ROOT, ROOT / "src"):
        sys.path.insert(0, str(path))
    windows = args.windows.split(",")
    if set(windows) - {"on", "off"}:
        p.error("--windows takes on and off, comma-separated")
    log = None
    if args.out:
        out = pathlib.Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        log = open(out / f"{args.workload}.spans.jsonl", "a")

    def emit(row):
        line = json.dumps(row)
        print(line, flush=True)
        if log:
            log.write(line + "\n")
            log.flush()

    try:
        run(args.workload, args.seed, args.seconds, windows, args.device, emit)
    finally:
        if log:
            log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
