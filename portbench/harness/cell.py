"""One run of one cell: set-up, the window, the reading of the trace, the
comparison with the reference, and the result line."""
from __future__ import annotations

import gc
import math
import sys
import time

import torch

from portbench.harness import chip, spec
from portbench.harness.trace import Tracer


class ForeignModules(RuntimeError):
    """The run's process holds JAX or the JAX package."""


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             fault=None, control: bool = False, smoke: bool = False,
             started: float = None, guard: bool = True) -> dict:
    """Run cell ``name`` once and return its result line (a dict).

    ``control`` runs the cell's control (its traffic's ``control``
    overrides: the port's lower-precision path); ``fault`` plants one of
    the driver's faults; ``smoke`` takes the CPU twins of the cell's
    files.  ``started`` is the ``perf_counter`` reading at process start
    (``chip.process_start``), from which ``setup_s`` counts.  With
    ``guard``, JAX or the JAX package in ``sys.modules`` once the window
    has closed raises ``ForeignModules``.
    """
    started = time.perf_counter() if started is None else started
    cell = spec.resolve(name, smoke=smoke)
    if control:
        over = cell.traffic.get("control", {})
        cell.config.update({k: v for k, v in over.items() if k in cell.config})
        cell.traffic.update({k: v for k, v in over.items()
                             if k not in cell.config})
    device = torch.device(device)
    tracer = Tracer(trace, device)
    driver = spec.driver_module(cell).Driver(cell, seed, device, tracer, fault)
    t_driver = time.perf_counter()
    driver.setup()
    seconds = float(seconds)
    if trace:
        seconds = min(seconds, float(cell.traffic.get("trace_seconds", seconds)))
    setup_s = time.perf_counter() - started
    print(f"setup: {t_driver - started:.2f} s to the driver (interpreter, "
          f"imports), {setup_s - (t_driver - started):.2f} s in its set-up",
          file=sys.stderr)
    with tracer.window():
        window = driver.run(seconds)
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    found = chip.foreign_modules()
    if guard and found:
        raise ForeignModules(f"the run's process holds {found}")
    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    values = driver.check()
    checks = {k: {"value": _finite(v), "limit": cell.limits[k]}
              for k, v in values.items()}
    correct = window.failed == 0 and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    result = {"correct": bool(correct), "attempted": int(window.attempted),
              "failed": int(window.failed)}
    dev = chip.device_record(device, cell.chips, peak)
    if trace:
        data = tracer.data
        data.readings = window.readings
        print(f"trace: {data.events} profiler events read in "
              f"{data.digest_s:.1f} s", file=sys.stderr)
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"]).read(data, m, cell)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev.update(busy_s=data.busy_s, window_s=data.window_s)
        result.update(metrics=metrics, device=dev, breakdown=data.breakdown())
    else:
        e2e = dict(window.end_to_end, setup_s=setup_s)
        result.update(metrics={m["name"]: {"value": e2e[m["name"]],
                                           "unit": m["unit"]}
                               for m in cell.end_to_end},
                      device=dev)
    result["checks"] = checks
    return result
