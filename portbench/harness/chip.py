"""The card a run measures, the process's age, and the modules the run
must not hold."""
from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

# top-level module names the measured process may not import: JAX and the
# JAX package the port was made from (``repro_torch`` is not ``repro``)
FOREIGN = ("jax", "jaxlib", "flax", "repro")


def foreign_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is foreign."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FOREIGN))


def process_start() -> float:
    """``time.perf_counter()``'s reading when this process started."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        age = time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError):
        age = 0.0
    return time.perf_counter() - age


def power_limit_w():
    """The card's power limit from ``nvidia-smi``, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def device_record(device, chips: int, peak: int) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": int(chips), "memory_peak_bytes": int(peak),
            "power_limit_w": power_limit_w()}
