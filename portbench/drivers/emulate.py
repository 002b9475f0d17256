"""Design-space emulation traffic: ``emulate_batch`` on candidate sets.

Each call scores ``candidates`` geometries of one configuration on
``batch`` images and reads each candidate's predicted classes back.

- ``fresh_sets: true`` (a sweep): set i draws its geometries from the
  seed (unit size and distance uniform on the traffic's ranges, never
  repeating) and its own phases for every candidate, and is scored on
  the ``validation_images`` in ``calls_per_set`` calls; then set i + 1.
  Every set pays the port's build of its transfer planes, one
  ``transfer_planes`` launch on the card.
- ``fresh_sets: false`` (a shortlist): one set drawn at set-up, scored
  on fresh images from a host pool every call.

The check recomputes a sample of the window's calls, drawn from the
seed, with the reference: geometries and phases made again from the
seed, transfer planes and detector built by the reference itself.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from portbench.counts import donn as counts
from portbench.drivers import Window
from portbench.harness import images, program, seeds
from portbench.reference import donn as ref

FAULTS = ("answer",)
WARM_SET = -1  # the set drawn only to warm up


def span_metrics(traffic: dict) -> dict:
    """A sweep builds every set's inputs, and reads the preparation of a
    call that finds them built only from a set's second call on; a
    shortlist finds them built at every call (``drivers/__init__.py``)."""
    if traffic["fresh_sets"]:
        return {"dse.inputs_build_ms": True, "dse.prep_ms": False}
    return {"dse.prep_ms": True}


class Driver:
    def __init__(self, cell, seed: int, device, tracer, fault=None):
        if fault not in (None,) + FAULTS:
            raise ValueError(f"no fault {fault!r} for emulation")
        self.cell, self.seed, self.fault = cell, int(seed), fault
        self.device = torch.device(device)
        self.tracer = tracer
        self.t = cell.traffic
        self.cfg = cell.config
        self.K = int(self.t["candidates"])
        self.B = int(self.t["batch"])

    # --- candidate sets ---
    def _geometry(self, set_id: int) -> list:
        """[(pixel_size, distance)] of each candidate of a set."""
        g = self.t["geometry"]
        r = seeds.rng(self.seed, seeds.GEOMETRY, set_id + 1)
        dx = r.uniform(*g["pixel_size"], self.K)
        z = r.uniform(*g["distance"], self.K)
        return [(float(a), float(b)) for a, b in zip(dx, z)]

    def _phases(self, set_id: int) -> torch.Tensor:
        c = self.cfg
        return program.phases(self.seed, set_id + 1,
                              (self.K, c["depth"], c["n"], c["n"]),
                              self.device)

    def _candidates(self, set_id: int):
        geo = self._geometry(set_id)
        cfgs = [dataclasses.replace(self.base, name=f"set{set_id}-{k}",
                                    pixel_size=dx, distance=z)
                for k, (dx, z) in enumerate(geo)]
        stack = self._phases(set_id)
        return cfgs, [program.as_params(p) for p in stack]

    def _inputs(self, call: int) -> np.ndarray:
        """The images of a set's (sweep) or the window's (shortlist) call."""
        lo = (call * self.B) % len(self.pool)
        return self.pool[lo:lo + self.B]

    # --- the port ---
    def _call(self, cfgs, params, x) -> torch.Tensor:
        from repro_torch.core.models import emulate_batch

        out = emulate_batch(cfgs, params, x, device=self.device)
        if self.fault == "answer":  # each candidate gets another's answer
            out = out.flip(0)
        return out

    def setup(self) -> None:
        import warnings

        from repro_torch.core.physics import PhysicsWarning

        # band-limit warnings name every collapsed geometry of a sweep
        warnings.simplefilter("ignore", PhysicsWarning)
        t, c = self.t, self.cfg
        self.base = program.donn_config(c)
        self.fresh = bool(t["fresh_sets"])
        n_img = int(t["validation_images"] if self.fresh else t["pool"])
        self.pool, _ = images.glyphs(n_img, self.seed, stream=1,
                                     size=c["input_size"],
                                     classes=c["num_classes"],
                                     power=float(t["power"]))
        if self.fresh and n_img != int(t["calls_per_set"]) * self.B:
            raise ValueError("a sweep scores each set on the validation "
                             "images: calls_per_set * batch of them")
        warm = self._candidates(WARM_SET if self.fresh else 0)
        self.warm_calls = int(t["warmup_calls"])
        for call in range(self.warm_calls):
            self._call(*warm, self._inputs(call)).argmax(-1).cpu()
        self.fixed = None if self.fresh else warm

    def run(self, seconds: float) -> Window:
        from repro_torch.core.propagation import tf_cache_stats

        sp = self.tracer.span
        per_set = int(self.t["calls_per_set"])
        self.outputs = {}  # (set, call) -> (K, B, classes) on the device
        times: dict = {}   # set -> [seconds a call]
        misses0 = tf_cache_stats()["misses"]
        start = time.perf_counter()
        end = start + seconds
        calls = 0
        set_id, cands = 0, self.fixed
        while time.perf_counter() < end:
            # a shortlist's images go on past those that warmed it up
            call = calls % per_set if self.fresh else self.warm_calls + calls
            if self.fresh and call == 0:
                set_id = calls // per_set
                with sp("dse.candidates"):
                    cands = self._candidates(set_id)
            x = self._inputs(call)
            t0 = time.perf_counter()
            with sp("dse.call"):
                out = self._call(*cands, x)
            with sp("dse.readback"):
                out.argmax(-1).cpu()
            times.setdefault(set_id, []).append(time.perf_counter() - t0)
            self.outputs[(set_id, call)] = out
            calls += 1
        elapsed = time.perf_counter() - start
        c = self.cfg
        rows = calls * self.K * self.B
        flops = counts.forward_flops(c["n"], c["depth"], c["num_classes"],
                                     c["det_size"])
        return Window(
            attempted=calls, failed=0,
            end_to_end={"emulate_samples_per_s": rows / elapsed},
            readings={"set_call_s": list(times.values()),
                      "tf_misses": tf_cache_stats()["misses"] - misses0,
                      "sets": len(times), "model_flops": rows * flops})

    def release(self) -> None:
        from repro_torch.core.models import clear_emulation_caches

        self.fixed = None
        self.outputs = {k: v.cpu() for k, v in self.outputs.items()}
        clear_emulation_caches()  # the port's stacked planes of each set

    # --- the comparison ---
    def check(self) -> dict:
        keys = sorted(self.outputs)
        r = seeds.rng(self.seed, seeds.SAMPLE)
        take = min(int(self.t["sample_calls"]), len(keys))
        sample = [keys[i] for i in sorted(r.choice(len(keys), take,
                                                    replace=False))]
        worst, current = 0.0, None
        for set_id, call in sample:
            if set_id != current:  # the sample is in set order
                current = set_id
                models = [ref.Classifier(self.cfg, self.device, pixel_size=dx,
                                         distance=z)
                          for dx, z in self._geometry(set_id)]
                phases = self._phases(set_id)
            x = torch.from_numpy(self._inputs(call)).to(self.device)
            want = torch.stack([m.infer(p, x) for m, p in zip(models, phases)])
            worst = max(worst, program.row_gap(self.outputs[(set_id, call)],
                                               want.cpu()))
        return {"out_gap": worst}
