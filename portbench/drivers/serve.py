"""Serving traffic: a closed loop of clients over ``MicroBatcher``.

Set-up freezes the configuration on the harness's weights (``freeze``
with ``plane_dtype``), builds an ``InferenceEngine`` over ``buckets``
and warms every bucket, then starts a ``MicroBatcher`` with
``max_wait_ms``.  In the window each of ``clients`` clients submits one
image, waits for its answer and submits the next, until the window
closes; image ``c + clients * k`` of a host pool is client c's k-th.
Every request is timed from its submit to its answer.

A client is not a thread: its next request is submitted from its
answer's completion callback.  Clients stand for callers outside the
server's process, and 64 threads of their own in that process would
make the server's worker wait for the interpreter lock (the first full
sets on the card spread by 18% in p95 that way).

The check recomputes a sample of the answered requests, drawn from the
seed, with the reference on each request's own image, so an answer
handed to the wrong request fails it.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from portbench.counts import donn as counts
from portbench.drivers import Window
from portbench.harness import images, program, seeds
from portbench.reference import donn as ref

FAULTS = ("answer",)
ANSWER_WAIT_S = 60.0  # an answer later than this never came


def span_metrics(traffic: dict) -> dict:
    """Every batch waits in the queue and runs on the host
    (``drivers/__init__.py``); its launches are read from the card's
    trace alone."""
    return {"serve.queue_wait_ms": True, "serve.serial_host_ms": True,
            "serve.launches_per_batch": False}


class Driver:
    def __init__(self, cell, seed: int, device, tracer, fault=None):
        if fault not in (None,) + FAULTS:
            raise ValueError(f"no fault {fault!r} for serving")
        self.cell, self.seed, self.fault = cell, int(seed), fault
        self.device = torch.device(device)
        self.tracer = tracer
        self.t = cell.traffic
        self.cfg = cell.config
        self.clients = int(self.t["clients"])

    def setup(self) -> None:
        from repro_torch.core.models import build_model
        from repro_torch.runtime.inference import (
            InferenceEngine, MicroBatcher, freeze,
        )

        t, c = self.t, self.cfg
        self.pool, _ = images.glyphs(int(t["pool"]), self.seed, stream=2,
                                     size=c["input_size"],
                                     classes=c["num_classes"],
                                     power=float(t["power"]))
        model = build_model(program.donn_config(c), device=self.device)
        params = program.as_params(program.phases(
            self.seed, 0, (c["depth"], c["n"], c["n"]), self.device))
        deployed = freeze(model, params, plane_dtype=t["plane_dtype"],
                          device=self.device)
        self.engine = InferenceEngine(deployed, buckets=t["buckets"],
                                      device=self.device)
        if self.fault == "answer":  # each answer goes to its neighbour
            infer = self.engine.infer
            self.engine.infer = lambda x: np.roll(infer(x), 1, axis=0)
        self.engine.warmup()
        self.batcher = MicroBatcher(self.engine,
                                    max_wait_ms=float(t["max_wait_ms"]))
        futures = [self.batcher.submit(self.pool[i])
                   for i in range(2 * self.clients)]
        for f in futures:
            f.result(timeout=ANSWER_WAIT_S)

    def _send(self, c: int, k: int) -> None:
        """Client c's k-th request; its answer sends the next."""
        i = (c + self.clients * k) % len(self.pool)
        t0 = time.perf_counter()
        try:
            future = self.batcher.submit(self.pool[i])
        except Exception:  # noqa: BLE001 - a refused request is counted
            self._answered(c, k, i, t0, None)
            return
        future.add_done_callback(
            lambda f: self._answered(c, k, i, t0, f))

    def _answered(self, c: int, k: int, i: int, t0: float, future) -> None:
        t1 = time.perf_counter()
        out = None
        if future is not None and future.exception() is None:
            out = future.result()
        self.log.append((i, t0, t1, out))
        if out is not None and t1 < self.end:
            self._send(c, k + 1)
            return
        with self._lock:
            self._active -= 1
            if self._active == 0:
                self._idle.set()

    def run(self, seconds: float) -> Window:
        stats0 = dict(self.engine.stats)
        self.log = []
        self._lock = threading.Lock()
        self._idle = threading.Event()
        self._active = self.clients
        self.end = time.perf_counter() + seconds
        for c in range(self.clients):
            self._send(c, 0)
        if not self._idle.wait(seconds + 2 * ANSWER_WAIT_S):
            raise RuntimeError("a client's answer never came")
        program.sync(self.device)
        answered = [r for r in self.log if r[3] is not None]
        in_window = sum(r[2] <= self.end for r in answered)
        lat_ms = np.array([(r[2] - r[1]) * 1e3 for r in self.log])
        c = self.cfg
        flops = counts.forward_flops(c["n"], c["depth"], c["num_classes"],
                                     c["det_size"])
        stats = {k: self.engine.stats[k] - stats0[k] for k in stats0}
        return Window(
            attempted=len(self.log), failed=len(self.log) - len(answered),
            end_to_end={"serve_req_s": in_window / seconds,
                        "serve_p95_ms": float(np.percentile(lat_ms, 95))},
            readings={"requests": stats["requests"],
                      "batches": stats["batches"],
                      "model_flops": len(answered) * flops})

    def release(self) -> None:
        if not self.batcher.close():
            raise RuntimeError("the MicroBatcher did not drain")
        self.batcher = self.engine = None

    def check(self) -> dict:
        answered = [r for r in self.log if r[3] is not None]
        r = seeds.rng(self.seed, seeds.SAMPLE)
        take = min(int(self.t["sample_requests"]), len(answered))
        if take == 0:
            return {"out_gap": float("inf")}
        sample = [answered[i] for i in r.choice(len(answered), take,
                                                replace=False)]
        c = self.cfg
        model = ref.Classifier(c, self.device)
        phases = program.phases(self.seed, 0, (c["depth"], c["n"], c["n"]),
                                self.device)
        x = torch.from_numpy(self.pool[[s[0] for s in sample]]).to(self.device)
        want = model.infer(phases, x).cpu()
        got = torch.from_numpy(np.stack([s[3] for s in sample]))
        return {"out_gap": program.row_gap(got, want)}
