#!/usr/bin/env python3
"""Why replicas in threads lose throughput on one card, and what a CUDA
stream an engine would buy them.

    PYTHONPATH=src python scripts/fleet_threads.py [--window 3] [--repeats 2]

Serves frozen ``donn-mnist-5l`` (f32 planes, ``use_pallas``) at bucket 32
on the CUDA card:

1. R engines in R threads of one process (R = 1, 2, 4), full batches back
   to back, no router, at interpreter switch intervals of 5 ms (the
   default), 0.5 ms and 0.05 ms: req/s over all threads, per-batch
   p50/p99, and the process's CPU seconds a batch;
2. the same at 5 ms with each engine on a CUDA stream of its own, ordered
   after the caller's stream before each batch (``_OwnStreamEngine``; the
   port's engines share the default stream);
3. ``MicroBatcher`` over one engine and ``FleetRouter`` over R engines,
   128 requests in flight from one submitting thread: req/s and
   per-request p50/p99, with the engines on the default stream and again
   each on its own stream;
4. R engines in R processes (``spawn``), each its own interpreter, started
   together behind a barrier: summed req/s.

Rows are interleaved, ``--repeats`` times.  If threads lose where
processes do not, the shared interpreter lock (handed over at every
PyTorch call of a batch) is what holds the replicas back.  Every line
names the card and its power limit.  Needs the card; every process it
starts is joined before it exits.
"""
from __future__ import annotations

import argparse
import dataclasses
import multiprocessing as mp
import os
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.models import build_model  # noqa: E402
from repro_torch.runtime.fleet import FleetRouter  # noqa: E402
from repro_torch.runtime.inference import (  # noqa: E402
    InferenceEngine, MicroBatcher, freeze,
)

REPLICAS = (1, 2, 4)
SWITCH_S = (5e-3, 5e-4, 5e-5)
IN_FLIGHT = 128  # requests kept in flight in a router row


class _OwnStreamEngine(InferenceEngine):
    """An engine whose batches run on a CUDA stream of its own, ordered
    after the caller's stream (the design measured against)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.stream = torch.cuda.Stream(self.device)

    def _run(self, xp):
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            return self.deployed.forward(
                torch.from_numpy(xp).to(self.device)).cpu()


def _deployment(dev):
    cfg = dataclasses.replace(get_config("donn-mnist-5l"), use_pallas=True)
    model = build_model(cfg, device=dev)
    return freeze(model, model.init(torch.Generator().manual_seed(0)),
                  device=dev)


def _batch():
    return np.random.default_rng(1).random((32, 28, 28), np.float32)


def _serve_loop(engine, x, t_end, lat):
    while time.perf_counter() < t_end:
        t0 = time.perf_counter()
        engine.infer(x)
        lat.append(time.perf_counter() - t0)


def threads_row(engines, x, window_s: float) -> dict:
    lat = [[] for _ in engines]
    t_end = time.perf_counter() + window_s
    threads = [threading.Thread(target=_serve_loop,
                                args=(e, x, t_end, lat[i]))
               for i, e in enumerate(engines)]
    cpu0, t0 = time.process_time(), time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=window_s + 60)
        if t.is_alive():
            raise RuntimeError("a serving thread did not finish")
    wall, cpu = time.perf_counter() - t0, time.process_time() - cpu0
    ms = np.concatenate([np.asarray(v) for v in lat]) * 1e3
    return dict(req_s=len(ms) * len(x) / wall, p50=np.percentile(ms, 50),
                p99=np.percentile(ms, 99), cpu_ms=cpu / len(ms) * 1e3)


def router_row(submit, xs, window_s: float) -> dict:
    """IN_FLIGHT requests kept in flight by one submitting thread."""
    sem = threading.Semaphore(IN_FLIGHT)
    lat, errors = [], []

    def done(fut, t0):
        (lat.append(time.perf_counter() - t0) if fut.exception() is None
         else errors.append(fut.exception()))
        sem.release()

    n, t_start = 0, time.perf_counter()
    while time.perf_counter() < t_start + window_s:
        sem.acquire()
        t0 = time.perf_counter()
        submit(xs[n % len(xs)]).add_done_callback(
            lambda f, t0=t0: done(f, t0))
        n += 1
    for _ in range(IN_FLIGHT):
        sem.acquire()
    wall = time.perf_counter() - t_start
    if errors or len(lat) != n:
        raise RuntimeError(f"router row: {len(errors)} failed, "
                           f"{n - len(lat)} not served")
    ms = np.asarray(lat) * 1e3
    return dict(req_s=n / wall, p50=np.percentile(ms, 50),
                p99=np.percentile(ms, 99))


def _process_worker(barrier, out, window_s: float) -> None:
    dev = torch.device("cuda", 0)
    engine = InferenceEngine(_deployment(dev), buckets=(32,), device=dev)
    engine.warmup()
    x = _batch()
    barrier.wait(timeout=300)
    lat = []
    _serve_loop(engine, x, time.perf_counter() + window_s, lat)
    out.put(len(lat) * len(x) / window_s)


def processes_row(ctx, r: int, window_s: float) -> float:
    barrier, out = ctx.Barrier(r), ctx.Queue()
    procs = [ctx.Process(target=_process_worker,
                         args=(barrier, out, window_s)) for _ in range(r)]
    for p in procs:
        p.start()
    try:
        rates = [out.get(timeout=600) for _ in procs]  # drain, then join
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    return float(sum(rates))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--window", type=float, default=3.0)
    ap.add_argument("--repeats", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fleet_threads: needs the CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    dev = torch.device("cuda", 0)
    dep = _deployment(dev)
    engines = {kind: [cls(dep, buckets=(32,), device=dev)
                      for _ in range(max(REPLICAS))]
               for kind, cls in (("default stream", InferenceEngine),
                                 ("own streams", _OwnStreamEngine))}
    for e in engines["default stream"] + engines["own streams"]:
        e.warmup()
    x = _batch()
    xs = np.random.default_rng(2).random((256, 28, 28), np.float32)
    servers = []
    for kind, engs in engines.items():
        servers.append((f"MicroBatcher, 1 engine, {kind}",
                        MicroBatcher(engs[0], max_wait_ms=2.0,
                                     max_queue=None)))
        servers += [(f"FleetRouter, {r} replica(s), {kind}",
                     FleetRouter(engs[:r], max_queue=None, seed=0))
                    for r in REPLICAS]
    ctx = mp.get_context("spawn")
    old = sys.getswitchinterval()
    try:
        for rep in range(args.repeats):
            rows = [(sw, "default stream") for sw in SWITCH_S]
            rows.append((old, "own streams"))
            for sw, kind in rows:
                sys.setswitchinterval(sw)
                for r in REPLICAS:
                    engs = engines[kind][:r]
                    threads_row(engs, x, 0.3)
                    m = threads_row(engs, x, args.window)
                    print(f"[threads] repeat {rep + 1}: {r} thread(s), "
                          f"switch interval {sw * 1e3:g} ms, {kind}: "
                          f"{m['req_s']:.1f} req/s, per-batch p50 "
                          f"{m['p50']:.3f} ms p99 {m['p99']:.3f} ms, CPU "
                          f"{m['cpu_ms']:.3f} ms a batch ({smi})")
            sys.setswitchinterval(old)
            for label, srv in servers:
                router_row(srv.submit, xs, 0.3)
                m = router_row(srv.submit, xs, args.window)
                print(f"[router] repeat {rep + 1}: {label}: "
                      f"{m['req_s']:.1f} req/s, {IN_FLIGHT} in flight, "
                      f"p50 {m['p50']:.3f} ms p99 {m['p99']:.3f} ms "
                      f"({smi})")
            for r in REPLICAS:
                rate = processes_row(ctx, r, args.window)
                print(f"[processes] repeat {rep + 1}: {r} process(es): "
                      f"{rate:.1f} req/s summed ({smi})")
    finally:
        sys.setswitchinterval(old)
        closed = [srv.close() for _, srv in servers]
    if not all(closed):
        raise RuntimeError("a router row did not close cleanly")
    return 0


if __name__ == "__main__":
    sys.exit(main())
