"""DONN serving launcher on the card: freeze a model, serve a request stream.

The port of ``repro.launch.serve_donn`` for ``--family classify``: builds
a DONN with random phases from ``--seed``, freezes it into a
``DeployedDONN`` (codesign response + modulation planes folded once),
warms every bucket, then drives a synthetic request load through the
micro-batching dispatcher and reports requests/sec plus latency
percentiles, and the shed/expired counts when the resilience knobs engage.

The flags are the reference's.  Training before freezing
(``--train-steps``), artifacts (``--artifact``/``--save-artifact``),
multi-device dispatch and the replica fleet come with later slices and
raise ``NotImplementedError``.  ``--device`` defaults to the CUDA card.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve_donn --n 200 --depth 5 \
      --distance 0.30 --det-size 20 --use-pallas --requests 256
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.core.config import DONNConfig
from repro_torch.core.models import build_model
from repro_torch.device import resolve_device
from repro_torch.runtime.inference import (
    DEFAULT_BUCKETS,
    InferenceEngine,
    MicroBatcher,
    freeze,
)
from repro_torch.runtime.resilience import (
    DeadlineExceededError,
    OverloadedError,
)


def build_cfg(args) -> DONNConfig:
    if args.family != "classify":
        raise NotImplementedError(
            f"--family {args.family} comes with the RGB/segmentation slice"
        )
    return DONNConfig(
        name=f"serve-{args.family}", n=args.n, depth=args.depth,
        distance=args.distance, det_size=args.det_size,
        codesign=args.codesign, response_gamma=args.response_gamma,
        use_pallas=args.use_pallas,
    )


def _refuse_later_slices(args) -> None:
    later = [
        (args.train_steps > 0, "--train-steps", "training"),
        (args.artifact is not None, "--artifact", "persistence"),
        (args.save_artifact is not None, "--save-artifact", "persistence"),
        (args.mesh_devices > 1, "--mesh-devices", "multi-device"),
        (args.replicas > 0, "--replicas", "fleet"),
    ]
    for hit, flag, slice_name in later:
        if hit:
            raise NotImplementedError(
                f"{flag} comes with the {slice_name} slice of the port"
            )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="classify",
                    choices=("classify", "rgb", "segmentation"))
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--distance", type=float, default=0.05)
    ap.add_argument("--det-size", type=int, default=8)
    ap.add_argument("--codesign", default="qat")
    ap.add_argument("--response-gamma", type=float, default=1.2,
                    help="nonlinear device response (1.0 = ideal)")
    ap.add_argument("--use-pallas", action="store_true",
                    help="run the hand-written kernels (the reference's name)")
    ap.add_argument("--train-steps", type=int, default=0,
                    help="quick-train before freezing (training slice)")
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--buckets", default=",".join(map(str, DEFAULT_BUCKETS)))
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--max-queue", type=int, default=1024,
                    help="admission bound: beyond this, requests are shed "
                         "with OverloadedError (0 = unbounded)")
    ap.add_argument("--timeout-ms", type=float, default=0.0,
                    help="per-request deadline: undispatched requests fail "
                         "with DeadlineExceededError (0 = none)")
    ap.add_argument("--no-validate", action="store_true",
                    help="skip submit-time shape/dtype validation")
    ap.add_argument("--artifact", default=None,
                    help="serve from a saved artifact dir (persistence slice)")
    ap.add_argument("--save-artifact", default=None,
                    help="persist the frozen deployment (persistence slice)")
    ap.add_argument("--mesh-devices", type=int, default=0,
                    help="data-parallel dispatch over N devices (0 = off)")
    ap.add_argument("--replicas", type=int, default=0,
                    help="serve through a replica fleet (0 = single "
                         "MicroBatcher)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (the CUDA card unless asked)")
    args = ap.parse_args(argv)
    _refuse_later_slices(args)
    device = resolve_device(args.device)

    cfg = build_cfg(args)
    model = build_model(cfg, device=device)
    params = model.init(torch.Generator().manual_seed(args.seed))
    t0 = time.perf_counter()
    deployed = freeze(model, params, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t_freeze = time.perf_counter() - t0
    buckets = tuple(int(b) for b in args.buckets.split(","))
    engine = InferenceEngine(deployed, buckets=buckets, device=device)
    compiles = engine.warmup()
    print(f"[serve_donn] froze {cfg.name} in {t_freeze * 1e3:.0f}ms; "
          f"warmed {len(compiles)} buckets in "
          f"{sum(compiles.values()):.2f}s on {device}")

    rng = np.random.default_rng(args.seed)
    n = cfg.input_size
    reqs = [rng.random((n, n), dtype=np.float32)
            for _ in range(args.requests)]
    mb = MicroBatcher(engine, max_wait_ms=args.max_wait_ms,
                      max_queue=args.max_queue or None,
                      validate=not args.no_validate)
    timeout_ms = args.timeout_ms or None
    lat, shed, expired = [], 0, 0
    t0 = time.perf_counter()
    futs = []
    for x in reqs:
        try:
            futs.append((time.perf_counter(),
                         mb.submit(x, timeout_ms=timeout_ms)))
        except OverloadedError:
            shed += 1
    for t_sub, f in futs:
        try:
            f.result(timeout=120)
            lat.append(time.perf_counter() - t_sub)
        except DeadlineExceededError:
            expired += 1
    dt = time.perf_counter() - t0
    clean = mb.close()

    lat_ms = np.sort(np.asarray(lat)) * 1e3
    p50 = lat_ms[len(lat_ms) // 2]
    p99 = lat_ms[min(len(lat_ms) - 1, int(len(lat_ms) * 0.99))]
    rps = len(lat) / dt
    print(f"[serve_donn] {len(lat)}/{args.requests} requests served in "
          f"{dt:.2f}s ({rps:.1f} req/s; p50 {p50:.1f}ms p99 {p99:.1f}ms; "
          f"shed {shed}, expired {expired}; "
          f"{engine.stats['batches']} batches, "
          f"{engine.stats['padded_rows']} padded rows, "
          f"clean_close={clean})")
    return rps


if __name__ == "__main__":
    main()
