"""DONN serving launcher on the card: train, freeze, serve a request stream.

The port of ``repro.launch.serve_donn``: builds a DONN of ``--family``
classify, rgb (3 channels) or segmentation (optical skip from layer 0,
train-time layer norm) with random phases from ``--seed``, optionally
quick-trains a classify model on the synthetic digits (``--train-steps
N``: ``synth_digits(512, seed)``, batch 32, AdamW at lr 0.3, 8 steps per
chunk, classify only, as the reference), freezes it into a
``DeployedDONN`` (codesign response + modulation planes folded once),
warms every bucket, then drives a synthetic request load — (n, n)
images, (3, n, n) for rgb — through the micro-batching dispatcher and
reports requests/sec plus latency percentiles, and the shed/expired
counts when the resilience knobs engage.

Artifact flow (``repro_torch.runtime.resilience``): ``--save-artifact
DIR`` persists the frozen deployment after freezing; ``--artifact DIR``
cold-starts serving from a saved artifact (the port's or the JAX
package's) with no model build, training or freezing.  The artifact's
format and architecture spec are validated before anything is loaded or
warmed: a bad artifact exits with code 2.  ``--replicas N`` serves
through the continuous-batching ``FleetRouter`` (``runtime.fleet``) over
N engines on the one device instead of the single-engine ``MicroBatcher``
(on one card the replicas share one interpreter lock and serve fewer
requests a second than one engine: for failover and warm swap, not
throughput).

``--mesh-devices k`` serves data-parallel over k ranks
(``InferenceEngine(mesh_devices=k)``).  Under a process group the command
runs as its ranks: rank 0 takes the requests and broadcasts each batch
it serves, and the other ranks serve the same batches with it.  Without a
group it spawns the k ranks itself: one a card on CUDA (more ranks than
cards is refused), k gloo ranks with ``--device cpu``.

The flags are the reference's; ``--device`` defaults to the CUDA card.

Examples:
  PYTHONPATH=src python -m repro_torch.launch.serve_donn --n 200 --depth 5 \
      --distance 0.30 --det-size 20 --use-pallas --train-steps 16 \
      --requests 256 --save-artifact /path/to/artifact
  PYTHONPATH=src python -m repro_torch.launch.serve_donn \
      --artifact /path/to/artifact --replicas 2 --requests 256
"""
from __future__ import annotations

import argparse
import sys
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

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
    load_deployed,
    save_deployed,
    validate_artifact,
)


def build_cfg(args) -> DONNConfig:
    kw = dict(
        name=f"serve-{args.family}", n=args.n, depth=args.depth,
        distance=args.distance, det_size=args.det_size,
        codesign=args.codesign, response_gamma=args.response_gamma,
        use_pallas=args.use_pallas,
    )
    if args.family == "rgb":
        kw["channels"] = 3
    elif args.family == "segmentation":
        kw.update(segmentation=True, skip_from=0, layer_norm=True)
    return DONNConfig(**kw)


def _spawn_ranks(args, argv) -> float:
    """Serve on ``--mesh-devices`` spawned ranks; rank 0's req/s."""
    from repro_torch.runtime.collectives import spawn_ranks

    k, dev = args.mesh_devices, torch.device(args.device)
    if dev.type == "cuda" and k > torch.cuda.device_count():
        raise ValueError(f"--mesh-devices {k} needs {k} cards, have "
                         f"{torch.cuda.device_count()}")
    return spawn_ranks(_rank_main, k, (list(argv),), device_type=dev.type,
                       timeout=3600.0)[0]


def _rank_main(rank, argv):
    return main(argv)


class _Leader:
    """Rank 0's engine under a mesh: each ``infer`` is broadcast first, so
    the other ranks (``_follow``) serve the same batch with it; a lock
    keeps the broadcasts in the order the batches are served."""

    def __init__(self, engine, index: int, lock: threading.Lock):
        self._engine, self._index, self._lock = engine, index, lock

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def infer(self, x):
        with self._lock:
            dist.broadcast_object_list([(self._index, np.asarray(x))], src=0)
            return self._engine.infer(x)


def _receive():
    """What rank 0 broadcasts next: (engine index, batch), or None."""
    msg = [None]
    dist.broadcast_object_list(msg, src=0)
    return msg[0]


def _follow(engines) -> None:
    """A rank other than 0: serve what rank 0 broadcasts until None.  A
    batch that fails here fails on rank 0 too, which reports it."""
    for index, x in iter(_receive, None):
        try:
            engines[index].infer(x)
        except Exception:  # noqa: BLE001 - rank 0 reports the request
            pass


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
                    help="quick-train on synth digits before freezing")
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
                    help="serve from a saved artifact dir (skips build/"
                         "train/freeze entirely)")
    ap.add_argument("--save-artifact", default=None,
                    help="persist the frozen deployment to this dir")
    ap.add_argument("--mesh-devices", type=int, default=0,
                    help="data-parallel dispatch over N devices (0 = off)")
    ap.add_argument("--replicas", type=int, default=0,
                    help="serve through a continuous-batching FleetRouter "
                         "over N replicas (0 = single MicroBatcher)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device (the CUDA card unless asked)")
    args = ap.parse_args(argv)
    if args.mesh_devices > 1 and not dist.is_initialized():
        return _spawn_ranks(args, sys.argv[1:] if argv is None else argv)
    if args.artifact:
        # format and architecture spec checked before anything is loaded
        # or warmed, so a bad artifact exits cleanly instead of mid-deploy
        try:
            meta = validate_artifact(args.artifact)
        except (FileNotFoundError, ValueError) as e:
            print(f"[serve_donn] ERROR: artifact {args.artifact!r} failed "
                  f"pre-deploy validation: {e}", file=sys.stderr)
            sys.exit(2)
    device = resolve_device(args.device)

    if args.artifact:
        t0 = time.perf_counter()
        deployed = load_deployed(args.artifact, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_freeze = time.perf_counter() - t0
        print(f"[serve_donn] cold-started from {args.artifact} "
              f"(format {meta['format']}, family {meta['family']!r}) in "
              f"{t_freeze * 1e3:.0f}ms on {device} (no training state "
              "touched)")
        cfg = deployed.cfg
    else:
        cfg = build_cfg(args)
        model = build_model(cfg, device=device)
        params = model.init(torch.Generator().manual_seed(args.seed))
        if args.train_steps > 0 and args.family == "classify":
            from repro_torch.core.train_utils import train_classifier
            from repro_torch.data.synthetic import (
                batch_iterator, synth_digits,
            )

            xs, ys = synth_digits(512, seed=args.seed)
            res = train_classifier(model, params,
                                   batch_iterator(xs, ys, 32, seed=1),
                                   steps=args.train_steps, lr=0.3,
                                   steps_per_call=8)
            params = res.params
            print(f"[serve_donn] trained {args.train_steps} steps "
                  f"({res.wall_time_s:.1f}s, final loss "
                  f"{res.losses[-1]:.4f})")
        t0 = time.perf_counter()
        deployed = freeze(model, params, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_freeze = time.perf_counter() - t0
    if args.save_artifact and (not dist.is_initialized()
                               or dist.get_rank() == 0):
        save_deployed(deployed, args.save_artifact)
        print(f"[serve_donn] saved artifact to {args.save_artifact}")
    buckets = tuple(int(b) for b in args.buckets.split(","))
    n_replicas = max(args.replicas, 0)
    engines = []
    for _ in range(n_replicas or 1):
        engine = InferenceEngine(deployed, buckets=buckets, device=device,
                                 mesh_devices=args.mesh_devices or None)
        compiles = engine.warmup()  # every bucket before any traffic
        engines.append(engine)
    if dist.is_initialized():
        if dist.get_rank() != 0:
            _follow(engines)
            return None
        lock = threading.Lock()
        engines = [_Leader(e, i, lock) for i, e in enumerate(engines)]
        try:
            return _serve(args, cfg, deployed, engines, t_freeze, compiles)
        finally:
            dist.broadcast_object_list([None], src=0)
    return _serve(args, cfg, deployed, engines, t_freeze, compiles)


def _serve(args, cfg, deployed, engines, t_freeze, compiles) -> float:
    """Drive the synthetic request stream through the dispatcher."""
    n_replicas = max(args.replicas, 0)
    device = engines[0].device
    engine = engines[0]
    verb = "loaded" if args.artifact else "froze"
    print(f"[serve_donn] {verb} {cfg.name} in {t_freeze * 1e3:.0f}ms; "
          f"warmed {len(compiles)} buckets x{len(engines)} replica(s) in "
          f"{sum(compiles.values()):.2f}s on {device}")

    rng = np.random.default_rng(args.seed)
    n = cfg.input_size
    shape = ((cfg.channels, n, n) if deployed.family == "multi" else (n, n))
    reqs = [rng.random(shape, dtype=np.float32)
            for _ in range(args.requests)]
    if n_replicas:
        from repro_torch.runtime.fleet import FleetRouter

        mb = FleetRouter(engines, max_queue=args.max_queue or None,
                         validate=not args.no_validate)
        print(f"[serve_donn] continuous-batching fleet: "
              f"{n_replicas} replica(s)")
    else:
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
          f"{sum(e.stats['batches'] for e in engines)} batches, "
          f"{sum(e.stats['padded_rows'] for e in engines)} padded rows, "
          f"mesh={args.mesh_devices or 1}, replicas={n_replicas or 1}, "
          f"clean_close={clean})")
    return rps


if __name__ == "__main__":
    main()
