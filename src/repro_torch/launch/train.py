"""Fault-tolerant LM training launcher (port of ``repro.launch.train``).

Trains any registered architecture (reduced or full config) on one
device or over a ``(data, model)`` mesh, with the reference's flags and
behaviour:
- checkpoint/restart: atomic checkpoints every --ckpt-every steps in the
  reference's on-disk format, automatic resume from LATEST (a state the
  JAX package saved resumes here too);
- preemption safety: SIGTERM/SIGINT triggers save-and-exit(143);
- non-finite guardrail: a NaN/inf loss waits for the in-flight save, rolls
  the run back to the last good checkpoint and replays the data stream
  (bounded by --max-rollbacks; without a checkpoint to return to, the run
  aborts instead of training on garbage);
- straggler monitoring: per-step EMA + z-score flags;
- background prefetch of the deterministic synthetic token stream, the
  host-to-device copy done by the prefetch thread.

Parameters are random, drawn on the device from a ``torch.Generator``
seeded with --seed; masters and AdamW moments are float32 and the matmuls
run in the config's dtype.  A vlm batch carries the reference's vision
stub: ``np.random.default_rng(0).normal(0, 1, (batch, vision_seq,
d_model))`` in float32, the same array every step (put on the device
once).  ``--device`` defaults to the CUDA card.
``--metrics-out`` writes the reference's ``losses`` and ``stragglers``
and, beside them, each step's seconds as the monitor timed it
(``step_seconds``, in the order run).

``--mesh DxM`` trains over D*M ranks (``runtime.steps.compile_train_step``
on a mesh): each rank draws the parameters leaf by leaf and keeps its
blocks, cuts its block of every batch, saves through rank 0 and restores
its blocks from a checkpoint any mesh wrote (so a run resumes on another
mesh).  Without a process group the launcher spawns its ranks (NCCL, one
a card, when there are D*M cards; else gloo ranks sharing the card, which
it prints) and forwards SIGTERM/SIGINT to them; the ranks agree on the
step to stop at, and the launcher exits with their code (143).  Only
rank 0 prints.  Any ``DxM`` trains every config: a dim that does not
divide over ``model`` (heads, vocabulary, ``d_ff``, ``d_inner``, experts)
runs whole on every ``model`` rank, as the reference replicates it.

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b --smoke \
      --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ck --ckpt-every 50
"""
from __future__ import annotations

import argparse
import json
import math
import multiprocessing
import signal
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import checkpoint as ckpt
from repro_torch.data.pipeline import Prefetcher, StepMonitor
from repro_torch.data.synthetic import token_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.models import get_config
from repro_torch.models.config import LMConfig
from repro_torch.nn import ParamSpec
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.launch.serve import parse_mesh, run_rank, spawn_mesh
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import steps as steps_mod
from repro_torch.runtime.collectives import all_max
from repro_torch.tree import tree_leaves


def _restore(ckpt_dir, step: int, sspecs, dev, mesh=None, s_place=None):
    state = ckpt.restore(ckpt_dir, step, sspecs, device=dev, mesh=mesh,
                         pspecs=s_place)
    got = [tuple(t.shape) for t in tree_leaves(state)]
    want = [tuple(s.shape) for s in tree_leaves(sspecs)]
    if mesh is not None:  # this rank's blocks
        want = [tuple(t.shape) for t in tree_leaves(
            shd.sharded_zeros(sspecs, mesh, device="meta"))]
    for g, w in zip(got, want):
        if g != w:
            raise ValueError(f"checkpoint step {step} holds a leaf of shape "
                             f"{g} where the model has {w}")
    return state


def _forward_signals(signum, frame):
    """The spawning launcher's handler: each rank gets the signal."""
    for p in multiprocessing.active_children():
        p.terminate()


def _rank(rank, argv):
    return run_rank(main, argv)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--mesh", default="1x1", help="DATAxMODEL, e.g. 4x2")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--keep", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-out", default=None)
    ap.add_argument("--max-rollbacks", type=int, default=2,
                    help="non-finite-loss recoveries before aborting")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    data, model = parse_mesh(args.mesh)
    if data * model > 1 and not dist.is_initialized():
        previous = {s: signal.signal(s, _forward_signals)
                    for s in (signal.SIGTERM, signal.SIGINT)}
        try:
            return spawn_mesh(_rank, data * model,
                              sys.argv[1:] if argv is None else argv,
                              args.device, "train")
        finally:
            for s, h in previous.items():
                signal.signal(s, h)
    dev = resolve_device(args.device)
    cfg: LMConfig = get_config(args.arch, smoke=args.smoke)
    mesh = (shd.make_mesh_2d(data, model, device=dev)
            if data * model > 1 else None)

    # ---- preemption handling ----
    stop = {"now": False}

    def _handler(signum, frame):
        print(f"[train] signal {signum}: checkpoint-and-exit", flush=True)
        stop["now"] = True

    previous = {s: signal.signal(s, _handler)
                for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        return _train(args, cfg, dev, stop, mesh)
    finally:
        for s, h in previous.items():
            signal.signal(s, h)


def _train(args, cfg: LMConfig, dev, stop, mesh=None):
    rank0 = mesh is None or dist.get_rank() == 0

    def say(*a, **kw):
        if rank0:
            print(*a, **kw)

    optimizer = AdamW(
        lr=warmup_cosine(args.lr, args.warmup, args.steps),
        weight_decay=0.01, grad_clip_norm=1.0,
    )
    batch_specs = {
        "tokens": ParamSpec((args.batch, args.seq), torch.int32),
        "labels": ParamSpec((args.batch, args.seq), torch.int32),
    }
    if cfg.family == "vlm":
        batch_specs["vision"] = ParamSpec(
            (args.batch, cfg.vision_seq, cfg.d_model), torch.float32)
    step_fn, s_place, b_place, sspecs = steps_mod.compile_train_step(
        cfg, mesh, batch_specs, optimizer=optimizer, accum_steps=args.accum,
        device=dev,
    )
    if mesh is None:
        cut = lambda t, name: t  # noqa: E731
        s_spec = None
    else:
        cut = lambda t, name: shd.local_block(t, b_place[name], mesh)  # noqa
        s_spec = s_place
    vision = None
    if cfg.family == "vlm":  # the frontend stub: one draw for every batch
        vision = cut(torch.from_numpy(np.random.default_rng(0).normal(
            0, 1, (args.batch, cfg.vision_seq, cfg.d_model)
        ).astype("float32")), "vision").to(dev)

    # ---- init or elastic resume ----
    start_step = 0
    if args.ckpt_dir and (last := ckpt.latest_step(args.ckpt_dir)) is not None:
        say(f"[train] resuming from step {last}")
        state = _restore(args.ckpt_dir, last, sspecs, dev, mesh, s_spec)
        start_step = last
    else:
        state = steps_mod.init_train_state(
            cfg, torch.Generator(device=dev).manual_seed(args.seed),
            optimizer, mesh=mesh)

    saver = ckpt.AsyncCheckpointer(args.ckpt_dir, keep=args.keep,
                                   mesh=mesh, pspecs=s_spec) \
        if args.ckpt_dir else None
    monitor = StepMonitor()
    pin = dev.type == "cuda"

    def to_device(b):
        def put(name, a):
            t = cut(torch.from_numpy(a), name).contiguous()
            if pin:
                t = t.pin_memory()
            return t.to(dev, non_blocking=pin)
        b = {name: put(name, a) for name, a in b.items()}
        if vision is not None:
            b["vision"] = vision
        return b

    def make_stream(skip: int) -> Prefetcher:
        """Deterministic data stream positioned at step ``skip`` — used at
        start, on resume and again after a non-finite rollback."""
        raw_it = token_batch_iterator(args.batch, args.seq, cfg.vocab,
                                      seed=args.seed)
        for _ in range(skip):  # replay the deterministic stream
            next(raw_it)
        return Prefetcher(raw_it, depth=2, transform=to_device)

    it = make_stream(start_step)
    losses, step_seconds = [], []
    rollbacks = 0
    i = start_step
    while i < args.steps:
        batch = next(it)
        monitor.start()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        step_seconds.append(monitor.stop(i))
        # ---- non-finite guardrail: roll back instead of training on ----
        if not math.isfinite(loss):
            if saver:
                saver.wait()  # in-flight commit may BE the rollback target
            last = ckpt.latest_step(args.ckpt_dir) if args.ckpt_dir else None
            if last is None or rollbacks >= args.max_rollbacks:
                say(f"[train] non-finite loss at step {i} and no "
                    "rollback available; aborting", flush=True)
                raise RuntimeError(f"non-finite loss at step {i}")
            rollbacks += 1
            say(f"[train] non-finite loss at step {i}: rolling back to "
                f"step {last} ({rollbacks}/{args.max_rollbacks})",
                flush=True)
            state = None  # free the poisoned state before the restore
            state = _restore(args.ckpt_dir, last, sspecs, dev, mesh, s_spec)
            del losses[max(0, last - start_step):]
            it = make_stream(last)
            i = last
            continue
        losses.append(loss)
        if i % args.log_every == 0:
            say(f"step {i:5d}  loss {loss:.4f}  "
                f"gnorm {float(metrics['grad_norm']):.3f}  "
                f"dt {monitor.ema:.3f}s", flush=True)
        halt = stop["now"]
        if mesh is not None:  # every rank stops at the same step (the
            # handler may set the flag during the reduction: read it once)
            flag = torch.tensor([float(halt)], device=dev)
            halt = bool(all_max(flag, dist.group.WORLD)[0] > 0)
        if saver and ((i + 1) % args.ckpt_every == 0 or halt):
            saver.save(i + 1, state)
        if halt:
            if saver:
                saver.wait()
            say("[train] preempted; checkpoint committed", flush=True)
            sys.exit(143)
        i += 1
    if saver:
        saver.save(args.steps, state)
        saver.wait()
    if losses:
        say(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
            f"stragglers {len(monitor.stragglers)}", flush=True)
    else:
        say(f"[train] done: no step to run (at step {start_step})",
            flush=True)
    if args.metrics_out and rank0:
        with open(args.metrics_out, "w") as f:
            json.dump({"losses": losses,
                       "stragglers": monitor.stragglers,
                       "step_seconds": step_seconds}, f)
    return losses


if __name__ == "__main__":
    main()
