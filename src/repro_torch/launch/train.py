"""Fault-tolerant LM training launcher (port of ``repro.launch.train``).

Trains any registered architecture (reduced or full config) on one
device, with the reference's flags and behaviour:
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
once).  ``--device`` defaults to the CUDA card.  ``--mesh`` takes only
1x1: LM tensor/FSDP parallelism is ROADMAP queue 1, item 5.
``--metrics-out`` writes the reference's ``losses`` and ``stragglers``
and, beside them, each step's seconds as the monitor timed it
(``step_seconds``, in the order run).

Example:
  PYTHONPATH=src python -m repro_torch.launch.train --arch glm4-9b --smoke \
      --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ck --ckpt-every 50
"""
from __future__ import annotations

import argparse
import json
import math
import signal
import sys

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.data.pipeline import Prefetcher, StepMonitor
from repro_torch.data.synthetic import token_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.models import get_config
from repro_torch.models.config import LMConfig
from repro_torch.nn import ParamSpec
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.runtime import steps as steps_mod
from repro_torch.tree import tree_leaves, tree_map


def _restore(ckpt_dir, step: int, sspecs, dev):
    state = ckpt.restore(ckpt_dir, step, sspecs, device=dev)
    for got, spec in zip(tree_leaves(state), tree_leaves(sspecs)):
        if tuple(got.shape) != tuple(spec.shape):
            raise ValueError(f"checkpoint step {step} holds a leaf of shape "
                             f"{tuple(got.shape)} where the model has "
                             f"{tuple(spec.shape)}")
    return state


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

    data, model = (int(x) for x in args.mesh.split("x"))
    if (data, model) != (1, 1):
        raise NotImplementedError(
            f"--mesh {args.mesh}: multi-device LM training (tensor/FSDP "
            "parallelism) is not ported yet (ROADMAP queue 1, item 5)"
        )
    dev = resolve_device(args.device)
    cfg: LMConfig = get_config(args.arch, smoke=args.smoke)

    # ---- preemption handling ----
    stop = {"now": False}

    def _handler(signum, frame):
        print(f"[train] signal {signum}: checkpoint-and-exit")
        stop["now"] = True

    previous = {s: signal.signal(s, _handler)
                for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        return _train(args, cfg, dev, stop)
    finally:
        for s, h in previous.items():
            signal.signal(s, h)


def _train(args, cfg: LMConfig, dev, stop):
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
        cfg, None, batch_specs, optimizer=optimizer, accum_steps=args.accum,
        device=dev,
    )
    vision = None
    if cfg.family == "vlm":  # the frontend stub: one draw for every batch
        vision = torch.from_numpy(np.random.default_rng(0).normal(
            0, 1, (args.batch, cfg.vision_seq, cfg.d_model)
        ).astype("float32")).to(b_place)

    # ---- init or elastic resume ----
    start_step = 0
    if args.ckpt_dir and (last := ckpt.latest_step(args.ckpt_dir)) is not None:
        print(f"[train] resuming from step {last}")
        state = _restore(args.ckpt_dir, last, sspecs, s_place)
        start_step = last
    else:
        state = steps_mod.init_train_state(
            cfg, torch.Generator(device=s_place).manual_seed(args.seed),
            optimizer)

    saver = ckpt.AsyncCheckpointer(args.ckpt_dir, keep=args.keep) \
        if args.ckpt_dir else None
    monitor = StepMonitor()
    pin = b_place.type == "cuda"

    def to_device(b):
        def put(a):
            t = torch.from_numpy(a)
            if pin:
                t = t.pin_memory()
            return t.to(b_place, non_blocking=pin)
        b = tree_map(put, b)
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
                print(f"[train] non-finite loss at step {i} and no "
                      "rollback available; aborting", flush=True)
                raise RuntimeError(f"non-finite loss at step {i}")
            rollbacks += 1
            print(f"[train] non-finite loss at step {i}: rolling back to "
                  f"step {last} ({rollbacks}/{args.max_rollbacks})",
                  flush=True)
            state = None  # free the poisoned state before the restore
            state = _restore(args.ckpt_dir, last, sspecs, s_place)
            del losses[max(0, last - start_step):]
            it = make_stream(last)
            i = last
            continue
        losses.append(loss)
        if i % args.log_every == 0:
            print(f"step {i:5d}  loss {loss:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"dt {monitor.ema:.3f}s", flush=True)
        if saver and ((i + 1) % args.ckpt_every == 0 or stop["now"]):
            saver.save(i + 1, state)
        if stop["now"]:
            if saver:
                saver.wait()
            print("[train] preempted; checkpoint committed", flush=True)
            sys.exit(143)
        i += 1
    if saver:
        saver.save(args.steps, state)
        saver.wait()
    if losses:
        print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
              f"stragglers {len(monitor.stragglers)}")
    else:
        print(f"[train] done: no step to run (at step {start_step})")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump({"losses": losses,
                       "stragglers": monitor.stragglers,
                       "step_seconds": step_seconds}, f)
    return losses


if __name__ == "__main__":
    main()
