"""Training traffic: ``make_train_chunk`` with AdamW on fresh batches.

Set-up builds one training object (model, optimizer state, the chunk
function) from the seed and drives it through its first steps with the
window's own call: one step, then two, on batches whose rows all differ,
then ``warmup_calls`` chunks of the window's length.  The same object
then trains through the window, ``steps_per_call`` steps a call, each
chunk gathered from a host pool of images and uploaded by the port's
own feed.  The losses of a chunk are read back while the next one runs.

The check follows the first three steps with the reference and compares
the first step's loss, each layer's first gradient as the optimizer got
it (its first moment after one step over 1 - b1) and each layer's change
after three.  The later steps' losses are not compared: the third
step's loss of the float32 reference itself parts from a float64 one by
up to 1.1e-4, so it reads the rounding of the steps before it, not the
port.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench.counts import donn as counts
from portbench.drivers import Window
from portbench.harness import images, program, seeds
from portbench.reference import donn as ref

FAULTS = ("unchanged", "half")
CHECKED = 3  # steps the reference follows
MIN_LEAF = 1e-3  # leaves whose reference gradient is under this share of
# the median leaf's move by round-off alone: left out of the change


def span_metrics(traffic: dict) -> dict:
    """Every chunk call waits on its upload (``drivers/__init__.py``)."""
    return {"train.upload_wait_ms": True}


class Driver:
    def __init__(self, cell, seed: int, device, tracer, fault=None):
        if fault not in (None,) + FAULTS:
            raise ValueError(f"no fault {fault!r} for training")
        self.cell, self.seed, self.fault = cell, int(seed), fault
        self.device = torch.device(device)
        self.tracer = tracer
        self.t = cell.traffic
        self.cfg = cell.config
        self.B = int(self.t["batch"])
        self.S = int(self.t["steps_per_call"])
        self.order = seeds.rng(seed, seeds.ORDER)

    # --- the port ---
    def _chunk_fn(self):
        from repro_torch.core.train_utils import make_train_chunk

        chunk = make_train_chunk(self.model, self.opt, self.cfg["num_classes"])
        if self.fault == "unchanged":  # the step hands back its input state
            def chunk_unchanged(p, s, step, xs, ys):
                return (p, s) + tuple(chunk(p, s, step, xs, ys)[2:])
            return chunk_unchanged
        if self.fault == "half":  # half of each batch, the mean over it
            def chunk_half(p, s, step, xs, ys):
                h = xs.shape[1] // 2
                return chunk(p, s, step, xs[:, :h], ys[:, :h])
            return chunk_half
        return chunk

    def _feed(self, idx: np.ndarray):
        return self.pool_x[idx], self.pool_y[idx]

    def setup(self) -> None:
        from repro_torch.core.models import build_model
        from repro_torch.optim import AdamW

        t, cfg = self.t, self.cfg
        self.pool_x, self.pool_y = images.glyphs(
            int(t["pool"]), self.seed, stream=0, size=cfg["input_size"],
            classes=cfg["num_classes"], power=float(t["power"]))
        self.model = build_model(program.donn_config(cfg), device=self.device)
        o = t["optimizer"]
        self.opt = AdamW(lr=o["lr"], b1=o["b1"], b2=o["b2"], eps=o["eps"],
                         weight_decay=o["weight_decay"])
        self.chunk = self._chunk_fn()
        p0 = program.phases(self.seed, 0, (cfg["depth"], cfg["n"], cfg["n"]),
                            self.device)
        params = program.as_params(p0.clone())
        state = self.opt.init(params)
        # the checked steps: rows that all differ, through the window's call
        self.checked_idx = self.order.choice(len(self.pool_x),
                                             (CHECKED, self.B), replace=False)
        params, state, l1, _ = self.chunk(params, state, 0,
                                          *self._feed(self.checked_idx[:1]))
        first = program.leaf_stack(state.mu) / (1.0 - o["b1"])
        params, state, l23, _ = self.chunk(params, state, 1,
                                           *self._feed(self.checked_idx[1:]))
        self.got = {
            "losses": torch.cat([l1, l23]).double().cpu().tolist(),
            "grad_norms": first.flatten(1).norm(dim=1).double().cpu(),
            "change_norms": (program.leaf_stack(params) - p0)
            .flatten(1).norm(dim=1).double().cpu(),
        }
        del p0, first
        step = CHECKED
        for _ in range(int(t["warmup_calls"])):
            params, state, losses, _ = self.chunk(params, state, step,
                                                  *self._feed(self._draw()))
            step += self.S
        losses.cpu()
        self.params, self.state, self.step = params, state, step

    def _draw(self) -> np.ndarray:
        return self.order.choice(len(self.pool_x), (self.S, self.B),
                                 replace=False)

    def run(self, seconds: float) -> Window:
        sp = self.tracer.span
        params, state, step = self.params, self.state, self.step
        dispatch, losses, pending = [], [], None
        start = time.perf_counter()
        end = start + seconds
        calls = 0
        while time.perf_counter() < end:
            with sp("train.feed"):
                xs, ys = self._feed(self._draw())
            t0 = time.perf_counter()
            with sp("train.chunk"):
                params, state, chunk_losses, _ = self.chunk(params, state, step,
                                                            xs, ys)
            dispatch.append((time.perf_counter() - t0) / self.S)
            step += self.S
            calls += 1
            if pending is not None:
                with sp("train.readback"):
                    losses.extend(pending.cpu().tolist())
            pending = chunk_losses
        with sp("train.readback"):
            losses.extend(pending.cpu().tolist())
        program.sync(self.device)
        elapsed = time.perf_counter() - start
        self.params, self.state, self.step = params, state, step
        steps = calls * self.S
        cfg = self.cfg
        flops = counts.train_flops(cfg["n"], cfg["depth"], cfg["num_classes"],
                                   cfg["det_size"])
        failed = sum(not math.isfinite(v) for v in losses)
        return Window(
            attempted=steps, failed=failed,
            end_to_end={"train_samples_per_s": steps * self.B / elapsed},
            readings={"dispatch_s_per_step": dispatch,
                      "model_flops": steps * self.B * flops})

    def release(self) -> None:
        for name in ("params", "state", "model", "chunk", "opt"):
            setattr(self, name, None)

    # --- the comparison ---
    def check(self) -> dict:
        cfg, o = self.cfg, self.t["optimizer"]
        model = ref.Classifier(cfg, self.device)
        p0 = program.phases(self.seed, 0, (cfg["depth"], cfg["n"], cfg["n"]),
                            self.device)
        batches = [(torch.from_numpy(x).to(self.device),
                    torch.from_numpy(y).to(self.device))
                   for x, y in (self._feed(i) for i in self.checked_idx)]
        want = ref.train(model, p0, batches, o)
        g_ref = want["first_grad"].flatten(1).norm(dim=1).double().cpu()
        c_ref = want["change"].flatten(1).norm(dim=1).double().cpu()
        g_med, c_med = float(g_ref.median()), float(c_ref.median())
        moved = g_ref >= MIN_LEAF * g_med
        got = self.got
        return {
            "loss1_gap": program.gap(got["losses"][0], want["losses"][0],
                                     1e-30),
            "grad_gap": max(program.gap(a, b, g_med)
                            for a, b in zip(got["grad_norms"], g_ref)),
            "change_gap": max(program.gap(a, b, c_med) for a, b, m in zip(
                got["change_norms"], c_ref, moved) if m),
        }
