"""DONN training utilities (LightRidge `lr.train.utils`), PyTorch side.

The port of ``repro.core.train_utils``.  Loss per the paper (§2.1): L =
|| softmax(I) - onehot(t) ||_2^2 over the per-class detector intensities
I (the classify and RGB families; RGB batches are (B, C, h, w) images).
Also accuracy, detector-noise injection (Fig. 7), the segmentation DONN's
per-pixel BCE and IoU, and the training loops:

- ``make_train_step``: one batch, (params, opt_state, step, xb, yb) ->
  (params, opt_state, loss, acc); gradients by ``torch.autograd.grad``
  through the kernels' autograd Functions.
- ``make_train_chunk``: one optimizer step per leading row of a stacked
  chunk, losses and accuracies kept on the device and returned as (S,)
  tensors, so the caller syncs once per chunk.  ``guard=True`` decides on
  the device (``torch.where``) whether each step is finite and drops a
  non-finite one wholesale: params, moments and the step counter keep
  their pre-step values bit for bit.
- ``train_classifier``: the AdamW loop on top, chunked through the device
  prefetcher when ``steps_per_call > 1``.

``needs_rng`` trains a stochastic codesign (Gumbel) with noise: every
step draws from one ``torch.Generator`` on the model's device, layer by
layer (``codesign.py``'s rng contract).  The reference splits its key
before each step; the port's generator advances in place, and the chunked
and per-step loops draw in the same order, so they train identically.

The reference routes its steps through a process-wide executable cache
(``optimizer_cache_key``, ``_train_static_key``, ``cached_executable``);
eager PyTorch compiles nothing, so the port has no counterpart.  Nor does
it donate buffers (the reference's ``donate``): updates return new
tensors and never write the caller's.  Checkpoint rollback (``ckpt_dir``,
``ckpt_every``, ``max_rollbacks``) saves (params, opt_state, rng, step)
through ``repro_torch.checkpoint``; the rng is a ``torch.Generator``, so
its checkpointed state is ``rng.get_state()`` and a rollback calls
``set_state``.  The segmentation DONN trains through a step written by hand on
``bce_segmentation_loss``, as the reference's example does.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.optim import AdamW
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def mse_softmax_loss(logits: torch.Tensor, labels: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """Paper loss: MSE between softmax(detector intensities) and one-hot."""
    probs = torch.softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), num_classes).to(probs.dtype)
    return torch.mean(torch.sum((probs - onehot) ** 2, dim=-1))


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits, dim=-1) == labels)
                      .to(torch.float32))


def add_detector_noise(logits_or_intensity: torch.Tensor,
                       generator: torch.Generator,
                       frac: float) -> torch.Tensor:
    """Uniform intensity noise bounded by ``frac`` of the max (Fig. 7).

    The noise is drawn from ``generator`` on its own device and moved to
    the intensities'.
    """
    x = logits_or_intensity
    scale = frac * torch.amax(x, dim=-1, keepdim=True)
    noise = torch.rand(x.shape, generator=generator, dtype=x.dtype,
                       device=generator.device).to(x.device)
    return x + scale * noise


def bce_segmentation_loss(intensity: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Per-pixel BCE on normalized intensity (segmentation DONN)."""
    logits = intensity  # already layer-normed in train mode
    return torch.mean(torch.clamp_min(logits, 0.0) - logits * mask
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def iou(intensity: torch.Tensor, mask: torch.Tensor,
        thresh: float = 0.0) -> torch.Tensor:
    pred = (intensity > thresh).to(torch.float32)
    inter = torch.sum(pred * mask, dim=(-2, -1))
    union = torch.sum(torch.maximum(pred, mask), dim=(-2, -1))
    return torch.mean(inter / torch.clamp_min(union, 1.0))


@dataclasses.dataclass
class TrainResult:
    params: Any
    losses: list
    accs: list
    wall_time_s: float
    skipped_steps: int = 0  # guarded steps dropped for non-finite loss/grads
    rollbacks: int = 0  # checkpoint restores after a diverged chunk


def _batch(model, xb, yb):
    """A batch on the model's device: images f32, labels int64."""
    x = torch.as_tensor(xb).to(model.device, torch.float32)
    y = torch.as_tensor(yb).to(model.device, torch.int64)
    return x, y


def loss_and_grads(model, params, xb, yb, num_classes: int, rng=None):
    """(loss, logits, grads) of the paper loss at ``params`` for one batch
    (numpy or tensors), everything on the model's device — the gradient
    half of every training step.  ``rng`` draws the codesign noise."""
    x, y = _batch(model, xb, yb)
    return _loss_and_grads(model, params, x, y, num_classes, rng)


def _loss_and_grads(model, params, x, y, num_classes: int, rng=None):
    flat = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        logits = model.apply(tree_unflatten(params, flat), x, rng)
        loss = mse_softmax_loss(logits, y, num_classes)
        grads = torch.autograd.grad(loss, flat)
    return loss.detach(), logits.detach(), tree_unflatten(params, grads)


def _step_rng(needs_rng: bool, rng):
    """The generator a step draws from: ``rng`` when the model needs noise
    (it must then be given), else None (no noise even if one is given)."""
    if not needs_rng:
        return None
    if not isinstance(rng, torch.Generator):
        raise TypeError("needs_rng=True: pass rng, a torch.Generator on the "
                        "model's device")
    return rng


def make_train_step(model, optimizer, num_classes: int,
                    needs_rng: bool = False):
    """(params, opt_state, step, xb, yb[, rng]) -> (params, opt_state, loss,
    acc), loss and acc as device scalars; with ``needs_rng`` the forward
    draws its codesign noise from ``rng``."""

    def step_fn(params, opt_state, step, xb, yb, rng=None):
        x, y = _batch(model, xb, yb)
        loss, logits, grads = _loss_and_grads(model, params, x, y,
                                              num_classes,
                                              _step_rng(needs_rng, rng))
        params, opt_state = optimizer.update(grads, opt_state, params, step)
        return params, opt_state, loss, accuracy(logits, y)

    return step_fn


def _all_finite(tensors) -> torch.Tensor:
    ok = torch.ones((), dtype=torch.bool, device=tensors[0].device)
    for t in tensors:
        ok = ok & torch.all(torch.isfinite(t))
    return ok


def make_train_chunk(model, optimizer, num_classes: int,
                     needs_rng: bool = False, guard: bool = False):
    """Multi-step training driver: one optimizer step per chunk row.

    Returns ``chunk_fn(params, opt_state, step0, xs, ys[, rng]) -> (params,
    opt_state, losses, accs)`` with (S,) device tensors of per-step losses
    and accuracies — numerically the same as ``make_train_step`` iterated
    S times, the generator ``rng`` (with ``needs_rng``) drawn step after
    step as the per-step loop draws it.  Nothing in it waits on the
    device.  ``guard=True`` checks
    the loss and every gradient for non-finite values on the device; a bad
    step keeps params, optimizer state and the step counter at their
    pre-step values (``torch.where``, bit for bit) and is flagged, and the
    chunk returns ``(..., losses, accs, skipped, params_ok)`` with
    ``skipped`` an (S,) bool tensor and ``params_ok`` "every param
    finite".
    """

    def chunk_fn(params, opt_state, step0, xs, ys, rng=None):
        with tracing.span("train.chunk", steps=len(xs)):
            return _chunk(params, opt_state, step0, xs, ys, rng)

    def _chunk(params, opt_state, step0, xs, ys, rng):
        rng = _step_rng(needs_rng, rng)
        with tracing.span("train.upload"):
            xs, ys = _batch(model, xs, ys)
        step = torch.as_tensor(step0, dtype=torch.int32, device=model.device)
        losses, accs, skipped = [], [], []
        for xb, yb in zip(xs, ys):
            loss, logits, grads = _loss_and_grads(model, params, xb, yb,
                                                  num_classes, rng)
            losses.append(loss)
            accs.append(accuracy(logits, yb))
            new_params, new_opt = optimizer.update(grads, opt_state, params,
                                                   step)
            if not guard:
                params, opt_state, step = new_params, new_opt, step + 1
                continue
            ok = _all_finite([loss] + tree_leaves(grads))
            keep = lambda new, old: tree_map(  # noqa: E731
                lambda a, b: torch.where(ok, a, b), new, old)
            # a skipped step is a full no-op: params, optimizer moments and
            # the bias-correction step counter all stay pre-step
            params = keep(new_params, params)
            opt_state = keep(new_opt, opt_state)
            step = torch.where(ok, step + 1, step)
            skipped.append(~ok)
        losses, accs = torch.stack(losses), torch.stack(accs)
        if not guard:
            return params, opt_state, losses, accs
        return (params, opt_state, losses, accs, torch.stack(skipped),
                _all_finite(tree_leaves(params)))

    return chunk_fn


def train_classifier(
    model,
    params,
    data_iter,
    steps: int,
    lr: float = 0.1,
    num_classes: int = 10,
    needs_rng: bool = False,
    rng: Optional[torch.Generator] = None,
    log_every: int = 0,
    steps_per_call: int = 1,
    prefetch: int = 2,
    guard: bool = False,
    ckpt_dir=None,
    ckpt_every: int = 0,
    max_rollbacks: int = 2,
) -> TrainResult:
    """Compact Adam training loop for DONN classifiers (paper: Adam + MSE).

    ``steps_per_call > 1`` switches to the chunked driver
    (``make_train_chunk``): batches stack into chunks uploaded through
    ``device_prefetch`` (``prefetch`` chunks in flight, 0 = off) and the
    host syncs once per chunk.  Losses, the draws from ``rng`` and the
    final params equal the per-step path's.  ``needs_rng`` draws the
    codesign noise from ``rng`` (a ``torch.Generator`` on the model's
    device; seed 0 there when not given).  ``guard=True`` (chunked path
    only) skips non-finite steps as exact no-ops, counted in
    ``TrainResult.skipped_steps``.  With ``ckpt_dir`` set, (params,
    opt_state, the generator's state, step) checkpoint through
    ``repro_torch.checkpoint`` every ``ckpt_every`` steps (plus once at
    step 0), and a guarded chunk that comes back fully skipped or with
    non-finite params **rolls back** to the last good checkpoint and goes
    on with the next chunk — at most ``max_rollbacks`` times (counted in
    ``TrainResult.rollbacks``); beyond that a ``RuntimeError`` surfaces
    the divergence.  A restore is bit-exact, so the steps after a rollback
    lose exactly what a run without the bad chunk's batches would.
    """
    optimizer = AdamW(lr=lr)
    opt_state = optimizer.init(params)
    if needs_rng and rng is None:
        rng = torch.Generator(device=model.device).manual_seed(0)
    losses, accs = [], []
    t0 = time.perf_counter()
    if guard and steps_per_call <= 1:
        raise ValueError("guard=True requires the chunked driver "
                         "(steps_per_call > 1)")
    if steps_per_call <= 1:
        step_fn = make_train_step(model, optimizer, num_classes, needs_rng)
        for i in range(steps):
            xb, yb = next(data_iter)
            params, opt_state, loss, acc = step_fn(params, opt_state, i, xb,
                                                   yb, rng)
            losses.append(float(loss))
            accs.append(float(acc))
            if log_every and (i % log_every == 0):
                print(f"step {i:4d}  loss {losses[-1]:.4f}  "
                      f"acc {accs[-1]:.3f}")
        return TrainResult(params, losses, accs, time.perf_counter() - t0)

    from repro_torch.data.pipeline import device_prefetch, stack_batches

    # the caller's tensors are never the ones training hands back
    params = tree_map(torch.clone, params)
    chunk_fn = make_train_chunk(model, optimizer, num_classes, needs_rng,
                                guard=guard)
    chunks = stack_batches(data_iter, steps_per_call, total=steps)
    if prefetch:
        chunks = device_prefetch(chunks, size=prefetch, device=model.device)
    skipped_total, rollbacks = 0, 0
    last_good: Optional[int] = None
    # i indexes the data stream / metric lists; opt_step is the optimizer's
    # bias-correction counter — they diverge when guarded steps are skipped
    i, opt_step = 0, 0
    if ckpt_dir is not None:
        from repro_torch import checkpoint as ckpt

        def _ckpt_state():
            state = {"params": params, "opt": opt_state,
                     "opt_step": torch.tensor(opt_step, dtype=torch.int32)}
            if rng is not None:
                state["rng"] = rng.get_state()
            return state

        # a rollback target must exist before the first chunk can fail
        ckpt.save(ckpt_dir, 0, _ckpt_state(), keep=3)
        last_good = 0
    for xs, ys in chunks:
        out = chunk_fn(params, opt_state, opt_step, xs, ys, rng)
        n = int(xs.shape[0])
        if guard:
            params, opt_state, closs, cacc, skipped, params_ok = out
            skipped = skipped.cpu()  # the chunk's sync
            bad_chunk = (not bool(params_ok)) or bool(skipped.all())
            if bad_chunk and last_good is not None:
                if rollbacks >= max_rollbacks:
                    raise RuntimeError(
                        f"training diverged at step {i} and the rollback "
                        f"budget ({max_rollbacks}) is exhausted"
                    )
                state = ckpt.restore(ckpt_dir, last_good, _ckpt_state(),
                                     device=model.device)
                params, opt_state = state["params"], state["opt"]
                if rng is not None:
                    rng.set_state(state["rng"].cpu())
                opt_step = int(state["opt_step"])
                del losses[last_good:], accs[last_good:]  # rolled back
                i = last_good
                rollbacks += 1
                continue
            n_skip = int(skipped.sum())
            skipped_total += n_skip
            opt_step += n - n_skip
        else:
            params, opt_state, closs, cacc = out
            opt_step += n
        closs = closs.cpu().numpy()
        cacc = cacc.cpu().numpy()
        losses.extend(closs.tolist())
        accs.extend(cacc.tolist())
        if log_every:
            for j in range(n):
                if (i + j) % log_every == 0:
                    print(f"step {i + j:4d}  loss {closs[j]:.4f}  "
                          f"acc {cacc[j]:.3f}")
        i += n
        if (last_good is not None and ckpt_every
                and i - last_good >= ckpt_every):
            ckpt.save(ckpt_dir, i, _ckpt_state(), keep=3)
            last_good = i
    return TrainResult(params, losses, accs, time.perf_counter() - t0,
                       skipped_steps=skipped_total, rollbacks=rollbacks)


@torch.no_grad()
def evaluate_classifier(model, params, data_iter, batches: int,
                        rng: Optional[torch.Generator] = None,
                        noise_frac: float = 0.0) -> float:
    """Top-1 accuracy over ``batches`` batches; ``noise_frac`` adds the
    Fig. 7 detector noise from ``rng`` (seed 1 when not given)."""
    correct, total = 0.0, 0
    rng = rng if rng is not None else torch.Generator().manual_seed(1)
    for _ in range(batches):
        xb, yb = next(data_iter)
        x, y = _batch(model, xb, yb)
        logits = model.apply(params, x)
        if noise_frac > 0.0:
            logits = add_detector_noise(logits, rng, noise_frac)
        correct += float(torch.sum(torch.argmax(logits, -1) == y))
        total += int(y.shape[0])
    return correct / max(total, 1)
