"""DONN train steps on one card and over a mesh of ranks
(``repro.runtime.donn_steps``).

The paper trains on a single GPU (multi-GPU is its future work, §6).  Here
DONN training also runs over the 2-D ``(data, model)`` mesh of
``sharding.make_mesh_2d``, as SPMD ``torch.distributed`` ranks, each with
its block of the batch and of the planes:

- ``compile_donn_train_step`` / ``compile_donn_train_chunk`` /
  ``compile_donn_train_step_shardmap``: data parallelism over the whole
  world (the batch split, the AdamW state replicated, the gradients and
  the loss all-reduced as means).  Each rank runs the whole optical
  forward and backward on its batch shard, so with ``use_pallas`` every
  rank launches K1-K3 itself.
- ``make_donn_sharded_loss`` / ``compile_donn_train_step_sharded``: the
  batch over ``data`` and every plane (field, TF stacks, phases, detector
  masks) row-sharded over ``model``, each hop a pencil FFT
  (``pencil_fft.local_spectral_pair`` as the plan's ``spectral=``), for
  every family: classification (per-class partial readouts summed over
  ``model``), RGB (``(B, C, H/k, W)`` fields, ``channel`` replicated),
  segmentation with the optical skip (layer norm and BCE over whole maps
  once the rows come together) and heterogeneous ``SegmentedPlan`` stacks
  (the resampling stitches gather whole rows, resample, and keep the
  rank's rows).  The row-sharded path runs no hand-written kernel: the
  reference refuses ``use_pallas`` there, and so does the port.

State is ``{"params", "mu", "nu", "step"}``.  ``shard_state`` cuts each
rank's block out of a global state or batch by the specs a compiler
returns (the counterpart of placing arrays with shardings) and
``gather_state`` puts the blocks back together on every rank.  Phases and
moments are row-sharded over ``model`` and replicated over ``data``: no
rank holds a whole plane of a ``model``-sharded state.

``donate`` is accepted for parity and has no effect (updates return new
tensors).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core import diffraction as df
from repro_torch.core import propagation as pp
from repro_torch.core.config import DONNConfig
from repro_torch.core.laser import data_to_cplex
from repro_torch.core.models import cached_model, layer_norm
from repro_torch.core.train_utils import bce_segmentation_loss, mse_softmax_loss
from repro_torch.device import resolve_device
from repro_torch.nn.module import ParamSpec
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import AdamWState
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.collectives import (
    all_gather_dim, all_reduce_sum, gather_rows, replicated, sum_over,
)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

# the data-parallel steps split the batch over every mesh axis present,
# in this order (the reference's rules table for its DONN steps)
DONN_RULES = {**shd.DEFAULT_RULES, "batch": ("pod", "data", "model")}


def donn_state_specs(cfg: DONNConfig) -> dict:
    """ParamSpecs of the train state: phases, AdamW moments, step."""
    pspecs = cached_model(cfg, device="cpu").param_specs()

    def opt_spec(s):
        return ParamSpec(s.shape, torch.float32, s.logical_axes, init="zeros")

    return {
        "params": pspecs,
        "mu": tree_map(opt_spec, pspecs),
        "nu": tree_map(opt_spec, pspecs),
        "step": ParamSpec((), torch.int32, (), init="zeros"),
    }


def _map_dicts(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map_dicts(fn, tree[k], specs[k]) for k in tree}
    return fn(tree, specs)


def shard_state(tree, pspecs, mesh, device=None):
    """This rank's blocks of a global state or batch (nested dicts of numpy
    arrays or tensors) under the spec tree ``pspecs``, as fresh tensors on
    ``device`` (the mesh's by default)."""
    dev = _mesh_device(mesh, device)
    return _map_dicts(
        lambda t, s: shd.local_block(t, s, mesh).to(dev, copy=True)
        .contiguous(), tree, pspecs)


def gather_state(tree, pspecs, mesh):
    """The global tensors of a sharded tree, on every rank: each sharded
    dim all-gathered over its axes' group."""
    def gather(t, spec):
        for dim, axes in enumerate(spec):
            if axes is not None:
                t = all_gather_dim(t, shd.axes_group(mesh, axes), dim)
        return t

    return _map_dicts(gather, tree, pspecs)


def _mesh_device(mesh, device=None) -> torch.device:
    """``device`` if given, else the device type the mesh was built for
    (the card when neither says)."""
    if device is None:
        device = getattr(mesh, "device_type", None)
    return resolve_device(device)


def _batch_to(batch: dict, dev: torch.device) -> dict:
    """A batch on ``dev``: images and masks f32, labels int64."""
    out = {}
    for k, v in batch.items():
        dtype = torch.int64 if k == "labels" else torch.float32
        out[k] = torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                                 else v).to(dev, dtype)
    return out


def value_and_grad(loss_fn, params, batch):
    """(loss, d loss / d params) of ``loss_fn(params, batch)``, the loss
    detached; the gradients in the tree of ``params``."""
    flat = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(tree_unflatten(params, flat), batch)
        grads = torch.autograd.grad(loss, flat)
    return loss.detach(), tree_unflatten(params, list(grads))


def _update(optimizer, state: dict, grads) -> dict:
    new_p, new_opt = optimizer.update(
        grads, AdamWState(state["mu"], state["nu"]), state["params"],
        state["step"])
    return {"params": new_p, "mu": new_opt.mu, "nu": new_opt.nu,
            "step": state["step"] + 1}


def _model_loss(cfg: DONNConfig, model):
    """The single-device loss of one batch: MSE-softmax of the detector
    readout, or the segmentation BCE of the train-time (layer-normed)
    intensity map."""
    def loss_fn(params, batch):
        if cfg.segmentation:
            inten = model.apply(params, batch["images"], train=True)
            return bce_segmentation_loss(inten, batch["masks"])
        logits = model.apply(params, batch["images"])
        return mse_softmax_loss(logits, batch["labels"], cfg.num_classes)

    return loss_fn


def make_donn_train_step(cfg: DONNConfig, optimizer: AdamW, device=None):
    """``step(state, batch) -> (state, {"loss"})`` on one device."""
    model = cached_model(cfg, device=device)
    loss_fn = _model_loss(cfg, model)

    def step(state, batch):
        loss, grads = value_and_grad(loss_fn, state["params"],
                                      _batch_to(batch, model.device))
        return _update(optimizer, state, grads), {"loss": loss}

    return step


def make_donn_train_chunk(cfg: DONNConfig, optimizer: AdamW = None,
                          device=None):
    """``chunk(state, batches) -> (state, {"loss": (S,)})``: one optimizer
    step per leading row of ``batches`` (every leaf carries a leading chunk
    axis), the losses kept on the device."""
    optimizer = optimizer or AdamW(lr=0.01)
    return _chunk_over(make_donn_train_step(cfg, optimizer, device))


def _chunk_over(step):
    """Lift a ``step(state, batch)`` to a loop over a stacked chunk."""

    def chunk(state, batches):
        losses = []
        for i in range(len(batches["images"])):
            state, metrics = step(state, {k: v[i] for k, v in batches.items()})
            losses.append(metrics["loss"])
        return state, {"loss": torch.stack(losses)}

    return chunk


def _batch_pspecs(cfg: DONNConfig, mesh, rules, global_batch=None) -> dict:
    """Per-workload batch specs (dim 0 over the DP axes)."""
    bs = lambda ndim: shd.batch_pspec(mesh, ndim, rules,  # noqa: E731
                                      batch_size=global_batch)
    if cfg.segmentation:
        return {"images": bs(3), "masks": bs(3)}
    if cfg.channels > 1:
        return {"images": bs(4), "labels": bs(1)}
    return {"images": bs(3), "labels": bs(1)}


def _data_parallel(cfg, mesh, optimizer, global_batch, device,
                   chunk: bool = False):
    """The data-parallel compilers' one implementation: every rank runs
    the single-device step on its batch shard; the gradients and the loss
    are all-reduced as means over the DP axes (the mesh's axes, dropped
    right to left until ``global_batch`` divides)."""
    optimizer = optimizer or AdamW(lr=0.01)
    shape = shd.mesh_shape(mesh)
    dp_axes = tuple(a for a in DONN_RULES["batch"] if a in shape)
    if global_batch is not None:
        while dp_axes and global_batch % math.prod(
                shape[a] for a in dp_axes):
            dp_axes = dp_axes[:-1]
        if not dp_axes:
            raise ValueError(f"batch {global_batch} unshardable on {shape}")
    dev = _mesh_device(mesh, device)
    model = cached_model(cfg, device=dev)
    loss_fn = _model_loss(cfg, model)
    group = shd.axes_group(mesh, dp_axes)
    n = shd.group_count(mesh, dp_axes)

    def step(state, batch):
        loss, grads = value_and_grad(loss_fn, state["params"],
                                      _batch_to(batch, dev))
        loss = all_reduce_sum(loss, group) / n
        grads = tree_map(lambda g: all_reduce_sum(g, group) / n, grads)
        return _update(optimizer, state, grads), {"loss": loss}

    sspecs = donn_state_specs(cfg)
    s_pspecs = tree_map(lambda s: shd.replicated_pspec(len(s.shape)), sspecs)
    spec = shd.dim0_pspec(dp_axes, 1)
    if chunk:
        step = _chunk_over(step)
        spec = shd.with_leading(spec)
    target = "masks" if cfg.segmentation else "labels"
    b_pspecs = {"images": spec, target: spec}
    return step, s_pspecs, b_pspecs, sspecs


def compile_donn_train_step(cfg: DONNConfig, mesh, optimizer=None,
                            donate: bool = True,
                            global_batch: int | None = None, device=None):
    """Data-parallel DONN training over every rank of ``mesh``.

    Returns ``(fn, state_pspecs, batch_pspecs, state_specs)``:
    ``fn(state, batch)`` takes this rank's blocks (``shard_state``) and
    returns ``(state, {"loss"})``, the loss the global batch mean.
    """
    return _data_parallel(cfg, mesh, optimizer, global_batch, device)


def compile_donn_train_step_shardmap(cfg: DONNConfig, mesh, optimizer=None,
                                     donate: bool = True,
                                     global_batch: int | None = None,
                                     device=None):
    """The reference's explicitly data-parallel step: in PyTorch the same
    program as ``compile_donn_train_step`` (each rank runs the whole
    optical forward and backward on its batch shard)."""
    return _data_parallel(cfg, mesh, optimizer, global_batch, device)


def compile_donn_train_chunk(cfg: DONNConfig, mesh, optimizer=None,
                             donate: bool = True,
                             global_batch: int | None = None, device=None):
    """Chunked data-parallel training: ``fn(state, batches)`` runs one step
    per leading row of the stacked ``(S, B, ...)`` batches (the chunk axis
    unsharded) and returns the ``(S,)`` losses."""
    return _data_parallel(cfg, mesh, optimizer, global_batch, device,
                          chunk=True)


def _check_sharded_support(cfg: DONNConfig) -> None:
    """Config gates shared by every spatially-sharded path."""
    resolved = cfg.resolved_layers()
    if cfg.pad or any(l.approximation == "fraunhofer" for l in resolved):
        raise NotImplementedError(
            "spatial sharding needs unpadded angular-spectrum hops"
        )
    if any(l.codesign in ("gumbel", "gumbel_hard") for l in resolved):
        raise NotImplementedError(
            "stochastic codesign draws per-element noise: row shards "
            "would sample different streams than the single-device step"
        )
    if cfg.use_pallas:
        raise NotImplementedError(
            "the fused hand-written kernels operate on full planes"
        )
    if cfg.tf_dtype != "float32":
        raise NotImplementedError(
            "spatial sharding reads the plan's f32 TF planes; the bf16 "
            "storage path would silently diverge from the single-device "
            "reference tolerance"
        )


def _plan_tf_stacks(plan) -> tuple:
    """The plan's split TF stacks (numpy, (depth+1, N, N) each)."""
    key_a, key_b = plan._plane_keys
    return plan._np[key_a], plan._np[key_b]


def make_donn_sharded_loss(cfg: DONNConfig, mesh, rules=None, device=None):
    """Spatial x data-parallel loss on the 2-D ``(data, model)`` mesh.

    Returns ``loss_fn(params, batch) -> scalar``: ``params`` this rank's
    row blocks of the phases, ``batch`` its batch shard (``shard_state``
    with the specs of ``compile_donn_train_step_sharded``).  Every rank
    returns the global loss; ``torch.autograd.grad`` of it gives the
    rank's block of the global gradient (the phase cotangents summed over
    ``data``, none reduced over ``model``).  Either axis may be absent from
    the rules' view of the mesh: batch-only gives pure data parallelism,
    model-only the spatial layout.
    """
    cfg = cfg.canonical()
    rules = shd.check_rules(dict(rules or shd.donn_rules()))
    _check_sharded_support(cfg)
    model_axis = shd.present_axes(mesh, rules.get("field_h"))
    if model_axis is not None and not isinstance(model_axis, str):
        raise shd.ShardingRulesError(
            f"field_h must map to a single mesh axis for the pencil FFT "
            f"(the all-to-all transposes over one group), got {model_axis!r}"
        )
    k = int(shd.mesh_shape(mesh)[model_axis]) if model_axis else 1
    if cfg.layers is not None:
        if cfg.segmentation or cfg.channels > 1:
            raise NotImplementedError(
                "sharded SegmentedPlan covers the classification family"
            )
        layers = cfg.resolved_layers()
        sizes = [(j, layers[lo].size)
                 for j, (lo, _) in enumerate(pp.segment_layers(layers))]
    else:
        sizes = [(None, cfg.n)]
    for j, n in sizes:
        if n % k:
            what = f"segment {j} grid n={n}" if j is not None else f"n={n}"
            raise ValueError(f"{what} rows must divide the {k}-way "
                             f"{model_axis!r} axis")

    dev = _mesh_device(mesh, device)
    model = cached_model(cfg, device=dev)
    spectral, model_group, m_idx = None, None, 0
    if model_axis is not None:
        from repro_torch.runtime.pencil_fft import local_spectral_pair

        # every width of the model axis runs the same FFT passes (W, then
        # H; k == 1 exchanges nothing), so the loss is one computation at
        # every mesh shape: cuFFT's fft2 rounds otherwise, and this loss
        # amplifies f32 rounding (PERF.md §6)
        if k > 1:
            model_group = mesh.get_group(model_axis)
            m_idx = shd.axes_index(mesh, model_axis)[0]
        spectral = local_spectral_pair(model_group, k)
    batch_axes = shd.present_axes(mesh, rules.get("batch"))
    data_group = shd.axes_group(mesh, batch_axes)
    n_data = shd.group_count(mesh, batch_axes)

    def rows(t):
        """This rank's row block (dim -2) of a whole plane or field, cut
        before it moves: the rank holds its rows of a host plane only."""
        t = torch.as_tensor(t)
        h = t.shape[-2] // k
        return t.narrow(-2, m_idx * h, h).to(dev).contiguous()

    def tf_rows(plan):
        return tuple(rows(p) for p in _plan_tf_stacks(plan))

    def finish(loss):
        """The global loss: the batch shards' mean over ``data``."""
        return sum_over(loss, data_group) / n_data

    def stack(params, depth):
        return torch.stack([params["phase"][f"layer_{i}"]
                            for i in range(depth)])

    if cfg.layers is not None:
        return _hetero_loss(cfg, model, rows, tf_rows, finish, spectral,
                            model_group, data_group)
    if cfg.segmentation:
        plan = model.plan
        tfs = tf_rows(plan)
        skip_from = cfg.skip_from
        if skip_from is not None:
            z_skip = float(sum(cfg.gap_distances()[skip_from + 1:]))
            planes = pp.transfer_planes(
                model.layers[skip_from].grid, z_skip, cfg.wavelength,
                cfg.resolved_layers()[skip_from].approximation,
                cfg.band_limit, cfg.pad,
            )
            skip_pair = (rows(planes["hr"]), rows(planes["hi"]))

        def local_map(phis, u):
            if skip_from is None:
                u = plan.forward(phis, u, tfs=tfs, spectral=spectral)
                return df.intensity(plan.propagate_final(
                    u, tfs=tfs, spectral=spectral))
            phis = plan.codesign_stack(phis)
            u1 = plan.forward(phis, u, stop=skip_from + 1, tfs=tfs,
                              spectral=spectral, resolved=True)
            u2 = plan.forward(phis, u1, start=skip_from + 1, tfs=tfs,
                              spectral=spectral, resolved=True)
            u2 = plan.propagate_final(u2, tfs=tfs, spectral=spectral)
            sk = plan._hop(u1, skip_pair, spectral=spectral)
            return df.intensity((u2 + sk) / math.sqrt(2.0))

        def loss_fn(params, batch):
            phis = replicated(stack(params, plan.depth), data_group)
            u0 = rows(data_to_cplex(batch["images"], model.in_grid.n)
                      * model.source_t)
            # every model rank repeats the whole-map loss alike: the
            # gather's backward keeps the rank's own rows
            inten = gather_rows(local_map(phis, u0), model_group,
                                reduce_grad=False)
            inten = layer_norm(inten, cfg.layer_norm)
            return finish(bce_segmentation_loss(inten, batch["masks"]))

        return loss_fn

    # classification: single channel or multi-channel/RGB
    host = model.channel_model if cfg.channels > 1 else model
    plan = host.plan
    tfs = tf_rows(plan)
    masks = rows(host.detector.masks_t)
    readout = "...dhw,chw->...c" if cfg.channels > 1 else "...hw,chw->...c"

    def loss_fn(params, batch):
        phis = replicated(stack(params, plan.depth), data_group)
        u0 = rows(data_to_cplex(batch["images"], host.in_grid.n)
                  * host.source_t)
        u = plan.forward(phis, u0, tfs=tfs, spectral=spectral)
        u = plan.propagate_final(u, tfs=tfs, spectral=spectral)
        logits = sum_over(torch.einsum(readout, df.intensity(u), masks),
                          model_group)
        return finish(mse_softmax_loss(logits, batch["labels"],
                                       cfg.num_classes))

    return loss_fn


def _hetero_loss(cfg, model, rows, tf_rows, finish, spectral, model_group,
                 data_group):
    """A heterogeneous ``SegmentedPlan``: each segment runs on row shards
    with its own TF planes; a resampling stitch needs whole rows, so it
    gathers them, resamples, and keeps the rank's rows (each rank goes on
    with other rows, so the gather's backward sums the ranks' cotangents)."""
    plan = model.plan
    seg_tfs = [tf_rows(s) for s in plan.segments]
    masks = rows(model.detector.masks_t)
    last = len(plan.segments) - 1

    def stitch(u, grid_in, grid_out):
        whole = gather_rows(u, model_group, reduce_grad=True)
        return rows(df.resample_field(whole, grid_in, grid_out))

    def loss_fn(params, batch):
        phis = plan.stack_phases(params["phase"][f"layer_{i}"]
                                 for i in range(plan.depth))
        u = rows(data_to_cplex(batch["images"], plan.input_grid.n)
                 * model.source_t)
        cur = plan.input_grid
        for j, seg in enumerate(plan.segments):
            if seg.grid != cur:
                u = stitch(u, cur, seg.grid)
            u = seg.forward(replicated(phis[j], data_group), u,
                            tfs=seg_tfs[j], spectral=spectral)
            if j == last:
                u = seg.propagate_final(u, tfs=seg_tfs[j], spectral=spectral)
            cur = seg.grid
        if plan.det_grid != cur:
            u = stitch(u, cur, plan.det_grid)
        logits = sum_over(torch.einsum("...hw,chw->...c", df.intensity(u),
                                       masks), model_group)
        return finish(mse_softmax_loss(logits, batch["labels"],
                                       cfg.num_classes))

    return loss_fn


def make_donn_spatial_loss(cfg: DONNConfig, mesh, axis: str = "model",
                           device=None):
    """Spatial-only loss: rows over ``axis``, the batch replicated."""
    rules = {**shd.donn_rules(model=axis), "batch": None, "population": None}
    return make_donn_sharded_loss(cfg, mesh, rules=rules, device=device)


def compile_donn_train_step_sharded(cfg: DONNConfig, mesh, rules=None,
                                    optimizer=None, donate: bool = True,
                                    steps_per_call: int = 1,
                                    global_batch: int | None = None,
                                    device=None):
    """Spatial x data-parallel training on the 2-D mesh, over
    :func:`make_donn_sharded_loss`.

    State shards by the same rules (phases and moments row-sharded over
    ``model``, replicated over ``data``), the batch over the DP axes.
    Returns ``(fn, state_pspecs, batch_pspecs, state_specs)``:
    ``fn(state, batch)`` on this rank's blocks (``shard_state``);
    ``steps_per_call > 1`` takes a stacked chunk and returns ``{"loss":
    (S,)}``.
    """
    optimizer = optimizer or AdamW(lr=0.01)
    rules = shd.check_rules(dict(rules or shd.donn_rules()))
    if getattr(optimizer, "grad_clip_norm", None) is not None \
            and shd.present_axes(mesh, rules.get("field_h")):
        raise NotImplementedError(
            "gradient clipping needs the global norm of row-sharded "
            "gradients; the sharded step takes an unclipped optimizer"
        )
    b_pspecs = _batch_pspecs(cfg, mesh, rules)
    if global_batch is not None \
            and _batch_pspecs(cfg, mesh, rules, global_batch) != b_pspecs:
        raise ValueError(f"batch {global_batch} does not divide over the "
                         f"batch axes of {shd.mesh_shape(mesh)}")
    loss_fn = make_donn_sharded_loss(cfg, mesh, rules=rules, device=device)
    dev = _mesh_device(mesh, device)

    def step(state, batch):
        loss, grads = value_and_grad(loss_fn, state["params"],
                                      _batch_to(batch, dev))
        return _update(optimizer, state, grads), {"loss": loss}

    sspecs = donn_state_specs(cfg)
    s_pspecs = shd.tree_pspecs(sspecs, mesh, rules)
    if steps_per_call > 1:
        step = _chunk_over(step)
        b_pspecs = {k: shd.with_leading(s) for k, s in b_pspecs.items()}
    return step, s_pspecs, b_pspecs, sspecs


def compile_donn_train_step_spatial(cfg: DONNConfig, mesh,
                                    axis: str = "model", optimizer=None,
                                    donate: bool = True,
                                    steps_per_call: int = 1, device=None):
    """Spatial-only compiled step (the batch replicated)."""
    rules = {**shd.donn_rules(model=axis), "batch": None, "population": None}
    return compile_donn_train_step_sharded(
        cfg, mesh, rules=rules, optimizer=optimizer, donate=donate,
        steps_per_call=steps_per_call, device=device,
    )
