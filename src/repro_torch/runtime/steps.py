"""LM train, prefill and decode steps (port of ``repro.runtime.steps``).

``TrainState`` is a plain dict ``{params, mu, nu, step}``; the moments
reuse the parameters' ParamSpecs.  The steps are plain functions over
tensors: there is no jit, no mesh beyond one device and no
``torch.compile``; the tensors' device decides where they run.

The train step differentiates with ``torch.autograd`` layer by layer.
Each layer's slice of a stacked "layers" leaf is handed to the forward as
a leaf of its own (a view, no copy), and its gradient is written into the
stacked gradient buffer as soon as autograd has it (a post-accumulate
hook), then freed.  Differentiating the stacked leaves themselves would
give every layer's ``a[i]`` a backward that scatters into a zero tensor of
the whole stack, n_layers times a step.  The step updates the state in
place (``AdamW.update(donate=True)``), as the reference's jit donates it.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import LMConfig
from repro_torch.nn import ParamSpec
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.adamw import global_norm as _global_norm
from repro_torch.runtime.sharding import mesh_shape
from repro_torch.tree import tree_leaves, tree_map


# ----------------------------------------------------------------- specs
def _with_dtype(pspecs, dtype):
    return tree_map(lambda s: ParamSpec(s.shape, dtype, s.logical_axes,
                                        init=s.init, scale=s.scale), pspecs)


def train_state_specs(cfg: LMConfig, state_dtype=torch.float32,
                      param_dtype=None):
    pspecs = lm.param_specs(cfg)
    if param_dtype is not None:  # e.g. bf16 params for memory-bound cells
        pspecs = _with_dtype(pspecs, param_dtype)

    def opt_spec(s: ParamSpec) -> ParamSpec:
        return ParamSpec(s.shape, state_dtype, s.logical_axes, init="zeros")

    return {
        "params": pspecs,
        "mu": tree_map(opt_spec, pspecs),
        "nu": tree_map(opt_spec, pspecs),
        "step": ParamSpec((), torch.int32, (), init="zeros"),
    }


def init_train_state(cfg: LMConfig, gen: torch.Generator, optimizer: AdamW):
    """Random parameters and zero moments on ``gen``'s device."""
    params = lm.init(cfg, gen)
    opt = optimizer.init(params)
    return {
        "params": params, "mu": opt.mu, "nu": opt.nu,
        "step": torch.zeros((), dtype=torch.int32, device=gen.device),
    }


def serving_param_specs(cfg: LMConfig, param_dtype=None):
    """Inference params (no masters needed): optionally bf16."""
    pspecs = lm.param_specs(cfg)
    return pspecs if param_dtype is None else _with_dtype(pspecs, param_dtype)


# ----------------------------------------------------------------- steps
def _split(tree, fn, depth: int) -> list:
    """``tree``'s stacked leaves split ``depth`` axes deep into (nested)
    lists of per-layer trees, ``fn`` applied to each layer's slice."""
    n = tree_leaves(tree)[0].shape[0]
    if depth == 1:
        return [tree_map(lambda a: fn(a[i]), tree) for i in range(n)]
    return [_split(tree_map(lambda a: a[i], tree), fn, depth - 1)
            for i in range(n)]


def _per_layer(tree, fn):
    """``tree`` with ``fn`` applied to every leaf, each stacked group
    (``lm.stack_depths``: "blocks", and vlm's "cross_blocks", hybrid's
    "rec_blocks", "attn_blocks", "tail_rec") split into lists of
    per-layer trees, nested for the two-axis groups."""
    depths = lm.stack_depths(tree)
    out = {k: tree_map(fn, v) for k, v in tree.items() if k not in depths}
    for k, depth in depths.items():
        out[k] = _split(tree[k], fn, depth)
    return out


def loss_and_grads(loss_fn, params, batch, accum_steps: int = 1,
                   accum_dtype=torch.float32):
    """``(loss, grads)`` of ``loss_fn(params, batch)``, the train step's
    value and gradient.

    ``grads`` has ``params``' tree (stacked leaves as stacked tensors).
    Each layer's slice of a stacked leaf reaches ``loss_fn`` as a leaf of
    its own, a view, each stacked group a list of per-layer trees
    (``_per_layer``); its gradient is copied into its slice of ``grads`` by a
    post-accumulate hook and freed.  With ``accum_steps`` > 1 the batch
    splits along dim 0 into micro-batches whose grads are summed in
    ``accum_dtype``, then both sums are divided by ``accum_steps``.
    """
    gdt = None if accum_steps == 1 else accum_dtype
    grads = tree_map(lambda p: torch.empty(
        p.shape, dtype=gdt or p.dtype, device=p.device), params)
    sinks = tree_leaves(_per_layer(grads, lambda a: a))
    written = [False] * len(sinks)

    def grads_into(mb):
        view = _per_layer(params, lambda a: a.detach().requires_grad_(True))
        leaves = tree_leaves(view)
        hooks = []
        for j, leaf in enumerate(leaves):
            def hook(t, j=j):
                if written[j]:
                    sinks[j].add_(t.grad)
                else:
                    sinks[j].copy_(t.grad)
                    written[j] = True
                t.grad = None
            hooks.append(leaf.register_post_accumulate_grad_hook(hook))
        try:
            loss = loss_fn(view, mb)
            torch.autograd.backward(loss, inputs=leaves)
        finally:
            for h in hooks:
                h.remove()
        return loss.detach()

    if accum_steps > 1:
        loss = torch.zeros((), dtype=torch.float32,
                           device=tree_leaves(params)[0].device)
        for k in range(accum_steps):
            mb = {name: x.reshape((accum_steps, -1) + x.shape[1:])[k]
                  for name, x in batch.items()}
            loss = loss + grads_into(mb)
    else:
        loss = grads_into(batch)
    with torch.no_grad():
        for sink, w in zip(sinks, written):
            if not w:  # a parameter the loss does not reach
                sink.zero_()
        if accum_steps > 1:
            for g in tree_leaves(grads):
                g.div_(accum_steps)
            loss = loss / accum_steps
    return loss, grads


def make_train_step(
    cfg: LMConfig,
    optimizer: AdamW,
    accum_steps: int = 1,
    accum_dtype=torch.float32,
    cast_params_to=None,
) -> Callable:
    """(state, batch) -> (state, metrics). batch dim 0 = global batch.

    The state is donated: its tensors are updated in place and returned.
    With ``accum_steps`` > 1 the batch splits into that many micro-batches
    along dim 0 (``loss_and_grads``).  ``metrics = {loss, grad_norm}``, the
    norm of the grads before clipping.  ``cast_params_to=bf16`` casts the
    f32 master params once per step before the forward; grads flow back
    through the cast to the masters.
    """

    def loss_fn(params, batch):
        if cast_params_to is not None:
            params = tree_map(
                lambda x: x.to(cast_params_to) if x.is_floating_point()
                else x, params)
        return lm.lm_loss(params, batch, cfg)

    def step(state, batch):
        params = state["params"]
        loss, grads = loss_and_grads(loss_fn, params, batch, accum_steps,
                                     accum_dtype)
        with torch.no_grad():
            gnorm = _global_norm(grads)
            new_p, new_opt = optimizer.update(
                grads, AdamWState(state["mu"], state["nu"]), params,
                state["step"], donate=True)
        new_state = {
            "params": new_p, "mu": new_opt.mu, "nu": new_opt.nu,
            "step": state["step"] + 1,
        }
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return step


def make_prefill_step(cfg: LMConfig) -> Callable:
    def prefill(params, batch):
        return lm.logits_fn(params, batch["tokens"], cfg, batch.get("vision"))

    return prefill


def make_decode_step(cfg: LMConfig) -> Callable:
    """``decode(params, cache, tokens, pos) -> (logits, cache)``; the cache
    is updated in place (``lm.decode_step``)."""
    def decode(params, cache, tokens, pos):
        return lm.decode_step(params, cache, tokens, pos, cfg)

    return decode


# ------------------------------------------------------ one-device "compile"
def compile_train_step(
    cfg: LMConfig,
    mesh,
    batch_specs: dict,
    optimizer: Optional[AdamW] = None,
    rules=None,
    accum_steps: int = 1,
    donate: bool = True,
    state_dtype=torch.float32,
    param_dtype=None,
    accum_dtype=torch.float32,
    cast_params_to=None,
    device=None,
):
    """Returns (step_fn, state_placement, batch_placement, state_specs).

    The reference jits the step over a mesh; the port has one device: both
    placements are that ``torch.device`` (``device``, the CUDA card unless
    named), where the caller puts the state and each batch.  ``mesh`` is
    None or a mesh of one device; LM tensor/FSDP parallelism is ROADMAP
    queue 1 item 5.  ``rules`` has nothing to place and is ignored.
    ``donate=False`` runs the step on a copy of the state.
    """
    if mesh is not None and math.prod(mesh_shape(mesh).values()) != 1:
        raise NotImplementedError(
            "compile_train_step: a mesh beyond one device (LM tensor/FSDP "
            "parallelism) is not ported yet (ROADMAP queue 1, item 5)")
    for name, s in batch_specs.items():
        if s.shape[0] % accum_steps:
            raise ValueError(f"batch {name} of {s.shape[0]} rows does not "
                             f"split into {accum_steps} micro-batches")
    dev = resolve_device(device)
    optimizer = optimizer or AdamW(lr=1e-4, grad_clip_norm=1.0,
                                   state_dtype=state_dtype)
    sspecs = train_state_specs(cfg, state_dtype=state_dtype,
                               param_dtype=param_dtype)
    base = make_train_step(cfg, optimizer, accum_steps, accum_dtype,
                           cast_params_to)
    if donate:
        return base, dev, dev, sspecs

    def fn(state, batch):
        return base(tree_map(torch.clone, state), batch)

    return fn, dev, dev, sspecs
