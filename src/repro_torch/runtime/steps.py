"""LM train, prefill and decode steps (port of ``repro.runtime.steps``).

``TrainState`` is a plain dict ``{params, mu, nu, step}``; the moments
reuse the parameters' ParamSpecs.  The steps are plain functions over
tensors: there is no jit and no ``torch.compile``; the tensors' device
decides where they run.

On a ``(data, model)`` mesh of ``torch.distributed`` ranks
(``compile_*_step(cfg, mesh, ...)``) every rank runs the same step on its
blocks: each parameter, moment and cache leaf is placed by the rules
table through ``runtime.sharding.resolve_pspec`` (the placements returned
are spec tuples; ``sharding.local_tree`` cuts a global tree to them) and
the models run under ``sharding.activation_sharding``.  The train step
differentiates the rank's share of the loss; the collectives' backwards
reduce the gradients of gathered blocks, and after the backward each
leaf's gradient is summed, in tree order, over the mesh axes the leaf is
held whole on.  The metrics are the global loss and grad norm.

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
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import LMConfig
from repro_torch.nn import ParamSpec
from repro_torch.optim import AdamW
from repro_torch.optim.adamw import AdamWState
from repro_torch.optim.adamw import global_norm as _global_norm
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.collectives import all_gather_dim, all_reduce_sum
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


def init_train_state(cfg: LMConfig, gen: torch.Generator, optimizer: AdamW,
                     mesh=None, rules=None):
    """Random parameters and zero moments on ``gen``'s device; with
    ``mesh``, this rank's blocks (``lm.init``)."""
    params = lm.init(cfg, gen, _multi_rank(mesh), rules)
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


def _reduce_replicated(grads, pspecs, mesh) -> None:
    """Each leaf's gradient summed, in place and in tree order, over the
    mesh axes the leaf is held whole on (the ranks' shares of it)."""
    def reduce(g, spec):
        axes = shd.replicated_axes(spec, mesh)
        if axes:
            g.copy_(all_reduce_sum(g, shd.axes_group(mesh, axes)))
    tree_map(reduce, grads, pspecs)


def _micro_batches(batch, accum_steps: int, ctx):
    """The ``accum_steps`` micro-batches of this rank's block: on a mesh
    whose batch is split over ``data``, the rank's block of each of the
    global batch's micro-batches (the unsharded run's), gathered first."""
    g = ctx.group("data") if ctx is not None and ctx.batch_sharded else None
    parts = {}
    for name, x in batch.items():
        if g is not None:
            x = all_gather_dim(x.contiguous(), g, 0)
        parts[name] = x.reshape((accum_steps, -1) + x.shape[1:])
        if g is not None:
            n, i = ctx.size("data"), ctx.index("data")
            if parts[name].shape[1] % n:
                raise ValueError(
                    f"a micro-batch of {parts[name].shape[1]} rows does not "
                    f"split over the {n} data ranks")
            size = parts[name].shape[1] // n
            parts[name] = parts[name][:, i * size:(i + 1) * size]
    return [{name: x[k] for name, x in parts.items()}
            for k in range(accum_steps)]


def loss_and_grads(loss_fn, params, batch, accum_steps: int = 1,
                   accum_dtype=torch.float32, pspecs=None, mesh=None):
    """``(loss, grads)`` of ``loss_fn(params, batch)``, the train step's
    value and gradient.

    ``grads`` has ``params``' tree (stacked leaves as stacked tensors).
    Each layer's slice of a stacked leaf reaches ``loss_fn`` as a leaf of
    its own, a view, each stacked group a list of per-layer trees
    (``_per_layer``); its gradient is copied into its slice of ``grads`` by a
    post-accumulate hook and freed.  With ``accum_steps`` > 1 the batch
    splits along dim 0 into micro-batches whose grads are summed in
    ``accum_dtype``, then both sums are divided by ``accum_steps``.

    On a mesh (``pspecs``: the params' spec tuples; under
    ``activation_sharding``) ``loss_fn`` gives this rank's share of the
    loss: the returned loss is the shares' sum over every rank, and each
    gradient is summed over the axes its leaf is held whole on after the
    backward, in tree order (no collective runs in a hook, so a leaf that
    one rank's graph does not reach cannot stall another rank).
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

    ctx = shd.active() if mesh is not None else None
    if accum_steps > 1:
        loss = torch.zeros((), dtype=torch.float32,
                           device=tree_leaves(params)[0].device)
        for mb in _micro_batches(batch, accum_steps, ctx):
            loss = loss + grads_into(mb)
    else:
        loss = grads_into(batch)
    with torch.no_grad():
        for sink, w in zip(sinks, written):
            if not w:  # a parameter the loss does not reach
                sink.zero_()
        if ctx is not None:
            _reduce_replicated(grads, pspecs, mesh)
            loss = all_reduce_sum(loss, dist.group.WORLD)
        if accum_steps > 1:
            for g in tree_leaves(grads):
                g.div_(accum_steps)
            loss = loss / accum_steps
    return loss, grads


def _multi_rank(mesh):
    """``mesh`` when it spans more than one rank, else None (one-device
    code)."""
    if mesh is None or math.prod(mesh_shape(mesh).values()) == 1:
        return None
    return mesh


def make_train_step(
    cfg: LMConfig,
    optimizer: AdamW,
    accum_steps: int = 1,
    accum_dtype=torch.float32,
    cast_params_to=None,
    mesh=None,
    rules=None,
    batch_sharded: bool = True,
) -> Callable:
    """(state, batch) -> (state, metrics). batch dim 0 = global batch.

    The state is donated: its tensors are updated in place and returned.
    With ``accum_steps`` > 1 the batch splits into that many micro-batches
    along dim 0 (``loss_and_grads``).  ``metrics = {loss, grad_norm}``, the
    norm of the grads before clipping.  ``cast_params_to=bf16`` casts the
    f32 master params once per step before the forward; grads flow back
    through the cast to the masters.  With a ``mesh`` of more than one
    rank the state is this rank's blocks (placed as ``compile_train_step``
    places them) and ``batch_sharded`` says whether the batch is too.
    """
    mesh = _multi_rank(mesh)
    pspecs = (None if mesh is None
              else shd.tree_shardings(lm.param_specs(cfg), mesh, rules))

    def loss_fn(params, batch):
        if cast_params_to is not None:
            params = tree_map(
                lambda x: x.to(cast_params_to) if x.is_floating_point()
                else x, params)
        return lm.lm_loss(params, batch, cfg)

    def step(state, batch):
        with shd.activation_sharding(mesh, rules,
                                     batch_sharded=batch_sharded):
            return run(state, batch)

    def run(state, batch):
        params = state["params"]
        loss, grads = loss_and_grads(loss_fn, params, batch, accum_steps,
                                     accum_dtype, pspecs, mesh)
        with torch.no_grad():
            gnorm = _global_norm(grads, pspecs, mesh)
            new_p, new_opt = optimizer.update(
                grads, AdamWState(state["mu"], state["nu"]), params,
                state["step"], donate=True, pspecs=pspecs, mesh=mesh)
        new_state = {
            "params": new_p, "mu": new_opt.mu, "nu": new_opt.nu,
            "step": state["step"] + 1,
        }
        return new_state, {"loss": loss, "grad_norm": gnorm}

    return step


def make_prefill_step(cfg: LMConfig, mesh=None, rules=None,
                      batch_sharded: bool = True) -> Callable:
    """``prefill(params, batch) -> logits``; on a mesh of more than one
    rank, this rank's block of them (``compile_prefill_step``)."""
    mesh = _multi_rank(mesh)

    def prefill(params, batch):
        with shd.activation_sharding(mesh, rules,
                                     batch_sharded=batch_sharded):
            return lm.logits_fn(params, batch["tokens"], cfg,
                                batch.get("vision"))

    return prefill


def make_decode_step(cfg: LMConfig, mesh=None, rules=None,
                     batch_sharded: bool = True) -> Callable:
    """``decode(params, cache, tokens, pos) -> (logits, cache)``; the cache
    is updated in place (``lm.decode_step``).  On a mesh of more than one
    rank the params and the cache are this rank's blocks and the logits
    its block (``compile_decode_step``)."""
    mesh = _multi_rank(mesh)

    def decode(params, cache, tokens, pos):
        with shd.activation_sharding(mesh, rules,
                                     batch_sharded=batch_sharded):
            return lm.decode_step(params, cache, tokens, pos, cfg)

    return decode


# ---------------------------------------------------------------- "compile"
def _batch_places(mesh, batch_specs: dict, rules) -> tuple:
    """({name: spec tuple}, whether dim 0 is split over ``data``)."""
    places = {name: shd.batch_sharding(mesh, len(s.shape), rules,
                                       batch_size=s.shape[0])
              for name, s in batch_specs.items()}
    split = {p[0] is not None for p in places.values()}
    if len(split) > 1:
        raise ValueError(f"batch entries {sorted(batch_specs)} of different "
                         "row counts would split differently over 'data'")
    return places, split.pop() if split else True


def logits_sharding(cfg: LMConfig, mesh, batch: int, rules=None) -> tuple:
    """The logits' placement, the reference's ``out_shardings``: batch over
    ``data`` where it divides, vocab over ``model``."""
    return shd.resolve_pspec((batch, 1, cfg.vocab), ("batch", None, "vocab"),
                             mesh, rules)


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

    Without a mesh, or on a mesh of one rank, both placements are the
    ``torch.device`` (``device``, the CUDA card unless named) where the
    caller puts the state and each batch.  On a mesh of more than one
    rank they are spec trees (``sharding.tree_shardings`` of the state
    specs, ``sharding.batch_sharding`` of each batch entry): the caller
    puts this rank's block of each leaf (``sharding.local_tree``) on
    ``device``.  ``donate=False`` runs the step on a copy of the state.
    """
    dev = resolve_device(device)
    for name, s in batch_specs.items():
        if s.shape[0] % accum_steps:
            raise ValueError(f"batch {name} of {s.shape[0]} rows does not "
                             f"split into {accum_steps} micro-batches")
    optimizer = optimizer or AdamW(lr=1e-4, grad_clip_norm=1.0,
                                   state_dtype=state_dtype)
    sspecs = train_state_specs(cfg, state_dtype=state_dtype,
                               param_dtype=param_dtype)
    mesh = _multi_rank(mesh)
    if mesh is None:
        s_place = b_place = dev
        split = True
    else:
        s_place = shd.tree_shardings(sspecs, mesh, rules)
        b_place, split = _batch_places(mesh, batch_specs, rules)
    base = make_train_step(cfg, optimizer, accum_steps, accum_dtype,
                           cast_params_to, mesh=mesh, rules=rules,
                           batch_sharded=split)
    if donate:
        return base, s_place, b_place, sspecs

    def fn(state, batch):
        return base(tree_map(torch.clone, state), batch)

    return fn, s_place, b_place, sspecs


def compile_prefill_step(cfg: LMConfig, mesh, batch_specs: dict, rules=None,
                         param_dtype=None, device=None):
    """Returns (prefill_fn, param_placement, batch_placement, param_specs);
    the placements as ``compile_train_step``'s.  On a mesh the logits are
    this rank's block under ``logits_sharding`` (the whole sequence)."""
    dev = resolve_device(device)
    pspecs = serving_param_specs(cfg, param_dtype)
    mesh = _multi_rank(mesh)
    if mesh is None:
        return make_prefill_step(cfg), dev, dev, pspecs
    b_place, split = _batch_places(mesh, batch_specs, rules)
    return (make_prefill_step(cfg, mesh, rules, split),
            shd.tree_shardings(pspecs, mesh, rules), b_place, pspecs)


def compile_decode_step(cfg: LMConfig, mesh, batch: int, cache_len: int,
                        rules=None, donate: bool = True, device=None):
    """Returns (decode_fn, param_placement, cache_placement, cache_specs).

    ``decode_fn(params, cache, tokens, pos) -> (logits, cache)``, the cache
    updated in place (``donate=False``: a copy of it).  On a mesh of more
    than one rank the placements are spec trees (the cache's batch over
    ``data`` where ``batch`` divides, ``kv_heads`` over ``model`` or the
    ``head`` fallback) and the logits this rank's block under
    ``logits_sharding``."""
    dev = resolve_device(device)
    cspecs = lm.cache_specs(cfg, batch, cache_len)
    mesh = _multi_rank(mesh)
    if mesh is None:
        base, p_place, c_place = make_decode_step(cfg), dev, dev
    else:
        tok = shd.batch_sharding(mesh, 2, rules, batch_size=batch)
        base = make_decode_step(cfg, mesh, rules, tok[0] is not None)
        p_place = shd.tree_shardings(lm.param_specs(cfg), mesh, rules)
        c_place = shd.tree_shardings(cspecs, mesh, rules)
    if donate:
        return base, p_place, c_place, cspecs

    def fn(params, cache, tokens, pos):
        return base(params, tree_map(torch.clone, cache), tokens, pos)

    return fn, p_place, c_place, cspecs
