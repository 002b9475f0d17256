"""AdamW + SGD optimizers (``repro.optim.adamw`` on torch).

An optimizer is a pair of pure functions over nested dicts of tensors:

    init(params) -> state
    update(grads, state, params, step) -> (new_params, new_state)

``update`` returns new tensors and leaves its arguments untouched.  The
AdamW step is the reference's formula term for term,
``p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)`` with the bias
corrections ``c1``, ``c2`` taken from ``step + 1`` in float32, so the port
tracks the JAX package step for step; ``torch.optim.AdamW`` decays first
and divides ``sqrt(v)`` by ``sqrt(c2)``, which rounds differently.
``step`` may be an int or a device tensor (the guarded chunk driver keeps
its counter on the card).  ``state_dtype`` (bf16 moments) and the blocked
update of leaves above ``scan_threshold`` are the reference's; the LM
train step (``repro_torch.runtime.steps``) updates with ``donate=True``,
in place, as the reference's jit donates the train state.  On an LM mesh
``update`` runs unchanged on each rank's blocks; only the global norm
of gradient clipping needs the leaves' placements (``pspecs``, ``mesh``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch.runtime import sharding as shd
from repro_torch.runtime.collectives import all_reduce_sum
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


class AdamWState(NamedTuple):
    mu: Any
    nu: Any


def _step_f32(step, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(step, device=like.device).to(torch.float32)


def _chunks(n: int, cap: int = 32) -> int:
    """Largest divisor of ``n`` that is <= ``cap`` (1 => no blocking)."""
    for d in range(min(cap, n), 0, -1):
        if n % d == 0:
            return d
    return 1


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 1e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip_norm: Optional[float] = None
    state_dtype: Any = torch.float32  # bf16 option halves optimizer memory
    # leaves bigger than this are updated one axis-0 block at a time (the
    # reference's ``_chunks``: the largest divisor of dim 0 up to 32), so
    # the float32 working copies are one block, not the whole stacked
    # tensor; the blocks compute what the whole leaf would, bit for bit
    scan_threshold: int = 1 << 26

    def _lr(self, step):
        return self.lr(step) if callable(self.lr) else self.lr

    def init(self, params) -> AdamWState:
        z = lambda p: torch.zeros(p.shape, dtype=self.state_dtype,  # noqa: E731
                                  device=p.device)
        return AdamWState(mu=tree_map(z, params), nu=tree_map(z, params))

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, step, *,
               donate: bool = False, pspecs=None, mesh=None):
        """``(new_params, new_state)``.  With ``donate`` the params, the
        moments and the grads are the caller's to give up: clipping scales
        the grads in place and the new values are written into the params'
        and moments' own tensors (the reference's donated buffers), so the
        update allocates nothing of a leaf's size.  Without it the
        arguments are left untouched.  On a mesh the trees are this rank's
        blocks and ``pspecs``/``mesh`` their placements (for the norm)."""
        if self.grad_clip_norm is not None:
            grads = clip_by_global_norm(grads, self.grad_clip_norm,
                                        inplace=donate, pspecs=pspecs,
                                        mesh=mesh)
        b1, b2 = self.b1, self.b2
        sd = self.state_dtype
        flat_p = tree_leaves(params)
        stp = _step_f32(step, flat_p[0]) + 1.0
        c1 = 1.0 - b1 ** stp
        c2 = 1.0 - b2 ** stp
        lr = self._lr(step)

        def upd(p, g, m, v):
            g = g.to(torch.float32)
            m = b1 * m.to(torch.float32) + (1 - b1) * g
            v = b2 * v.to(torch.float32) + (1 - b2) * g * g
            mh = m / c1
            vh = v / c2
            delta = mh / (torch.sqrt(vh) + self.eps)
            pf = p.to(torch.float32)
            new_p = pf - lr * (delta + self.weight_decay * pf)
            return new_p.to(p.dtype), m.to(sd), v.to(sd)

        def upd_leaf(p, g, m, v):
            nb = _chunks(p.shape[0]) if p.dim() >= 2 else 1
            blocked = p.numel() > self.scan_threshold and nb > 1
            if not (blocked or donate):
                return upd(p, g, m, v)
            if not donate:  # the blocks write into copies
                p, m, v = p.clone(), m.to(sd, copy=True), v.to(sd, copy=True)
            rows = p.shape[0] // nb if blocked else None
            blocks = ([(slice(r, r + rows),)
                       for r in range(0, p.shape[0], rows)]
                      if blocked else [()])
            for sl in blocks:
                for dst, val in zip((p, m, v),
                                    upd(p[sl], g[sl], m[sl], v[sl])):
                    dst[sl] = val
            return p, m, v

        out = [upd_leaf(p, g, m, v) for p, g, m, v in zip(
            flat_p, tree_leaves(grads), tree_leaves(state.mu),
            tree_leaves(state.nu))]
        new_p = tree_unflatten(params, [o[0] for o in out])
        new_m = tree_unflatten(params, [o[1] for o in out])
        new_v = tree_unflatten(params, [o[2] for o in out])
        return new_p, AdamWState(new_m, new_v)


@dataclasses.dataclass(frozen=True)
class SGD:
    lr: Callable | float = 1e-2
    momentum: float = 0.0
    grad_clip_norm: Optional[float] = None

    def init(self, params):
        if self.momentum == 0.0:
            return ()
        return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                        params)

    @torch.no_grad()
    def update(self, grads, state, params, step):
        if self.grad_clip_norm is not None:
            grads = clip_by_global_norm(grads, self.grad_clip_norm)
        lr = self.lr(step) if callable(self.lr) else self.lr
        if self.momentum == 0.0:
            new_p = tree_map(
                lambda p, g: (p.to(torch.float32) - lr * g).to(p.dtype),
                params, grads)
            return new_p, ()
        new_s = tree_map(
            lambda s, g: self.momentum * s + g.to(torch.float32), state,
            grads)
        new_p = tree_map(
            lambda p, s: (p.to(torch.float32) - lr * s).to(p.dtype),
            params, new_s)
        return new_p, new_s


def global_norm(tree, pspecs=None, mesh=None) -> torch.Tensor:
    """The global norm of a tree; with ``pspecs``/``mesh`` (a tree of this
    rank's blocks and their spec tuples) of the global leaves: each block's
    sum of squares is summed over the ranks that hold different blocks and
    counted once over those that hold the same one (a leaf replicated on
    ``model``, such as a norm scale, is not counted twice)."""
    if mesh is None or pspecs is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                              for x in tree_leaves(tree)))
    sizes = shd.mesh_shape(mesh)

    def share(x, spec):
        copies = math.prod(sizes[a] for a in shd.replicated_axes(spec, mesh))
        return torch.sum(torch.square(x.to(torch.float32))) / copies

    tot = sum(tree_leaves(tree_map(share, tree, pspecs)))
    if math.prod(sizes.values()) > 1:
        tot = all_reduce_sum(tot, dist.group.WORLD)
    return torch.sqrt(tot)


def clip_by_global_norm(grads, max_norm: float, inplace: bool = False,
                        pspecs=None, mesh=None):
    """Grads scaled to a global norm of at most ``max_norm``; ``inplace``
    scales the caller's tensors (the same products, written back).  On a
    mesh ``pspecs``/``mesh`` place the blocks (``global_norm``)."""
    norm = global_norm(grads, pspecs, mesh)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    if inplace:
        for g in tree_leaves(grads):
            g.mul_(scale)
        return grads
    return tree_map(lambda g: (g * scale).to(g.dtype), grads)
