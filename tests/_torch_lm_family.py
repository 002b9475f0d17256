"""Shared checks of the LM family parity files (``test_torch_lm_moe.py``,
``test_torch_lm_hybrid.py``, ``test_torch_lm_vlm.py``), port vs JAX on the
CPU.

``Reference(arch)`` computes the JAX package's results of one smoke
config once (the files build it in a module-scoped fixture): parameters
from ``repro.models.lm.init`` (carried over through
``repro_torch.convert.lm_params_from_jax``), the logits, ``lm_loss`` and
its gradients, 18 decode steps with the reference test's recipe
(``tests/test_lm_decode.py``: the moe capacity factor lifted to
``n_experts``, vlm's ``xk``/``xv`` filled from the vision states), three
``jax.jit(make_train_step)`` steps at accum 1 and 2, and the bf16 loss
and gradients (op by op for moe).  The ``check_*`` functions run the port on the same
inputs and hold it to the tolerances below (max|port - jax| over
max|jax| of each leaf).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import get_config as jget
from repro.models import lm as jlm
from repro.optim import AdamW as JAdamW
from repro.optim import warmup_cosine as jwarmup
from repro.runtime import steps as jsteps
from repro_torch.convert import lm_params_from_jax, lm_train_state_from_jax
from repro_torch.models import get_config as tget
from repro_torch.models import lm as tlm
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.runtime import steps as tsteps
from repro_torch.tree import tree_leaves, tree_map, tree_paths

RTOL = 1e-5  # f32: values, gradients, decode, train steps
ZERO_INIT_RTOL = 1e-2  # params of zero-initialised leaves after AdamW steps
BF16_LOSS_RTOL = 1e-2  # the configs' own dtype (test_torch_lm_train.py's)
BF16_GRAD_RTOL = 0.15
DECODE_RTOL = 1e-4  # decode vs prefill, the reference test's own bound
DECODE_STEPS, CACHE_LEN = 18, 24
ACCUMS = (1, 2)
TRAIN_STEPS = 3


def rel(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.max(np.abs(want))
    return float(np.max(np.abs(got - want)) / (scale if scale else 1.0))


def cfgs(arch, dtype="float32", **kw):
    """(jax cfg, port cfg) of an arch's smoke config in ``dtype``."""
    jc = dataclasses.replace(jget(arch, smoke=True),
                             dtype=getattr(jnp, dtype), **kw)
    tc = dataclasses.replace(tget(arch, smoke=True),
                             dtype=getattr(torch, dtype), **kw)
    return jc, tc


def batch(cfg, B=4, S=37, seed=0, pad_rows=True):
    """(jax batch, port batch) of seeded tokens and labels (and f32
    vision states for vlm, as the launcher feeds them)."""
    r = np.random.default_rng(seed)
    arrs = {"tokens": r.integers(0, cfg.vocab, (B, S)).astype(np.int32),
            "labels": r.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if pad_rows:
        arrs["labels"][0, :5] = -1
        arrs["labels"][-1, -3:] = -1
    if cfg.family == "vlm":
        arrs["vision"] = r.standard_normal(
            (B, cfg.vision_seq, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrs.items()},
            {k: torch.from_numpy(v) for k, v in arrs.items()})


def _optimizers():
    """The launcher's optimizer on both sides (lr 3e-4, warmup 20)."""
    kw = dict(weight_decay=0.01, grad_clip_norm=1.0)
    return (JAdamW(lr=jwarmup(3e-4, 20, 100), **kw),
            AdamW(lr=warmup_cosine(3e-4, 20, 100), **kw))


def loss_and_grads(tp, tb, tc):
    """The port's lm_loss and autograd's gradient of every leaf."""
    params = tree_map(lambda t: t.detach().requires_grad_(True), tp)
    leaves = tree_leaves(params)
    loss = tlm.lm_loss(params, tb, tc)
    return loss.detach(), torch.autograd.grad(loss, leaves)


def decode_cfg(cfg):
    """The reference test's decode config: no capacity drops for moe."""
    if cfg.family == "moe":
        return dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    return cfg


def vision_cache(cfg, params, vision):
    """vlm's ``xk``/``xv``: each period's cross K/V of ``vision`` (numpy,
    the reference test's einsum)."""
    out = {}
    for name, w in (("xk", "wk"), ("xv", "wv")):
        wt = np.asarray(params["cross_blocks"]["xattn"][w], np.float32)
        kv = np.einsum("bsd,ldk->lbsk", vision, wt)
        out[name] = kv.reshape(kv.shape[:3] + (cfg.n_kv_heads,
                                               cfg.head_dim))
    return out


class Reference:
    """The JAX package's results of ``arch``'s smoke config in f32;
    ``prepare(params)`` may set parameters first (vlm's gates)."""

    def __init__(self, arch, prepare=None):
        self.arch = arch
        self.jc, self.tc = cfgs(arch)
        jc = self.jc
        jp = jlm.init(jc, jax.random.PRNGKey(0))
        if prepare is not None:
            jp = prepare(jp)
        self.jp = jp
        self.np_params = jax.tree.map(np.asarray, jp)
        self.tp = lm_params_from_jax(self.np_params, device="cpu")
        self.jb, self.tb = batch(jc)
        vis = self.jb.get("vision")
        self.logits = np.asarray(jlm.logits_fn(jp, self.jb["tokens"], jc,
                                               vis))
        loss, grads = jax.value_and_grad(
            lambda p: jlm.lm_loss(p, self.jb, jc))(jp)
        self.loss, self.grads = float(loss), jax.tree.leaves(grads)
        self._decode()
        self._train_steps()
        self._bf16(prepare)

    def _decode(self):
        jc = decode_cfg(self.jc)
        r = np.random.default_rng(1)
        self.dec_tokens = r.integers(0, jc.vocab, (2, DECODE_STEPS))
        self.dec_vision = (r.standard_normal((2, jc.vision_seq, jc.d_model))
                           .astype(np.float32) if jc.family == "vlm"
                           else None)
        vis = (None if self.dec_vision is None
               else jnp.asarray(self.dec_vision))
        toks = jnp.asarray(self.dec_tokens, jnp.int32)
        self.dec_prefill = np.asarray(jlm.logits_fn(self.jp, toks, jc, vis))
        cache = jlm.init_cache(jc, 2, CACHE_LEN)
        if jc.family == "vlm":
            cache.update({k: jnp.asarray(v) for k, v in vision_cache(
                jc, self.np_params, self.dec_vision).items()})
        step = jax.jit(lambda p, c, t, pos: jlm.decode_step(p, c, t, pos,
                                                            jc))
        outs = []
        for t in range(DECODE_STEPS):
            logits, cache = step(self.jp, cache, toks[:, t:t + 1],
                                 jnp.int32(t))
            outs.append(np.asarray(logits[:, 0]))
        self.dec_logits = np.stack(outs, 1)
        self.dec_cache = {k: np.asarray(v) for k, v in cache.items()}

    def _train_steps(self):
        jopt, _ = _optimizers()
        self.steps = {}
        for accum in ACCUMS:
            state = jsteps.init_train_state(self.jc, jax.random.PRNGKey(0),
                                            jopt)
            state["params"] = self.jp
            start = jax.tree.map(np.asarray, state)
            fn = jax.jit(jsteps.make_train_step(self.jc, jopt,
                                                accum_steps=accum))
            metrics = []
            for i in range(TRAIN_STEPS):
                jb, _ = batch(self.jc, seed=10 + i, pad_rows=False)
                state, m = fn(state, jb)
                metrics.append({k: float(v) for k, v in m.items()})
            self.steps[accum] = (start, metrics, jax.tree.leaves(
                state["params"]))

    def _bf16(self, prepare):
        jc, _ = cfgs(self.arch, dtype="bfloat16")
        if jc.family == "moe":
            # op by op: XLA's fused scan body rounds bf16 at other places
            # and re-routes tokens whose top-k margin is that small
            # (test_torch_lm_moe.py); remat only recomputes the same values
            jc = dataclasses.replace(jc, remat=False)
            with jax.disable_jit():
                loss, grads = jax.value_and_grad(
                    lambda p: jlm.lm_loss(p, self.jb, jc))(self.jp)
            self.bf16_loss, self.bf16_grads = float(loss), jax.tree.leaves(
                grads)
            return
        loss, grads = jax.value_and_grad(
            lambda p: jlm.lm_loss(p, self.jb, jc))(self.jp)
        self.bf16_loss, self.bf16_grads = float(loss), jax.tree.leaves(grads)


# ------------------------------------------------------------------ checks
def check_logits(ref: Reference) -> None:
    got = tlm.logits_fn(ref.tp, ref.tb["tokens"], ref.tc,
                        ref.tb.get("vision"))
    assert rel(got, ref.logits) <= RTOL


def check_loss_and_grads(ref: Reference) -> None:
    loss, grads = loss_and_grads(ref.tp, ref.tb, ref.tc)
    assert abs(float(loss) - ref.loss) <= RTOL * abs(ref.loss)
    for path, got, want in zip(tree_paths(ref.tp), grads, ref.grads):
        assert rel(got, want) <= RTOL, path


def check_split_grads(ref: Reference) -> None:
    """The train step's ``loss_and_grads`` hands every stacked group to
    autograd one layer at a time (nested lists for the two-axis groups):
    its loss and gradients are autograd's of the stacked leaves, bit for
    bit, and the caller's parameters are left as they were."""
    want_l, want = loss_and_grads(ref.tp, ref.tb, ref.tc)
    seen = []

    def loss_fn(p, b):
        seen.append({k: p[k] for k in tlm.stack_depths(p)})
        return tlm.lm_loss(p, b, ref.tc)

    loss, grads = tsteps.loss_and_grads(loss_fn, ref.tp, ref.tb)
    assert torch.equal(loss, want_l)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads), want))
    for k, depth in tlm.stack_depths(ref.tp).items():
        group = seen[0][k]
        for _ in range(depth):
            assert isinstance(group, list)
            group = group[0]
        assert isinstance(group, dict)
    assert not any(t.requires_grad or t.grad is not None
                   for t in tree_leaves(ref.tp))


def check_decode(ref: Reference) -> None:
    """18 decode steps: each step's logits and the final cache against
    the reference's, and against the port's own prefill."""
    tc = decode_cfg(ref.tc)
    toks = torch.from_numpy(ref.dec_tokens)
    vis = (None if ref.dec_vision is None
           else torch.from_numpy(ref.dec_vision))
    prefill = tlm.logits_fn(ref.tp, toks, tc, vis)
    assert rel(prefill, ref.dec_prefill) <= RTOL
    cache = tlm.init_cache(tc, 2, CACHE_LEN)
    if tc.family == "vlm":
        cache.update({k: torch.from_numpy(v) for k, v in vision_cache(
            tc, ref.np_params, ref.dec_vision).items()})
    step = tsteps.make_decode_step(tc)
    outs = []
    for t in range(DECODE_STEPS):
        logits, again = step(ref.tp, cache, toks[:, t:t + 1], t)
        assert again is cache  # updated in place
        assert rel(logits[:, 0], ref.dec_logits[:, t]) <= RTOL, t
        outs.append(logits[:, 0])
    assert sorted(cache) == sorted(ref.dec_cache)
    for k in cache:
        assert rel(cache[k], ref.dec_cache[k]) <= RTOL, k
    assert rel(torch.stack(outs, 1), prefill.detach().numpy()) < DECODE_RTOL


def check_train_steps(ref: Reference, accum: int) -> None:
    """Three make_train_step steps against jax.jit of the reference's:
    losses and grad norms at RTOL, params at RTOL (zero-initialised
    leaves at ZERO_INIT_RTOL, test_torch_lm_train.py says why)."""
    _, topt = _optimizers()
    start, metrics, want_params = ref.steps[accum]
    state = lm_train_state_from_jax(start, device="cpu")
    fn = tsteps.make_train_step(ref.tc, topt, accum_steps=accum)
    for i, want in enumerate(metrics):
        _, tb = batch(ref.jc, seed=10 + i, pad_rows=False)
        state, m = fn(state, tb)
        for k in ("loss", "grad_norm"):
            assert abs(float(m[k]) - want[k]) <= RTOL * abs(want[k]), (
                i, k, float(m[k]), want[k])
    assert int(state["step"]) == TRAIN_STEPS
    inits = [s.init for s in tree_leaves(tlm.param_specs(ref.tc))]
    for init, path, got, want in zip(inits, tree_paths(state["params"]),
                                     tree_leaves(state["params"]),
                                     want_params):
        tol = ZERO_INIT_RTOL if init == "zeros" else RTOL
        assert rel(got, want) <= tol, path


def check_bf16(ref: Reference, exempt=()) -> tuple:
    """The configs' own dtype: the loss within BF16_LOSS_RTOL and every
    gradient but those of the leaves in ``exempt`` (paths, printed) within
    BF16_GRAD_RTOL of its max.  Returns (loss gap, largest held gradient
    gap), printed."""
    _, tc = cfgs(ref.arch, dtype="bfloat16")
    loss, grads = loss_and_grads(ref.tp, ref.tb, tc)
    loss_rel = abs(float(loss) - ref.bf16_loss) / abs(ref.bf16_loss)
    gaps = {path: rel(a, b) for path, a, b in zip(
        tree_paths(ref.tp), grads, ref.bf16_grads)}
    assert set(exempt) <= set(gaps), set(exempt) - set(gaps)
    grad_rel = max(g for path, g in gaps.items() if path not in exempt)
    print(f"{ref.arch} bf16: loss rel {loss_rel:.3e}, held grads rel "
          f"{grad_rel:.3e}; exempt "
          f"{ {path: round(gaps[path], 4) for path in exempt} }")
    assert loss.dtype == torch.float32
    assert loss_rel <= BF16_LOSS_RTOL
    assert grad_rel <= BF16_GRAD_RTOL
    return loss_rel, grad_rel
