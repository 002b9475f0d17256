"""The port's LM slice on a ``(data, model)`` mesh against its own one-rank
run, all six families, on the CPU.

The mesh cases run on gloo ranks: one spawn of each mesh shape, (1, 2),
(2, 1) and (2, 2), the three started together, each rank running every
family's case (``_torch_lm_mesh_worker.run_cases``) and returning
gathered numpy results; a hung collective fails the fixture at its join
timeout.  The one-rank results are the port's own, computed in this
process on the same f32 parameters (the port's ``lm.init``, vlm's cross
gates opened) and inputs: the one-rank port is held against the JAX
package by ``test_torch_lm*.py``, so no JAX function is compiled here.
The leaf placements are held against the JAX package's
``resolve_pspec`` on a (2, 2) mesh of repeated CPU devices.

Tolerances (max|mesh - one rank| / max|one rank| a leaf), f32:
- prefill logits, 4 decode steps and the cache they leave, ``lm_loss``
  and every gradient: 1e-5 (measured up to 2.7e-6);
- one train step at the launcher's optimizer (lr 3e-4, warmup 20, wd
  0.01, clip 1): loss and grad norm 1e-5, params 1e-5 except the leaves
  initialised at zero (``test_torch_lm_train.py``'s convention, 1e-2).
"""
import concurrent.futures
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _torch_cores import share_cores  # noqa: E402

share_cores(torch)

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from _torch_lm_mesh_worker import (  # noqa: E402
    family_case, one_rank, run_cases,
)
from repro.models import get_config as jget  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.nn import is_spec  # noqa: E402
from repro.runtime import sharding as jshd  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.runtime.collectives import spawn_ranks  # noqa: E402
from repro_torch.tree import tree_leaves, tree_paths  # noqa: E402

RTOL = 1e-5
ZERO_INIT_RTOL = 1e-2
ARCHS = ("qwen1.5-4b", "falcon-mamba-7b", "musicgen-medium", "mixtral-8x7b",
         "recurrentgemma-9b", "llama-3.2-vision-11b")
MESHES = ((1, 2), (2, 1), (2, 2))
B, S = 2, 8  # batch rows split over data, the sequence over model
DEC_B, DEC_STEPS, CACHE_LEN = 2, 4, 8
JOIN_TIMEOUT_S = 240.0


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


@pytest.fixture(scope="module")
def cases():
    inputs = {arch: family_case(arch, i, B, S, DEC_B, DEC_STEPS, CACHE_LEN)
              for i, arch in enumerate(ARCHS)}
    return inputs, {arch: one_rank(c) for arch, c in inputs.items()}


@pytest.fixture(scope="module")
def ranks(cases):
    """Rank 0's results on each mesh; the three spawns run together."""
    inputs, _ = cases
    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:
        futs = {m: pool.submit(spawn_ranks, run_cases, m[0] * m[1],
                               (m[0], m[1], inputs), timeout=JOIN_TIMEOUT_S)
                for m in MESHES}
        return {m: f.result()[0] for m, f in futs.items()}


def _ids(meshes):
    return [f"{d}x{m}" for d, m in meshes]


def _hold_tree(got, want, tol=RTOL, zero_tol=None, cfg=None):
    inits = ([s.init for s in tree_leaves(lm.param_specs(cfg))]
             if cfg is not None else [None] * len(tree_leaves(want)))
    for init, path, g, w in zip(inits, tree_paths(want), tree_leaves(got),
                                tree_leaves(want)):
        t = zero_tol if zero_tol is not None and init == "zeros" else tol
        assert rel(g, w) <= t, (path, rel(g, w))


# ------------------------------------------------------------- mesh cases
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=_ids(MESHES))
def test_prefill_and_decode_match_one_rank(ranks, cases, mesh, arch):
    got, want = ranks[mesh][arch], cases[1][arch]
    assert rel(got["logits"], want["logits"]) <= RTOL
    assert rel(got["decode"], want["decode"]) <= RTOL
    assert sorted(got["cache"]) == sorted(want["cache"])
    _hold_tree(got["cache"], want["cache"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=_ids(MESHES))
def test_loss_and_grads_match_one_rank(ranks, cases, mesh, arch):
    got, want = ranks[mesh][arch], cases[1][arch]
    assert abs(got["loss"] - want["loss"]) <= RTOL * abs(want["loss"])
    _hold_tree(got["grads"], want["grads"])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", MESHES, ids=_ids(MESHES))
def test_train_step_matches_one_rank(ranks, cases, mesh, arch):
    got, want = ranks[mesh][arch], cases[1][arch]
    for g, w in zip(got["step_metrics"], want["step_metrics"]):
        for k in ("loss", "grad_norm"):
            assert abs(g[k] - w[k]) <= RTOL * abs(w[k]), (k, g[k], w[k])
    _hold_tree(got["step_params"], want["step_params"],
               zero_tol=ZERO_INIT_RTOL, cfg=cases[0][arch]["cfg"])


def _jax_mesh(shape):
    devs = np.array(jax.devices()[:1] * int(np.prod(shape))).reshape(shape)
    return Mesh(devs, ("data", "model"))


def _blocks(specs, mesh) -> list:
    """Each leaf's block shape under the JAX package's resolve_pspec."""
    sizes = dict(mesh.shape)
    out = []
    for s in jax.tree.leaves(specs, is_leaf=is_spec):
        spec = jshd.resolve_pspec(s.shape, s.logical_axes
                                  or (None,) * len(s.shape), mesh)
        shape = list(s.shape)
        for d, axes in enumerate(spec):
            for a in (axes,) if isinstance(axes, str) else axes or ():
                shape[d] //= sizes[a]
        out.append(tuple(shape))
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_every_leaf_is_its_resolve_pspec_block(ranks, arch):
    """At (2, 2) every parameter, moment and cache leaf a rank holds has
    the block shape the reference's rules give its spec."""
    got = ranks[(2, 2)][arch]
    jc = dataclasses.replace(jget(arch, smoke=True), dtype=jax.numpy.float32)
    mesh = _jax_mesh((2, 2))
    assert got["param_shapes"] == _blocks(jlm.param_specs(jc), mesh)
    assert got["state_shapes"] == _blocks(jsteps.train_state_specs(jc), mesh)
    if jc.family == "moe":
        jc = dataclasses.replace(jc, capacity_factor=float(jc.n_experts))
    assert got["cache_shapes"] == _blocks(
        jlm.cache_specs(jc, DEC_B, CACHE_LEN), mesh)
