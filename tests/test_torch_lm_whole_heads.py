"""The LM mesh where ``n_heads`` does not divide the model degree, on gloo
ranks against the port's own one-rank run, on the CPU.

The production mesh has 16 ``model`` ranks; qwen1.5-4b has 20 heads,
qwen2.5-14b 40, arctic-480b 56, musicgen-medium 24 and every smoke config
4.  Where the heads do not divide, every ``model`` rank runs every head of
the block (``MeshContext.whole``): its weights gathered whole, its
whole output cut to the rank's block of the sequence, an RG-LRU's decode
states gathered and cut back to the rank's channels; the reference
replicates such a dim.  Three configs at ``(1, 2)``, one spawn of two
ranks (``_torch_lm_mesh_worker.run_cases``):

- dense, 3 query and 3 KV heads of 16 (decode on the ``head`` fallback);
- dense, 3 query heads over 1 KV head;
- hybrid, 3 RG-LRU and attention heads over 48 channels.

Held as ``test_torch_lm_mesh.py`` holds its cases: prefill logits,
``lm_loss`` and every gradient, 4 decode steps and the cache they leave,
one launcher step, within 1e-5 of the max (leaves initialised at zero
1e-2).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _torch_cores import share_cores  # noqa: E402

share_cores(torch)

import numpy as np  # noqa: E402

import repro_torch.models  # noqa: E402
from _torch_lm_mesh_worker import (  # noqa: E402
    family_case, one_rank, run_cases,
)
from repro_torch.models import get_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402
from repro_torch.runtime.collectives import spawn_ranks  # noqa: E402
from repro_torch.tree import tree_leaves, tree_paths  # noqa: E402

RTOL = 1e-5
ZERO_INIT_RTOL = 1e-2
B, S = 2, 8
DEC_B, DEC_STEPS, CACHE_LEN = 2, 4, 8
CONFIGS = {
    "mha3": ("qwen1.5-4b", dict(n_heads=3, n_kv_heads=3, d_head=16)),
    "gqa3": ("glm4-9b", dict(n_heads=3, n_kv_heads=1, d_head=16)),
    "hybrid3": ("recurrentgemma-9b", dict(n_heads=3, lru_width=48)),
}


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


@pytest.fixture(scope="module")
def cases():
    real = repro_torch.models.get_config
    inputs = {}
    try:
        for i, (name, (arch, kw)) in enumerate(CONFIGS.items()):
            cfg = dataclasses.replace(get_config(arch, smoke=True), **kw)
            repro_torch.models.get_config = \
                lambda a, smoke=False, cfg=cfg: cfg
            inputs[name] = family_case(arch, i, B, S, DEC_B, DEC_STEPS,
                                       CACHE_LEN)
    finally:
        repro_torch.models.get_config = real
    return inputs, {name: one_rank(c) for name, c in inputs.items()}


@pytest.fixture(scope="module")
def ranks(cases):
    return spawn_ranks(run_cases, 2, (1, 2, cases[0]), timeout=240.0)[0]


def _hold_tree(got, want, cfg):
    inits = [s.init for s in tree_leaves(lm.param_specs(cfg))]
    for init, path, g, w in zip(inits, tree_paths(want), tree_leaves(got),
                                tree_leaves(want)):
        tol = ZERO_INIT_RTOL if init == "zeros" else RTOL
        assert rel(g, w) <= tol, (path, rel(g, w))


def test_the_configs_take_the_fallback():
    class Mesh:
        shape = {"data": 1, "model": 2}

        def __init__(self):
            self.mesh_dim_names = ("data", "model")

        def get_coordinate(self):
            return [0, 1]

        def get_group(self, name):
            return object()

    ctx = shd.MeshContext(Mesh())
    for arch, kw in CONFIGS.values():
        assert ctx.whole(kw["n_heads"])
    assert not ctx.whole(4)
    assert not shd.MeshContext().whole(3)  # one device


@pytest.mark.parametrize("name", CONFIGS)
def test_whole_heads_match_one_rank(ranks, cases, name):
    inputs, wants = cases
    got, want, cfg = ranks[name], wants[name], inputs[name]["cfg"]
    assert rel(got["logits"], want["logits"]) <= RTOL
    assert abs(got["loss"] - want["loss"]) <= RTOL * abs(want["loss"])
    _hold_tree(got["grads"], want["grads"], cfg)
    assert rel(got["decode"], want["decode"]) <= RTOL
    for path, g, w in zip(tree_paths(want["cache"]),
                          tree_leaves(got["cache"]),
                          tree_leaves(want["cache"])):
        assert rel(g, w) <= RTOL, path
    for k in ("loss", "grad_norm"):
        assert abs(got["step_metrics"][0][k] - want["step_metrics"][0][k]) \
            <= RTOL * abs(want["step_metrics"][0][k])
    _hold_tree(got["step_params"], want["step_params"], cfg)
