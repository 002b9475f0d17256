"""The LM mesh where a model-sharded dim does not divide the model degree,
on gloo ranks against the port's own one-rank run and the unmeshed JAX
package, on the CPU.

The reference's ``resolve_pspec`` replicates a dim that does not divide
over its mesh axis, so one rules table serves every mesh.  The port does
the same (``MeshContext.whole``): at ``(1, 3)`` every smoke config's heads
(4), MLP width (128), vocabulary (256; musicgen 64), ``d_inner`` (128),
``lru_width`` (64) and experts (4, 8) run whole on every ``model`` rank,
their weights and decode states whole, their outputs whole and cut to the
rank's block of the sequence (12 tokens: 4 a rank).  Three more configs
mix whole and split dims at ``(1, 3)``: qwen1.5-4b with ``d_ff`` 96 and a
vocabulary of 255 (split MLP and vocabulary, whole heads), arctic-480b
with ``expert_d_ff`` 64 (whole experts beside a split dense residual),
falcon-mamba-7b with ``d_inner`` 96 (split).  At ``(2, 3)`` the moe block
also splits the batch over ``data``; with ``moe_group`` 24 each capacity
group spans both ``data`` ranks' rows, and the block runs on the whole
batch gathered over ``data``, as the reference's groups span it.

One spawn of ranks a mesh shape (``_torch_lm_mesh_worker.run_cases``):
``(1, 2)`` first (it saves a musicgen-medium state), then ``(1, 3)``
(which restores it) beside ``(2, 3)``.

Tolerances (max|mesh - reference| / max|reference| a leaf), f32:
- against the port's one rank: prefill logits, 8 decode steps and the
  cache they leave, ``lm_loss`` and every gradient 1e-5; one launcher
  optimizer step's loss and grad norm 1e-5, and its params 1e-5 against
  AdamW's update of the gradients the mesh took it on (the first update
  divides each gradient entry by its own size: an entry within rounding
  of zero, 1e-6 of a max of 7.5 in recurrentgemma's table, steps by +-lr
  either way);
- against the unmeshed JAX ``logits_fn``, ``decode_step`` and ``lm_loss``
  gradient (qwen1.5-4b, falcon-mamba-7b, mixtral-8x7b, recurrentgemma-9b
  at ``(1, 3)``, parameters from the JAX ``init``): 1e-5,
  ``test_torch_lm_mesh_ref.py``'s;
- a state saved at ``(1, 2)`` restores at ``(1, 3)``, and one saved at
  ``(1, 3)`` at each ``(1, 2)`` rank's coordinates: bit for bit;
- the launchers at ``--mesh 1x3`` in f32: the losses of a 1x1 run (1e-5),
  the greedy tokens of 1x1 serving.
"""
import concurrent.futures
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _torch_cores import share_cores  # noqa: E402

share_cores(torch)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import repro_torch.models  # noqa: E402
from _torch_lm_mesh_worker import (  # noqa: E402
    f32_launchers, family_case, launcher_optimizer, launcher_serve,
    one_rank, run_cases,
)
from repro.models import get_config as jget  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.nn import is_spec  # noqa: E402
from repro.runtime import sharding as jshd  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import get_config  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402
from repro_torch.runtime.collectives import spawn_ranks  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map, tree_paths  # noqa: E402

RTOL = 1e-5
B, S = 2, 12  # batch rows split over data, the sequence over model
DEC_B, DEC_STEPS, CACHE_LEN = 2, 8, 8
JOIN_TIMEOUT_S = 300.0
FAMILIES = ("qwen1.5-4b", "falcon-mamba-7b", "musicgen-medium",
            "mixtral-8x7b", "recurrentgemma-9b", "llama-3.2-vision-11b",
            "arctic-480b")
MIXED = {"qwen-split-mlp-vocab": ("qwen1.5-4b", dict(d_ff=96, vocab=255)),
         "arctic-whole-experts": ("arctic-480b", dict(expert_d_ff=64)),
         "mamba-split-inner": ("falcon-mamba-7b", dict(d_inner=96))}
MOE_2X3 = {"mixtral": ("mixtral-8x7b", {}),
           "mixtral-straddling-groups": ("mixtral-8x7b",
                                         dict(moe_group=B * S)),
           "arctic-whole-experts": ("arctic-480b", dict(expert_d_ff=64))}
JAX_ARCHS = ("qwen1.5-4b", "falcon-mamba-7b", "mixtral-8x7b",
             "recurrentgemma-9b")
TRAIN = ["--arch", "glm4-9b", "--smoke", "--batch", "4", "--seq", "12",
         "--lr", "1e-2", "--warmup", "2", "--steps", "3", "--device", "cpu",
         "--log-every", "1"]
SERVE = ["--arch", "qwen1.5-4b", "--smoke", "--slots", "3", "--requests",
         "4", "--prompt-len", "3", "--max-new", "5", "--device", "cpu"]
CPU = "cpu"


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _case(arch, seed, **kw):
    """``family_case`` of ``arch``'s smoke config with ``kw`` replaced."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), **kw)
    real = repro_torch.models.get_config
    repro_torch.models.get_config = lambda a, smoke=False: cfg
    try:
        return family_case(arch, seed, B, S, DEC_B, DEC_STEPS, CACHE_LEN)
    finally:
        repro_torch.models.get_config = real


def _jax_case(arch, seed):
    """An f32 smoke case on the JAX ``init``'s parameters and the unmeshed
    JAX results: logits, ``lm_loss`` and its gradient, 8 jitted decode
    steps (moe at the capacity lifted to ``n_experts``)."""
    jc = dataclasses.replace(jget(arch, smoke=True), dtype=jnp.float32)
    tc = dataclasses.replace(get_config(arch, smoke=True),
                             dtype=torch.float32)
    jp = jlm.init(jc, jax.random.PRNGKey(seed))
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(0, jc.vocab, (B, S)).astype(np.int32),
             "labels": r.integers(0, jc.vocab, (B, S)).astype(np.int32)}
    batch["labels"][0, :3] = -1
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jb, jc)))(jp)
    moe = {"capacity_factor": float(jc.n_experts)} if jc.family == "moe" \
        else {}
    jdc, tdc = (dataclasses.replace(c, **moe) for c in (jc, tc))
    toks = r.integers(0, jc.vocab, (DEC_B, DEC_STEPS))
    cache = jlm.init_cache(jdc, DEC_B, CACHE_LEN)
    step = jax.jit(lambda p, c, t, pos: jlm.decode_step(p, c, t, pos, jdc))
    dec = []
    for t in range(DEC_STEPS):
        lg, cache = step(jp, cache, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                         jnp.int32(t))
        dec.append(np.asarray(lg[:, 0]))
    want = {"logits": np.asarray(jax.jit(
        lambda p, t: jlm.logits_fn(p, t, jc))(jp, jb["tokens"])),
        "loss": float(loss), "grads": [np.asarray(g) for g in
                                       jax.tree.leaves(grads)],
        "decode": np.stack(dec, 1)}
    case = {"cfg": tc, "params": jax.tree.map(np.asarray, jp),
            "batch": batch,
            "decode": {"cfg": tdc, "tokens": toks, "cache_len": CACHE_LEN}}
    return case, want


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The cases of each mesh shape and what they are held against."""
    music = _case("musicgen-medium", 40)
    saved_12 = str(tmp_path_factory.mktemp("saved_1x2"))
    saved_13 = str(tmp_path_factory.mktemp("saved_1x3"))
    state = {"task": "save_state", "cfg": music["cfg"],
             "params": music["params"], "batch": music["batch"]}
    jax_cases = {a: _jax_case(a, 20 + i) for i, a in enumerate(JAX_ARCHS)}
    wide = {a: _case(a, i) for i, a in enumerate(FAMILIES)}
    wide.update({n: _case(a, 10 + i, **kw)
                 for i, (n, (a, kw)) in enumerate(MIXED.items())})
    wide.update({f"jax-{a}": c for a, (c, _) in jax_cases.items()})
    wide.update({
        "restore": {"task": "restore_state", "cfg": music["cfg"],
                    "dir": saved_12},
        "save": {**state, "dir": saved_13},
        "train": {"task": "launcher_train", "argv": TRAIN + ["--mesh",
                                                             "1x3"]},
        "serve": {"task": "launcher_serve", "argv": SERVE + ["--mesh",
                                                             "1x3"]}})
    cases = {(1, 2): {"save": {**state, "dir": saved_12}},
             (1, 3): wide,
             (2, 3): {n: _case(a, 30 + i, **kw)
                      for i, (n, (a, kw)) in enumerate(MOE_2X3.items())}}
    want = {"jax": {a: w for a, (_, w) in jax_cases.items()},
            "music": music, "saved_1x3": saved_13}
    return cases, want


@pytest.fixture(scope="module")
def ranks(refs):
    """Rank 0's results: (1, 2) saves, then (1, 3) restores beside
    (2, 3)."""
    cases, _ = refs

    def run(mesh):
        return spawn_ranks(run_cases, mesh[0] * mesh[1],
                           (mesh[0], mesh[1], cases[mesh]),
                           timeout=JOIN_TIMEOUT_S)[0]

    out = {(1, 2): run((1, 2))}
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futs = {m: pool.submit(run, m) for m in ((1, 3), (2, 3))}
        out.update({m: f.result() for m, f in futs.items()})
    return out


def _hold_family(got, case):
    """A mesh run of a ``family_case`` against the port's one rank; its
    train step against AdamW's step on the mesh's own gradients."""
    want = one_rank(case)
    assert rel(got["logits"], want["logits"]) <= RTOL
    assert rel(got["decode"], want["decode"]) <= RTOL
    assert sorted(got["cache"]) == sorted(want["cache"])
    for path, g, w in zip(tree_paths(want["cache"]),
                          tree_leaves(got["cache"]),
                          tree_leaves(want["cache"])):
        assert rel(g, w) <= RTOL, path
    assert abs(got["loss"] - want["loss"]) <= RTOL * abs(want["loss"])
    for path, g, w in zip(tree_paths(want["grads"]),
                          tree_leaves(got["grads"]),
                          tree_leaves(want["grads"])):
        assert rel(g, w) <= RTOL, path
    for k in ("loss", "grad_norm"):
        w = want["step_metrics"][0][k]
        assert abs(got["step_metrics"][0][k] - w) <= RTOL * abs(w), k
    # AdamW's first update divides each gradient entry by its own size,
    # so an entry within rounding of zero steps by +-lr either way: the
    # step is held against the update of the gradients it was taken on
    opt = launcher_optimizer()
    params = tree_map(torch.from_numpy, case["params"])
    stepped, _ = opt.update(tree_map(torch.from_numpy, got["grads"]),
                            opt.init(params), params,
                            torch.zeros((), dtype=torch.int32))
    for path, g, w in zip(tree_paths(stepped),
                          tree_leaves(got["step_params"]),
                          tree_leaves(stepped)):
        assert rel(g, w.numpy()) <= RTOL, path


class _Coord:
    """A mesh seen from one coordinate, whose groups are never used
    (restoring a checkpoint and cutting blocks need none)."""

    mesh_dim_names = ("data", "model")

    def __init__(self, data, model, coord):
        self.shape = (data, model)
        self.coord = list(coord)

    def get_coordinate(self):
        return self.coord

    def get_group(self, name):
        return object()


# ------------------------------------------------------------ the fallback
def test_dims_that_do_not_divide_are_whole():
    """``part`` gives the whole of a dim that does not divide, and
    ``local_block``/``block_shape`` keep such a dim whole, as
    ``resolve_pspec`` replicates it."""
    ctx = shd.MeshContext(_Coord(1, 3, (0, 2)))
    assert ctx.whole(4) and not ctx.whole(96)
    assert ctx.part(4) == (0, 4) and ctx.part(96) == (64, 96)
    assert not shd.MeshContext().whole(5)  # one device
    t = torch.arange(4 * 6).reshape(4, 6)
    mesh = _Coord(1, 3, (0, 1))
    assert torch.equal(shd.local_block(t, (None, "model"), mesh),
                       t[:, 2:4])
    assert torch.equal(shd.local_block(t, ("model", None), mesh), t)
    assert shd.block_shape((4, 6), ("model", "model"), mesh) == (4, 2)
    assert shd.resolve_pspec((4, 6), ("heads", "mlp"), mesh) == (None,
                                                                 "model")


def test_the_smoke_configs_take_the_whole_path_at_1x3():
    """At (1, 3) every model-sharded dim of the smoke configs is whole but
    arctic's 96-wide MLPs."""
    ctx = shd.MeshContext(_Coord(1, 3, (0, 0)))
    fields = ("vocab", "n_heads", "d_ff", "d_inner", "lru_width",
              "n_experts", "expert_d_ff", "dense_residual_ff")
    split = set()
    for arch in FAMILIES:
        cfg = get_config(arch, smoke=True)
        split |= {(arch, f) for f in fields
                  if getattr(cfg, f) and not ctx.whole(getattr(cfg, f))}
    assert split == {("arctic-480b", f) for f in (
        "d_ff", "expert_d_ff", "dense_residual_ff")}


def test_a_straddling_capacity_group_gathers_the_batch():
    ctx = shd.MeshContext(_Coord(2, 3, (1, 0)))
    assert tmoe._group_size(ctx, 1, 12, B * S) == (B * S, True)
    assert tmoe._group_size(ctx, 1, 12, 12) == (12, False)
    assert tmoe._group_size(ctx, 1, 12, 5) == (B * S, True)  # T % g


@pytest.mark.parametrize("name", FAMILIES + tuple(MIXED))
def test_at_1x3_matches_one_rank(ranks, refs, name):
    _hold_family(ranks[(1, 3)][name], refs[0][(1, 3)][name])


@pytest.mark.parametrize("name", tuple(MOE_2X3))
def test_moe_at_2x3_matches_one_rank(ranks, refs, name):
    _hold_family(ranks[(2, 3)][name], refs[0][(2, 3)][name])


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_at_1x3_matches_unmeshed_jax(ranks, refs, arch):
    got, want = ranks[(1, 3)][f"jax-{arch}"], refs[1]["jax"][arch]
    assert rel(got["logits"], want["logits"]) <= RTOL
    assert rel(got["decode"], want["decode"]) <= RTOL
    assert abs(got["loss"] - want["loss"]) <= RTOL * abs(want["loss"])
    for path, g, w in zip(tree_paths(got["grads"]),
                          tree_leaves(got["grads"]), want["grads"]):
        assert rel(g, w) <= RTOL, path


def _jax_blocks(specs, shape) -> list:
    """Each leaf's block shape under the JAX package's resolve_pspec on a
    mesh of repeated CPU devices."""
    devs = np.array(jax.devices()[:1] * int(np.prod(shape))).reshape(shape)
    mesh = Mesh(devs, ("data", "model"))
    out = []
    for s in jax.tree.leaves(specs, is_leaf=is_spec):
        spec = jshd.resolve_pspec(s.shape, s.logical_axes
                                  or (None,) * len(s.shape), mesh)
        block = list(s.shape)
        for d, axes in enumerate(spec):
            for a in (axes,) if isinstance(axes, str) else axes or ():
                block[d] //= dict(mesh.shape)[a]
        out.append(tuple(block))
    return out


@pytest.mark.parametrize("mesh,name,arch,kw", [
    ((1, 3), "mixtral-8x7b", "mixtral-8x7b", {}),
    ((1, 3), "recurrentgemma-9b", "recurrentgemma-9b", {}),
    ((1, 3), "qwen-split-mlp-vocab", *MIXED["qwen-split-mlp-vocab"]),
    ((2, 3), "arctic-whole-experts", *MOE_2X3["arctic-whole-experts"])])
def test_every_leaf_is_its_resolve_pspec_block(ranks, mesh, name, arch, kw):
    """Every parameter, moment and cache leaf a rank holds has the block
    shape the reference's rules give it: whole along a dim that does not
    divide."""
    got = ranks[mesh][name]
    jc = dataclasses.replace(jget(arch, smoke=True), **kw)
    assert got["param_shapes"] == _jax_blocks(jlm.param_specs(jc), mesh)
    assert got["state_shapes"] == _jax_blocks(
        jsteps.train_state_specs(jc), mesh)
    if jc.family == "moe":  # the decode case's lifted capacity
        jc = dataclasses.replace(jc, capacity_factor=float(jc.n_experts))
    assert got["cache_shapes"] == _jax_blocks(
        jlm.cache_specs(jc, DEC_B, CACHE_LEN), mesh)


# ------------------------------------------------------------- checkpoints
def test_a_1x2_checkpoint_restores_at_1x3_bit_for_bit(ranks):
    saved = ranks[(1, 2)]["save"]
    got = ranks[(1, 3)]["restore"]
    for a, b in zip(tree_leaves(got["state"]), tree_leaves(saved)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    cfg = get_config("musicgen-medium", smoke=True)
    want = [tuple(t.shape) for t in tree_leaves(shd.sharded_zeros(
        steps.train_state_specs(cfg), _Coord(1, 3, (0, 0)),
        device="meta"))]
    assert got["shapes"] == want


@pytest.mark.parametrize("coord", [(0, 0), (0, 1)])
def test_a_1x3_checkpoint_restores_at_1x2_bit_for_bit(ranks, refs, coord):
    """Each (1, 2) rank's restore of the state saved at (1, 3) is its
    block of the saved leaves (the restore is local: no collective)."""
    saved = ranks[(1, 3)]["save"]
    sspecs = steps.train_state_specs(refs[1]["music"]["cfg"])
    mesh = _Coord(1, 2, coord)
    place = shd.tree_shardings(sspecs, mesh)
    state = ckpt.restore(refs[1]["saved_1x3"], 1, shd.abstract_like(sspecs),
                         device=CPU, mesh=mesh, pspecs=place)
    want = shd.local_tree(tree_map(torch.from_numpy, saved), place, mesh)
    for path, got, w in zip(tree_paths(state), tree_leaves(state),
                            tree_leaves(want)):
        assert got.dtype == w.dtype and torch.equal(got, w), path


# --------------------------------------------------------------- launchers
def test_train_launcher_at_1x3_matches_1x1(ranks, capsys):
    with f32_launchers():
        want = ttrain.main(TRAIN)
    capsys.readouterr()
    np.testing.assert_allclose(ranks[(1, 3)]["train"], want, rtol=RTOL)


def test_serve_launcher_at_1x3_emits_the_tokens_of_1x1(ranks, capsys):
    want = launcher_serve(None, {"argv": SERVE})
    capsys.readouterr()
    assert ranks[(1, 3)]["serve"] == want
