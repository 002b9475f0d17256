"""The port's multi-device DONN slice against the JAX package (CPU).

The mesh cases run on gloo ranks on the CPU: one spawn of each mesh
shape, (2, 1), (1, 2) and (2, 2), the three started together, each rank
running every case of its mesh (``_torch_mesh_worker.run_mesh``) and
returning numpy results; a hung collective fails the fixture at its join
timeout.  The JAX side runs in this process on its CPU device: its
single-device functions on the same numpy parameters and inputs.
Parameters come from the JAX ``init``; inputs from seeded numpy
generators.  The rules table and every refusal are held in this process
on stand-in meshes.

Tolerances, each the reference's own for the same path:

- sharded loss and d/dphase of each family (cls, rgb, seg, het) against
  the JAX single-device loss: 1e-5 of the max (``tests/test_distributed.py``
  SUITE2 §1);
- the compiled sharded step and the data-parallel step against the JAX
  single-device step: losses rtol 1e-5, params 2e-3 of the max (SUITE2 §2:
  AdamW's first steps amplify gradient rounding);
- the data-parallel chunk against the JAX per-step loop: losses rtol 1e-5,
  params 2e-3, and against the port's own single-device per-step loop:
  losses rtol 1e-6 (``test_train_throughput.py::TestDonnStepsChunk``);
- data-parallel and row-sharded serving against the JAX engine without a
  mesh: 1e-5 of the max, a repeat bit for bit, every rank the same whole
  outputs (SUITE2 §4, ``test_inference.py::TestMultiDevice``);
- the pencil fft2/ifft2 with leading dims against ``torch.fft`` and
  ``numpy.fft``, and its gradient: 1e-5 of the max.
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

from _torch_mesh_worker import run_mesh  # noqa: E402
from repro.core import build_model as jbuild  # noqa: E402
from repro.core import config as jconfig  # noqa: E402
from repro.core.train_utils import (  # noqa: E402
    bce_segmentation_loss as jbce, mse_softmax_loss as jmse,
)
from repro.nn import init_params as jinit  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.runtime import donn_steps as jds  # noqa: E402
from repro.runtime import inference as jinf  # noqa: E402
from repro.runtime import sharding as jshd  # noqa: E402
from repro_torch.convert import donn_state_from_jax  # noqa: E402
from repro_torch.core.config import DONNConfig, LayerSpec  # noqa: E402
from repro_torch.core.models import build_model  # noqa: E402
from repro_torch.launch import serve_donn  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.runtime import donn_steps as ds  # noqa: E402
from repro_torch.runtime import pencil_fft  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402
from repro_torch.runtime.collectives import spawn_ranks  # noqa: E402
from repro_torch.runtime.inference import InferenceEngine, freeze  # noqa: E402

RTOL = 1e-5
STEP_PARAM_RTOL = 2e-3
CHUNK_RTOL = 1e-6
CPU = "cpu"
MESHES = ((2, 1), (1, 2), (2, 2))
JOIN_TIMEOUT_S = 180.0

FAMILIES = {
    "cls": dict(name="cls2d", n=64, depth=4, distance=0.05, det_size=8),
    "rgb": dict(name="rgb2d", n=64, depth=2, distance=0.05, det_size=8,
                channels=3),
    "seg": dict(name="seg2d", n=64, depth=3, distance=0.05,
                segmentation=True, skip_from=0, layer_norm=True),
    # heterogeneous SegmentedPlan (64 -> 48 grids): the resampling
    # stitches gather whole rows between the row-sharded segments
    "het": dict(name="het2d", n=64, depth=3, distance=0.05, det_size=8,
                layers=(LayerSpec(distance=0.05, size=64),
                        LayerSpec(distance=0.05, size=48),
                        LayerSpec(distance=0.05, size=48))),
}
CHUNK_CFG = dict(name="sc", n=48, depth=3, distance=0.05, segmentation=True,
                 skip_from=0, layer_norm=True)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    kind = np.complex128 if np.iscomplexobj(want) else np.float64
    got, want = got.astype(kind), want.astype(kind)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _jax_cfg(tcfg: DONNConfig):
    d = dataclasses.asdict(tcfg)
    if tcfg.layers is not None:
        d["layers"] = tuple(jconfig.LayerSpec(**l) for l in d["layers"])
    return jconfig.DONNConfig(**d)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg: DONNConfig, b: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    shape = (b, cfg.channels, 28, 28) if cfg.channels > 1 else (b, 28, 28)
    images = rng.random(shape, np.float32)
    if cfg.segmentation:
        return {"images": images, "masks": (rng.random(
            (b, cfg.n, cfg.n)) > 0.5).astype(np.float32)}
    return {"images": images,
            "labels": (np.arange(b) % cfg.num_classes).astype(np.int32)}


def _jax_loss(cfg):
    m = jbuild(_jax_cfg(cfg))

    def loss(p, b):
        if cfg.segmentation:
            return jbce(m.apply(p, b["images"], train=True), b["masks"])
        return jmse(m.apply(p, b["images"]), b["labels"], cfg.num_classes)

    return m, loss


def _jax_steps(cfg, state, batches):
    step = jax.jit(jds.make_donn_train_step(_jax_cfg(cfg), JAdamW(lr=0.05)))
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return losses, _np_tree(state)


@pytest.fixture(scope="module")
def cases():
    """Inputs of every mesh case and the JAX single-device results."""
    key = jax.random.PRNGKey(0)
    fam, ref = {}, {}
    for i, (tag, kw) in enumerate(FAMILIES.items()):
        cfg = DONNConfig(**kw)
        jm, jloss = _jax_loss(cfg)
        params = _np_tree(jm.init(key))
        batch = _batch(cfg, 8, seed=i)
        fam[tag] = {"cfg": cfg, "params": params, "batch": batch}
        loss, grads = jax.jit(jax.value_and_grad(jloss))(params, batch)
        ref[tag] = (float(loss), _np_tree(grads))

    cls = DONNConfig(**FAMILIES["cls"])
    state = _np_tree(jinit(jds.donn_state_specs(_jax_cfg(cls)),
                           jax.random.PRNGKey(1)))
    batches = [_batch(cls, 8, seed=4)] * 2
    ref["step"] = _jax_steps(cls, state, batches)

    seg = DONNConfig(**CHUNK_CFG)
    chunk_state = _np_tree(jinit(jds.donn_state_specs(_jax_cfg(seg)),
                                 jax.random.PRNGKey(0)))
    chunk_batches = [_batch(seg, 4, seed=10 + i) for i in range(4)]
    ref["chunk"] = _jax_steps(seg, chunk_state, chunk_batches)

    jm = jbuild(_jax_cfg(cls))
    jp = jm.init(key)
    x = np.random.default_rng(7).random((8, 28, 28), np.float32)
    ref["serve"] = jinf.InferenceEngine(jinf.freeze(jm, jp),
                                        buckets=(8,)).infer(x)
    inputs = {
        "families": fam,
        "step": {"cfg": cls, "state": state, "batches": batches},
        "chunk": {"cfg": seg, "state": chunk_state, "batches": chunk_batches},
        "serve": {"cfg": cls, "params": _np_tree(jp), "x": x},
    }
    return inputs, ref


@pytest.fixture(scope="module")
def ranks(cases):
    """Every rank's results on each mesh; the three spawns run together."""
    inputs, _ = cases
    with concurrent.futures.ThreadPoolExecutor(len(MESHES)) as pool:
        futs = {m: pool.submit(spawn_ranks, run_mesh, m[0] * m[1],
                               (m[0], m[1], inputs), timeout=JOIN_TIMEOUT_S)
                for m in MESHES}
        return {m: f.result() for m, f in futs.items()}


def _ids(meshes):
    return [f"{d}x{m}" for d, m in meshes]


# ------------------------------------------------------------- mesh cases
@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("mesh", MESHES, ids=_ids(MESHES))
def test_sharded_loss_and_grads_match_reference(ranks, cases, mesh, family):
    want_loss, want_grads = cases[1][family]
    for loss, grads in (r["families"][family] for r in ranks[mesh]):
        assert abs(loss - want_loss) <= RTOL * abs(want_loss)
        assert set(grads["phase"]) == set(want_grads["phase"])
        for k, g in grads["phase"].items():
            assert _rel(g, want_grads["phase"][k]) <= RTOL, k


def _hold_steps(got, want, loss_rtol=RTOL):
    (losses, state), (wlosses, wstate) = got, want
    assert np.allclose(losses, wlosses, rtol=loss_rtol, atol=1e-7), (
        losses, wlosses)
    scale = max(np.max(np.abs(p)) for p in wstate["params"]["phase"].values())
    for k, p in state["params"]["phase"].items():
        err = np.max(np.abs(p - wstate["params"]["phase"][k])) / scale
        assert err <= STEP_PARAM_RTOL, (k, err)
    assert int(state["step"]) == int(wstate["step"])


@pytest.mark.parametrize("mesh", MESHES, ids=_ids(MESHES))
def test_compiled_sharded_step_tracks_reference(ranks, cases, mesh):
    for r in ranks[mesh]:
        _hold_steps(r["sharded_step"], cases[1]["step"])


@pytest.mark.parametrize("mesh", MESHES, ids=_ids(MESHES))
def test_data_parallel_step_tracks_reference(ranks, cases, mesh):
    for r in ranks[mesh]:
        _hold_steps(r["dp_step"], cases[1]["step"])


@pytest.mark.parametrize("mesh", MESHES, ids=_ids(MESHES))
def test_data_parallel_chunk_matches_per_step(ranks, cases, mesh):
    inputs, ref = cases
    for r in ranks[mesh]:
        _hold_steps(r["dp_chunk"], ref["chunk"])
    # the port's own single-device per-step loop on the same batches
    chunk = inputs["chunk"]
    step = ds.make_donn_train_step(chunk["cfg"], AdamW(lr=0.05), device=CPU)
    st = donn_state_from_jax(chunk["state"], CPU)
    losses = []
    for b in chunk["batches"]:
        st, m = step(st, b)
        losses.append(float(m["loss"]))
    got = ranks[mesh][0]["dp_chunk"][0]
    assert np.allclose(got, losses, rtol=CHUNK_RTOL, atol=1e-8), (got,
                                                                 losses)


def _hold_served(ranks_out, name, want):
    outs = [r["serve"][name] for r in ranks_out]
    for o in outs:  # every rank returns the same whole outputs
        assert np.array_equal(o, outs[0])
    assert _rel(outs[0], want) <= RTOL
    assert np.array_equal(np.argmax(outs[0], -1), np.argmax(want, -1))
    assert all(r["serve"][name + "_repeat_equal"] for r in ranks_out)


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)], ids=_ids([(2, 1),
                                                              (2, 2)]))
def test_data_parallel_serving_matches_reference(ranks, cases, mesh):
    want = cases[1]["serve"]
    _hold_served(ranks[mesh], "dp", want)
    # a bucket below dp_min_bucket serves undivided on every rank
    _hold_served(ranks[mesh], "dp_small", want[:2])


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=_ids([(1, 2),
                                                              (2, 2)]))
def test_row_sharded_serving_matches_reference(ranks, cases, mesh):
    _hold_served(ranks[mesh], "rows", cases[1]["serve"])


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=_ids([(1, 2),
                                                              (2, 2)]))
def test_pencil_fft_matches_fft2(ranks, mesh):
    p = ranks[mesh][0]["pencil"]
    x = torch.from_numpy(p["x"])
    assert _rel(p["fft2"], torch.fft.fft2(x).numpy()) <= RTOL
    assert _rel(p["fft2"], np.fft.fft2(p["x"])) <= RTOL
    assert _rel(p["ifft2"], torch.fft.ifft2(x).numpy()) <= RTOL
    assert _rel(p["ifft2"], np.fft.ifft2(p["x"])) <= RTOL
    assert p["deprecated_warns"] and p["deprecated_equal"]
    want = torch.fft.ifft2(torch.fft.fft2(x) * torch.from_numpy(p["h_tf"]))
    assert _rel(p["propagated"], want.numpy()) <= RTOL


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)], ids=_ids([(1, 2),
                                                              (2, 2)]))
def test_pencil_fft_gradient_matches_fft2(ranks, mesh):
    p = ranks[mesh][0]["pencil"]
    x = torch.from_numpy(p["x"]).requires_grad_(True)
    loss = (torch.abs(torch.fft.fft2(x)) ** 2
            * torch.from_numpy(p["weights"])).sum()
    (want,) = torch.autograd.grad(loss, x)
    assert _rel(p["grad"], want.numpy()) <= RTOL


# ------------------------------------------------------ serve_donn on ranks
def test_serve_donn_mesh_devices_on_cpu_ranks(capsys):
    rps = serve_donn.main(["--mesh-devices", "2", "--n", "32", "--depth",
                           "2", "--det-size", "6", "--requests", "12",
                           "--buckets", "1,4,8", "--device", "cpu"])
    assert rps > 0


# ------------------------------------------------------- rules, in-process
def _jax_mesh(shape, axes):
    devs = np.array(jax.devices()[:1] * int(np.prod(shape))).reshape(shape)
    return Mesh(devs, axes)


MESH = _jax_mesh((2, 4), ("data", "model"))
POD = _jax_mesh((2, 16, 16), ("pod", "data", "model"))
SPECS = [
    ((8, 64, 64), ("batch", "field_h", "field_w")),
    ((4, 64, 64), ("layers", "field_h", "field_w")),
    ((4, 1, 1), ("layers", "field_h", "field_w")),
    ((66, 64), ("field_h", "field_w")),
    ((10, 64, 64), ("classes", "field_h", "field_w")),
    ((8, 3, 64, 64), ("batch", "channel", "field_h", "field_w")),
    ((4096, 16384), ("embed", "mlp")),
    ((40, 2, 128), ("layers", "kv_heads", "head")),
    ((16, 128), ("kv_heads", "head")),
    ((256, 4096), ("batch", None)),
    ((4096,), ("embed",)),
    ((3, 64, 64), (None, "field_h", "field_w")),
]
RULES = {"default": (shd.DEFAULT_RULES, jshd.DEFAULT_RULES),
         "donn": (shd.donn_rules(), jshd.donn_rules()),
         "spatial": (shd.spatial_rules(), jshd.spatial_rules())}


def test_rules_tables_equal_reference():
    for name, (got, want) in RULES.items():
        assert got == want, name
    assert shd.donn_rules(data="d", model="m") == jshd.donn_rules(
        data="d", model="m")


def _outcome(fn, *args):
    """A spec as a tuple, or the name of the error it raised."""
    try:
        return tuple(fn(*args))
    except ValueError as e:
        return type(e).__name__


@pytest.mark.parametrize("rules", list(RULES))
@pytest.mark.parametrize("mesh", [MESH, POD], ids=["2x4", "pod"])
def test_resolved_specs_equal_reference(mesh, rules):
    got_rules, want_rules = RULES[rules]
    for shape, axes in SPECS:
        for port, ref, args in (
                (shd.resolve_pspec, jshd.resolve_pspec, (shape, axes, mesh)),
                (shd.operand_pspec, jshd.operand_pspec, (shape, axes, mesh)),
                (shd.rules_pspec, jshd.rules_pspec, (axes,))):
            extra = (got_rules,) if port is not shd.rules_pspec else (
                got_rules, mesh)
            jextra = (want_rules,) if ref is not jshd.rules_pspec else (
                want_rules, mesh)
            assert _outcome(port, *args, *extra) == _outcome(
                ref, *args, *jextra), (port.__name__, shape, axes)


def test_spec_helpers_equal_reference():
    for axes in ("data", ("data", "model"), None, ()):
        for ndim in (1, 3):
            assert shd.dim0_pspec(axes, ndim) == tuple(
                jshd.dim0_pspec(axes, ndim))
    assert shd.replicated_pspec(3) == tuple(jshd.replicated_pspec(3))
    assert shd.with_leading(("model", None), 2) == tuple(
        jshd.with_leading(jax.sharding.PartitionSpec("model", None), 2))
    for axes in ("data", ("pod", "data"), ("pod",), "model", None):
        assert shd.present_axes(MESH, axes) == jshd.present_axes(MESH, axes)
    assert shd.mesh_shape(MESH) == {"data": 2, "model": 4}


@pytest.mark.parametrize("mesh", [MESH, POD], ids=["2x4", "pod"])
def test_batch_drop_equals_reference(mesh):
    for rules in (None, shd.donn_rules()):
        jrules = None if rules is None else jshd.donn_rules()
        for b in (None, 256, 8, 2, 1, 3):
            got = shd.batch_pspec(mesh, 2, rules, batch_size=b)
            want = jshd.batch_sharding(mesh, 2, jrules, batch_size=b).spec
            assert got == tuple(want) + (None,) * (2 - len(tuple(want))), b


def test_rules_collisions_raise_typed_errors():
    assert shd.resolve_pspec((66, 64), ("field_h", "field_w"), MESH,
                             shd.donn_rules()) == ()
    with pytest.raises(shd.ShardingRulesError):
        shd.check_rules({**shd.donn_rules(), "field_h": "data"})
    with pytest.raises(shd.ShardingRulesError):
        shd.resolve_pspec((8, 64, 64), ("batch", "field_h", "field_w"), MESH,
                          {**shd.DEFAULT_RULES, "batch": "model",
                           "field_h": "model"})
    with pytest.raises(shd.ShardingRulesError):
        shd.rules_pspec(("field_h", "field_h"), shd.donn_rules(), MESH)
    assert issubclass(shd.ShardingRulesError, ValueError)


def test_make_mesh_2d_refuses_more_ranks_than_the_world():
    with pytest.raises(ValueError, match="needs 4 ranks"):
        shd.make_mesh_2d(2, 2, device=CPU)


def test_param_and_state_specs_equal_reference():
    for kw in FAMILIES.values():
        cfg = DONNConfig(**kw)
        got = ds.donn_state_specs(cfg)
        want = jds.donn_state_specs(_jax_cfg(cfg))
        for part in ("params", "mu", "nu"):
            for k, s in got[part]["phase"].items():
                w = want[part]["phase"][k]
                assert (s.shape, s.logical_axes, s.init) == (
                    w.shape, w.logical_axes, w.init), (part, k)
        assert got["step"].shape == () and got["step"].dtype == torch.int32
        assert shd.tree_pspecs(got, MESH, shd.donn_rules()) == jax.tree.map(
            tuple, jshd.tree_pspecs(want, MESH, jshd.donn_rules()),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))


def test_uniform_phase_init():
    from repro_torch.nn.module import ParamSpec, init_params

    specs = build_model(DONNConfig(**FAMILIES["rgb"]),
                        device=CPU).param_specs()
    p = init_params(specs, torch.Generator().manual_seed(0))
    for leaf in p["phase"].values():
        assert leaf.shape == (3, 64, 64) and leaf.dtype == torch.float32
        assert 0.0 <= float(leaf.min()) and float(leaf.max()) < 2 * np.pi
    half = ParamSpec((4,), init="uniform_phase", scale=0.5)
    assert float(init_params(half, torch.Generator()).max()) < np.pi


def test_donn_state_from_jax_round_trip():
    cfg = DONNConfig(**FAMILIES["cls"])
    state = _np_tree(jinit(jds.donn_state_specs(_jax_cfg(cfg)),
                           jax.random.PRNGKey(3)))
    got = donn_state_from_jax(state, CPU)
    for part in ("params", "mu", "nu"):
        for k, v in state[part]["phase"].items():
            assert np.array_equal(got[part]["phase"][k].numpy(), v)
    assert got["step"].dtype == torch.int32 and int(got["step"]) == 0
    with pytest.raises(ValueError, match="missing"):
        donn_state_from_jax({"params": state["params"]}, CPU)


class _StandIn:
    """A mesh seen only through its shape (no rank runs)."""

    def __init__(self, **shape):
        self.shape = shape


# ------------------------------------------------------------ refusals
@pytest.mark.parametrize("kw", [
    dict(pad=True),
    dict(approximation="fraunhofer"),
    dict(codesign="gumbel"),
    dict(use_pallas=True),
    dict(tf_dtype="bfloat16"),
])
def test_spatial_loss_refuses_unsupported_configs(kw):
    cfg = DONNConfig(name="g", n=48, depth=3, distance=0.05, **kw)
    with pytest.raises(NotImplementedError):
        ds.make_donn_spatial_loss(cfg, _StandIn(data=1, model=1), device=CPU)


@pytest.mark.parametrize("kw", [
    dict(segmentation=True, skip_from=0),
    dict(channels=3),
    dict(layers=(LayerSpec(distance=0.05, size=32),) * 3),
])
def test_formerly_gated_families_build(kw):
    cfg = DONNConfig(name="g3", n=48, depth=3, distance=0.05, **kw)
    assert callable(ds.make_donn_sharded_loss(
        cfg, _StandIn(data=1, model=1), device=CPU))


def test_indivisible_rows_and_families_refused():
    mesh5 = _StandIn(model=5)
    with pytest.raises(ValueError, match="divide"):
        ds.make_donn_spatial_loss(
            DONNConfig(name="g2", n=48, depth=2, distance=0.05), mesh5,
            device=CPU)
    het = DONNConfig(name="g4", n=48, depth=2, distance=0.05,
                     layers=(LayerSpec(distance=0.05, size=48),
                             LayerSpec(distance=0.05, size=36)))
    with pytest.raises(ValueError, match="segment 1"):
        ds.make_donn_sharded_loss(het, _StandIn(data=1, model=8),
                                  device=CPU)
    het_rgb = dataclasses.replace(het, channels=3)
    with pytest.raises(NotImplementedError, match="classification"):
        ds.make_donn_sharded_loss(het_rgb, _StandIn(data=1, model=1),
                                  device=CPU)
    with pytest.raises(shd.ShardingRulesError, match="single mesh axis"):
        ds.make_donn_sharded_loss(
            DONNConfig(name="g5", n=48, depth=2, distance=0.05),
            _StandIn(data=2, model=2),
            rules={**shd.donn_rules(), "batch": None,
                   "field_h": ("data", "model")}, device=CPU)


def test_sharded_step_refuses_batch_and_clipping():
    cfg = DONNConfig(name="g6", n=48, depth=2, distance=0.05)
    with pytest.raises(ValueError, match="does not divide"):
        ds.compile_donn_train_step_sharded(cfg, _StandIn(data=2, model=1),
                                           global_batch=3, device=CPU)
    with pytest.raises(NotImplementedError, match="clipping"):
        ds.compile_donn_train_step_sharded(
            cfg, _StandIn(data=1, model=1),
            optimizer=AdamW(grad_clip_norm=1.0), device=CPU)
    with pytest.raises(ValueError, match="unshardable"):
        ds.compile_donn_train_step(cfg, _StandIn(data=2, model=2),
                                   global_batch=3, device=CPU)


def test_sharded_step_chunk_equals_per_step(cases):
    """``steps_per_call=2`` on one rank (a 1x1 stand-in mesh) runs the
    same steps as the per-step function, bit for bit."""
    chunk = cases[0]["chunk"]
    mesh = _StandIn(data=1, model=1)
    kw = dict(optimizer=AdamW(lr=0.05), device=CPU)
    fn1, _, b_ps, _ = ds.compile_donn_train_step_sharded(
        chunk["cfg"], mesh, **kw)
    fn2, _, b_ps2, _ = ds.compile_donn_train_step_sharded(
        chunk["cfg"], mesh, steps_per_call=2, **kw)
    assert b_ps2 == {k: (None,) + v for k, v in b_ps.items()}
    st1 = donn_state_from_jax(chunk["state"], CPU)  # one rank: whole
    losses1 = []
    for b in chunk["batches"]:
        st1, m = fn1(st1, b)
        losses1.append(m["loss"])
    st2 = donn_state_from_jax(chunk["state"], CPU)
    stacked = {k: np.stack([b[k] for b in chunk["batches"]])
               for k in chunk["batches"][0]}
    st2, m2 = fn2(st2, stacked)
    assert torch.equal(m2["loss"], torch.stack(losses1))
    for k, p in st1["params"]["phase"].items():
        assert torch.equal(p, st2["params"]["phase"][k])


def _deployed(**kw):
    kw = {"name": "r", "n": 32, "depth": 2, "distance": 0.05,
          "det_size": 6, **kw}
    cfg = DONNConfig(**kw)
    m = build_model(cfg, device=CPU)
    return m, freeze(m, m.init(torch.Generator().manual_seed(0)),
                     device=CPU)


@pytest.mark.parametrize("kw,err,match", [
    (dict(use_pallas=True), NotImplementedError, "full planes"),
    (dict(segmentation=True, skip_from=0), NotImplementedError, "classify"),
    (dict(channels=3), NotImplementedError, "classify"),
    (dict(pad=True), NotImplementedError, "angular-spectrum"),
    (dict(layers=(LayerSpec(distance=0.05, size=32),
                  LayerSpec(distance=0.05, size=16))),
     NotImplementedError, "uniform plans"),
    (dict(n=30), ValueError, "not divisible"),
])
def test_row_sharded_engine_refusals(monkeypatch, kw, err, match):
    monkeypatch.setenv("WORLD_SIZE", "4")
    _, dep = _deployed(**kw)
    with pytest.raises(err, match=match):
        InferenceEngine(dep, model_devices=4, device=CPU)


def test_engine_refuses_rfft_first_rows_and_more_ranks(monkeypatch):
    m, _ = _deployed()
    dep = freeze(m, m.init(torch.Generator().manual_seed(0)),
                 rfft_first=True, device=CPU)
    with pytest.raises(ValueError, match="have 1"):
        InferenceEngine(dep, mesh_devices=2, device=CPU)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="rfft_first"):
        InferenceEngine(dep, model_devices=2, device=CPU)


def test_spectral_override_refused_on_padded_plans():
    m = build_model(DONNConfig(name="p", n=32, depth=2, distance=0.05,
                               pad=True), device=CPU)
    plan = m.plan
    u = torch.zeros(1, 32, 32, dtype=torch.complex64)
    pair = (torch.zeros(32, 32), torch.zeros(32, 32))
    with pytest.raises(NotImplementedError, match="unpadded"):
        plan._hop(u, pair, spectral=(torch.fft.fft2, torch.fft.ifft2))


def test_spectral_override_equals_plain_plan():
    """``spectral=`` with the plain (fft2, ifft2) pair is the plan itself
    (the fusion is off, the multiply the same)."""
    m = build_model(DONNConfig(name="s", n=32, depth=3, distance=0.05),
                    device=CPU)
    p = m.init(torch.Generator().manual_seed(1))
    u = m.encode(torch.from_numpy(
        np.random.default_rng(2).random((2, 28, 28), np.float32)))
    phis = m.stacked_phases(p)
    want = m.plan.apply(phis, u)
    got = m.plan.apply(phis, u, spectral=(torch.fft.fft2, torch.fft.ifft2))
    assert torch.equal(got, want)


def test_pencil_fft_refuses_indivisible_width():
    x = torch.zeros(1, 4, 30, dtype=torch.complex64)
    with pytest.raises(ValueError, match="divide"):
        pencil_fft._local_fft2(x, group=None, k=4, inverse=False)
