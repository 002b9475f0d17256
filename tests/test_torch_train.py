"""The port's training path against the JAX package (CPU).

Both packages build the same ``DONNConfig`` from numpy parameters and get
the same numpy batches.  With ``use_pallas`` the JAX side runs its Pallas
kernels in interpret mode and the port runs its kernels' plain PyTorch
versions inside the same autograd Functions that launch the kernels on
the card, so the backward formulas themselves are what is compared.

Tolerances (max|port - jax| / max|jax|, f32): 1e-5, the reference's own
engine tolerance, on losses, gradients and parameters.  The two sides
use different FFT and matmul builds; measured with the CPU builds of
torch 2.13 and jax 0.9, losses agree to <= 4.2e-7, gradients to <= 5.2e-6
(qat on the fused scan; 1.7e-6 without codesign) and parameters after
three AdamW steps to <= 7.6e-8.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _torch_cores import share_cores  # noqa: E402

share_cores(torch)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import build_model as jbuild  # noqa: E402
from repro.core import codesign as jcd  # noqa: E402
from repro.core import config as jconfig  # noqa: E402
from repro.core import regularization as jreg  # noqa: E402
from repro.core import train_utils as jtu  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.optim import SGD as JSGD  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import clip_by_global_norm as jclip  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.runtime import inference as jinf  # noqa: E402
from repro_torch.core import codesign as tcd  # noqa: E402
from repro_torch.core import regularization as treg  # noqa: E402
from repro_torch.core import train_utils as ttu  # noqa: E402
from repro_torch.core.config import DONNConfig  # noqa: E402
from repro_torch.core.models import build_model  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.launch import serve_donn  # noqa: E402
from repro_torch.optim import SGD, AdamW, clip_by_global_norm  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.runtime.inference import freeze  # noqa: E402

RTOL = 1e-5
CPU = "cpu"


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _np_params(depth, n, seed=0):
    r = np.random.default_rng(seed)
    return {"phase": {f"layer_{i}": r.uniform(0, 2 * np.pi, (n, n))
                      .astype(np.float32) for i in range(depth)}}


def _to_torch(tree):
    return {"phase": {k: torch.from_numpy(v.copy())
                      for k, v in tree["phase"].items()}}


def _to_jax(tree):
    return {"phase": {k: jnp.asarray(v) for k, v in tree["phase"].items()}}


def _models(**kw):
    kw.setdefault("name", "tr")
    kw.setdefault("n", 32)
    kw.setdefault("depth", 3)
    kw.setdefault("distance", 0.05)
    kw.setdefault("det_size", 6)
    tcfg = DONNConfig(**kw)
    jcfg = jconfig.DONNConfig(**dataclasses.asdict(tcfg))
    return build_model(tcfg, device=CPU), jbuild(jcfg)


def _batch(b, seed=0):
    r = np.random.default_rng(seed)
    return (r.random((b, 28, 28), np.float32),
            r.integers(0, 10, b).astype(np.int32))


def _port_loss_grads(model, params, x, y):
    flat = {k: v.clone().requires_grad_(True)
            for k, v in params["phase"].items()}
    loss = ttu.mse_softmax_loss(model.apply({"phase": flat},
                                            torch.from_numpy(x)),
                                torch.from_numpy(y), 10)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return float(loss.detach()), {k: g.numpy() for k, g in zip(flat, grads)}


def _jax_loss_grads(model, params, x, y):
    def loss_fn(p):
        return jtu.mse_softmax_loss(model.apply(p, jnp.asarray(x)),
                                    jnp.asarray(y), 10)

    loss, grads = jax.value_and_grad(loss_fn)(_to_jax(params))
    return float(loss), {k: np.asarray(g) for k, g in grads["phase"].items()}


# ------------------------------------------------------------ codesign
@pytest.mark.parametrize("mode,levels,gamma", [
    ("qat", 256, 1.0), ("qat", 16, 1.2), ("gumbel_hard", 8, 1.0),
])
def test_codesign_straight_through_gradient_matches_reference(mode, levels,
                                                              gamma):
    """d phi_eff / d phi of the STE quantizers equals JAX's (1 for QAT)."""
    phi = np.random.default_rng(0).uniform(-7, 7, (6, 9)).astype(np.float32)
    w = np.random.default_rng(1).standard_normal((6, 9)).astype(np.float32)
    tdev = tcd.device_for_layer("qat", levels, gamma)
    jdev = jcd.device_for_layer("qat", levels, gamma)
    t = torch.from_numpy(phi).requires_grad_(True)
    val = tcd.apply_codesign(t, tdev, mode)
    (grad,) = torch.autograd.grad((val * torch.from_numpy(w)).sum(), t)
    jval, jvjp = jax.vjp(lambda p: jcd.apply_codesign(p, jdev, mode),
                         jnp.asarray(phi))
    (jgrad,) = jvjp(jnp.asarray(w))
    assert _rel(grad.numpy(), np.asarray(jgrad)) <= RTOL
    if mode == "qat":  # the straight-through estimator passes g unchanged
        np.testing.assert_array_equal(val.detach().numpy(), np.asarray(jval))
        np.testing.assert_array_equal(grad.numpy(), w)
    else:  # the hard level plus a soft residue from two softmax builds
        assert _rel(val.detach().numpy(), np.asarray(jval)) <= 1e-6


# ------------------------------------------------------------ model grads
@pytest.mark.parametrize("codesign", ["none", "qat"])
@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("engine", ["scan", "eager"])
def test_model_loss_and_phase_gradients_match_reference(engine, use_pallas,
                                                        codesign):
    tm, jm = _models(depth=3, gamma=1.12, codesign=codesign,
                     use_pallas=use_pallas, engine=engine)
    params = _np_params(3, 32)
    x, y = _batch(4)
    loss, grads = _port_loss_grads(tm, _to_torch(params), x, y)
    jloss, jgrads = _jax_loss_grads(jm, params, x, y)
    assert abs(loss - jloss) <= RTOL * abs(jloss)
    for k in jgrads:
        assert _rel(grads[k], jgrads[k]) <= RTOL, k


@pytest.mark.parametrize("use_pallas", [False, True])
def test_eager_engine_matches_scan_engine_in_the_port(use_pallas):
    """The port's own engine A/B: K4 per layer against the fused plan."""
    params = _to_torch(_np_params(3, 32, seed=2))
    x, y = _batch(5, seed=2)
    out = {}
    for engine in ("scan", "eager"):
        tm, _ = _models(depth=3, gamma=1.12, codesign="qat",
                        use_pallas=use_pallas, engine=engine)
        out[engine] = _port_loss_grads(tm, params, x, y)
    assert abs(out["eager"][0] - out["scan"][0]) <= RTOL * out["scan"][0]
    for k, g in out["scan"][1].items():
        assert _rel(out["eager"][1][k], g) <= RTOL, k


def test_prop_view_matches_reference():
    tm, jm = _models(depth=2, engine="eager", use_pallas=True)
    params = _np_params(2, 32, seed=3)
    x, _ = _batch(2, seed=3)
    got = tm.prop_view(_to_torch(params), torch.from_numpy(x))
    want = jm.prop_view(_to_jax(params), jnp.asarray(x))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert _rel(g.numpy(), np.asarray(w)) <= RTOL


def test_calibrate_gamma_matches_reference():
    tm, jm = _models(depth=3, gamma=1.12, codesign="qat", use_pallas=True)
    params = _np_params(3, 32, seed=5)
    x, _ = _batch(8, seed=5)
    got = treg.calibrate_gamma(tm, _to_torch(params), x)
    want = jreg.calibrate_gamma(jm, _to_jax(params), jnp.asarray(x))
    assert abs(got - want) <= 1e-6 * want


def test_remat_and_rng_are_refused():
    """remat and rng codesign run now (tests/test_torch_design.py); what
    is refused is a policy the reference does not know and an rng that is
    not a ``torch.Generator``."""
    with pytest.raises(ValueError, match="remat"):
        _models(depth=2, remat="everything")
    assert _models(depth=2, remat="layer")[0].plan.remat == "layer"
    tm, _ = _models(depth=2, engine="eager", codesign="gumbel",
                    device_levels=8)
    with pytest.raises(TypeError, match="Generator"):
        tm.apply(_to_torch(_np_params(2, 32)),
                 torch.from_numpy(_batch(1)[0]), rng=object())


# ------------------------------------------------------------ optimizers
@pytest.mark.parametrize("opt", ["adamw", "adamw_wd_clip", "sgd",
                                 "sgd_momentum"])
def test_three_train_steps_track_reference(opt):
    """Params and losses after 3 steps on the same batches (codesign none;
    lr 1e-2 so Adam's normalized first step stays far from rounding)."""
    tm, jm = _models(depth=2, gamma=1.12, use_pallas=True)
    topt, jopt = {
        "adamw": (AdamW(lr=1e-2), JAdamW(lr=1e-2)),
        "adamw_wd_clip": (
            AdamW(lr=tsched.warmup_cosine(1e-2, 1, 3), weight_decay=1e-2,
                  grad_clip_norm=0.05),
            JAdamW(lr=jsched.warmup_cosine(1e-2, 1, 3), weight_decay=1e-2,
                   grad_clip_norm=0.05)),
        "sgd": (SGD(lr=0.5), JSGD(lr=0.5)),
        "sgd_momentum": (SGD(lr=0.5, momentum=0.9),
                         JSGD(lr=0.5, momentum=0.9)),
    }[opt]
    params = _np_params(2, 32, seed=4)
    tp, jp = _to_torch(params), _to_jax(params)
    ts, js = topt.init(tp), jopt.init(jp)
    tstep = ttu.make_train_step(tm, topt, 10)
    jstep = jtu.make_train_step(jm, jopt, 10)
    for i in range(3):
        x, y = _batch(4, seed=10 + i)
        tp, ts, tloss, _ = tstep(tp, ts, i, x, y)
        jp, js, jloss, _ = jstep(jp, js, jnp.asarray(i), x, y,
                                 jax.random.PRNGKey(0))
        assert abs(float(tloss) - float(jloss)) <= RTOL * float(jloss)
    for k, v in jp["phase"].items():
        assert _rel(tp["phase"][k].numpy(), np.asarray(v)) <= RTOL, k


def test_clip_by_global_norm_matches_reference():
    r = np.random.default_rng(5)
    tree = {"a": r.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": r.standard_normal(7).astype(np.float32)}}
    for max_norm in (0.5, 100.0):
        got = clip_by_global_norm(
            {"a": torch.from_numpy(tree["a"]),
             "b": {"c": torch.from_numpy(tree["b"]["c"])}}, max_norm)
        want = jclip(jax.tree.map(jnp.asarray, tree), max_norm)
        assert _rel(got["a"].numpy(), np.asarray(want["a"])) <= RTOL
        assert _rel(got["b"]["c"].numpy(),
                    np.asarray(want["b"]["c"])) <= RTOL


@pytest.mark.parametrize("name,args", [
    ("constant", (0.3,)), ("warmup_cosine", (0.1, 3, 10)),
    ("step_decay", (0.2, 0.5, 3)),
])
def test_schedules_match_reference(name, args):
    fn, jfn = getattr(tsched, name)(*args), getattr(jsched, name)(*args)
    for step in range(12):
        assert abs(float(fn(torch.tensor(step))) - float(jfn(step))) \
            <= 1e-7 * max(abs(float(jfn(step))), 1.0)


# ------------------------------------------------------------ drivers
def _chunk_setup(guard=False):
    tm, _ = _models(depth=2, gamma=1.12, codesign="qat", use_pallas=True)
    opt = AdamW(lr=0.05)
    params = _to_torch(_np_params(2, 32, seed=6))
    xs = np.stack([_batch(4, seed=20 + i)[0] for i in range(3)])
    ys = np.stack([_batch(4, seed=20 + i)[1] for i in range(3)])
    chunk = ttu.make_train_chunk(tm, opt, 10, guard=guard)
    return tm, opt, params, xs, ys, chunk


def _assert_trees_equal(a, b):
    for k in a["phase"]:
        assert torch.equal(a["phase"][k], b["phase"][k]), k


def test_chunk_equals_steps_iterated():
    tm, opt, params, xs, ys, chunk = _chunk_setup()
    cp, cs, closs, cacc = chunk(params, opt.init(params), 0, xs, ys)
    step = ttu.make_train_step(tm, opt, 10)
    sp, ss = params, opt.init(params)
    for i in range(3):
        sp, ss, loss, acc = step(sp, ss, i, xs[i], ys[i])
        assert float(loss) == float(closs[i]) and float(acc) == float(cacc[i])
    _assert_trees_equal(cp, sp)
    for a, b in zip(cs, ss):
        _assert_trees_equal({"phase": a["phase"]}, {"phase": b["phase"]})


def test_train_classifier_chunked_equals_per_step_with_partial_chunk():
    tm, _ = _models(depth=2, gamma=1.12, codesign="qat", use_pallas=True)
    params = _to_torch(_np_params(2, 32, seed=7))
    before = {k: v.clone() for k, v in params["phase"].items()}
    xs, ys = tsyn.synth_digits(40, seed=3)
    runs = [ttu.train_classifier(tm, params,
                                 tsyn.batch_iterator(xs, ys, 4, seed=1),
                                 steps=5, lr=0.05, steps_per_call=spc,
                                 prefetch=2)
            for spc in (1, 2)]  # 5 steps in chunks of 2: a partial chunk
    assert runs[0].losses == runs[1].losses and len(runs[0].losses) == 5
    _assert_trees_equal(runs[0].params, runs[1].params)
    # the caller's tensors survive and are not the ones handed back
    _assert_trees_equal(params, {"phase": before})
    assert all(runs[1].params["phase"][k] is not params["phase"][k]
               for k in before)


def test_guarded_nan_step_is_an_exact_noop():
    tm, opt, params, xs, ys, chunk = _chunk_setup(guard=True)
    state = opt.init(params)
    xs_bad = xs.copy()
    xs_bad[1] = np.nan
    gp, gs, losses, _, skipped, ok = chunk(params, state, 0, xs_bad, ys)
    assert skipped.tolist() == [False, True, False] and bool(ok)
    assert not np.isfinite(float(losses[1]))
    # the poisoned row left no trace: same as the two good rows alone
    rp, rs, _, _, rskipped, _ = chunk(params, state, 0, xs[[0, 2]],
                                      ys[[0, 2]])
    assert not rskipped.any()
    _assert_trees_equal(gp, rp)
    for a, b in zip(gs, rs):
        _assert_trees_equal({"phase": a["phase"]}, {"phase": b["phase"]})
    # a chunk of one poisoned step changes nothing, counter included
    p1, s1, _, _, sk1, _ = chunk(params, state, 5, xs_bad[1:2], ys[1:2])
    assert sk1.tolist() == [True]
    _assert_trees_equal(p1, params)
    for a, b in zip(s1, state):
        _assert_trees_equal({"phase": a["phase"]}, {"phase": b["phase"]})
    it = iter([(xs_bad[i], ys[i]) for i in range(3)])
    res = ttu.train_classifier(tm, params, it, steps=3, lr=0.05,
                               steps_per_call=3, guard=True, prefetch=0)
    assert res.skipped_steps == 1 and len(res.losses) == 3
    _assert_trees_equal(res.params, gp)


def test_train_classifier_refuses_what_waits(tmp_path):
    """Checkpoint rollback has landed (``ckpt_dir`` trains and saves step
    0); what stays refused is the guard on the per-step driver."""
    tm, _ = _models(depth=2)
    params = _to_torch(_np_params(2, 32))
    it = tsyn.batch_iterator(*tsyn.synth_digits(8), 4)
    res = ttu.train_classifier(tm, params, it, steps=2,
                               ckpt_dir=tmp_path / "ck", steps_per_call=2,
                               guard=True)
    assert res.rollbacks == 0 and (tmp_path / "ck" / "LATEST").exists()
    with pytest.raises(ValueError, match="chunked"):
        ttu.train_classifier(tm, params, it, steps=2, guard=True)


def test_loss_accuracy_and_evaluation():
    r = np.random.default_rng(8)
    logits = r.standard_normal((6, 10)).astype(np.float32)
    labels = r.integers(0, 10, 6).astype(np.int32)
    got = ttu.mse_softmax_loss(torch.from_numpy(logits),
                               torch.from_numpy(labels), 10)
    want = jtu.mse_softmax_loss(jnp.asarray(logits), jnp.asarray(labels), 10)
    assert abs(float(got) - float(want)) <= 1e-6 * float(want)
    assert float(ttu.accuracy(torch.from_numpy(logits),
                              torch.from_numpy(labels))) == float(
        jtu.accuracy(jnp.asarray(logits), jnp.asarray(labels)))
    pos = torch.from_numpy(np.abs(logits))
    noisy = ttu.add_detector_noise(pos, torch.Generator().manual_seed(0),
                                   0.1)
    d = noisy - pos
    assert (d >= 0).all() and (d <= 0.1 * pos.amax(-1, keepdim=True)).all()
    tm, jm = _models(depth=2, use_pallas=True)
    params = _np_params(2, 32, seed=9)
    xs, ys = tsyn.synth_digits(16, seed=4)
    got = ttu.evaluate_classifier(tm, _to_torch(params),
                                  tsyn.batch_iterator(xs, ys, 4), 3)
    want = jtu.evaluate_classifier(jm, _to_jax(params),
                                   jsyn.batch_iterator(xs, ys, 4), 3)
    assert got == want


# ------------------------------------------------------------ data
def test_synthetic_data_is_byte_equal_to_reference():
    xs, ys = tsyn.synth_digits(24, seed=5)
    jxs, jys = jsyn.synth_digits(24, seed=5)
    assert xs.tobytes() == jxs.tobytes() and ys.tobytes() == jys.tobytes()
    bx, by = tsyn.synth_digits(4, seed=1, size=20, binarize=True)
    jbx, jby = jsyn.synth_digits(4, seed=1, size=20, binarize=True)
    assert bx.tobytes() == jbx.tobytes() and by.tobytes() == jby.tobytes()
    it = tsyn.batch_iterator(xs, ys, 5, seed=2, host_id=1, num_hosts=2)
    jit_ = jsyn.batch_iterator(xs, ys, 5, seed=2, host_id=1, num_hosts=2)
    for _ in range(4):  # past one epoch of the host's 12 samples
        (a, b), (c, d) = next(it), next(jit_)
        assert a.tobytes() == c.tobytes() and b.tobytes() == d.tobytes()


def test_stack_batches_and_device_prefetch_keep_order():
    batches = [(np.full((2, 3), i, np.float32), np.array([i, -i]))
               for i in range(7)]
    got = list(tpipe.stack_batches(iter(batches), 3))
    want = list(jpipe.stack_batches(iter(batches), 3))
    assert [g[0].shape[0] for g in got] == [3, 3, 1]
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert len(list(tpipe.stack_batches(iter(batches), 2, total=5))) == 3
    fed = list(tpipe.device_prefetch(iter(got), size=2, device=CPU))
    assert len(fed) == 3
    for f, g in zip(fed, got):
        assert isinstance(f[0], torch.Tensor)
        np.testing.assert_array_equal(f[0].numpy(), g[0])
        np.testing.assert_array_equal(f[1].numpy(), g[1])
    with pytest.raises(ValueError, match="size"):
        next(tpipe.device_prefetch(iter(got), size=0, device=CPU))
    pf = tpipe.Prefetcher(iter(range(5)), depth=2, transform=lambda v: v * 2)
    assert list(pf) == [0, 2, 4, 6, 8]

    def boom():
        yield 1
        raise RuntimeError("feeder failed")

    pf = tpipe.Prefetcher(boom())
    assert next(pf) == 1
    with pytest.raises(RuntimeError, match="feeder failed"):
        next(pf)


# ------------------------------------------------------------ slice
def test_train_then_freeze_serves_like_reference():
    """train_classifier (chunked) in both packages from one numpy init,
    then each package's freeze serves the same logits (codesign none: a
    trained phase is never compared across a rounding boundary)."""
    tm, jm = _models(depth=2, gamma=1.12, use_pallas=True)
    params = _np_params(2, 32, seed=11)
    xs, ys = tsyn.synth_digits(32, seed=6)
    tres = ttu.train_classifier(tm, _to_torch(params),
                                tsyn.batch_iterator(xs, ys, 4, seed=1),
                                steps=6, lr=0.05, steps_per_call=4)
    jres = jtu.train_classifier(jm, _to_jax(params),
                                jsyn.batch_iterator(xs, ys, 4, seed=1),
                                steps=6, lr=0.05, steps_per_call=4)
    assert _rel(tres.losses, jres.losses) <= RTOL
    for k, v in jres.params["phase"].items():
        assert _rel(tres.params["phase"][k].numpy(), np.asarray(v)) <= RTOL
    x = np.random.default_rng(12).random((5, 28, 28), np.float32)
    got = freeze(tm, tres.params, device=CPU).forward(
        torch.from_numpy(x)).numpy()
    want = np.asarray(jinf.freeze(jm, jres.params).forward(jnp.asarray(x)))
    assert _rel(got, want) <= RTOL
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_serve_cli_trains_then_serves(capsys):
    rps = serve_donn.main(["--train-steps", "4", "--n", "32", "--depth", "2",
                           "--det-size", "6", "--requests", "8",
                           "--device", "cpu"])
    out = capsys.readouterr().out
    assert rps > 0
    assert "trained 4 steps" in out and "8/8 requests served" in out
