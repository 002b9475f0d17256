"""The port's LM training slice against the JAX package, on the CPU.

Parameters come from the JAX package (``repro.models.lm.init``, numpy on
the way over) through ``repro_torch.convert.lm_params_from_jax``; inputs
and token streams from seeded numpy generators.

Tolerances (max|port - jax| / max|jax| a leaf), measured with the CPU
builds of torch 2.13 and jax 0.9 over the five dense/ssm smoke configs:
- f32 ``lm_loss`` within 1.7e-7 and every gradient within 2.0e-6, remat
  on and off: held at 1e-5.
- bf16 (the configs' own dtype): the frameworks round the bf16 matmuls at
  other places; the loss is held at 1e-2 and the gradients at 0.15 of
  the max (measured in the test and printed).
- three ``make_train_step`` steps against ``jax.jit`` of the reference's
  step at the launcher's optimizer (lr 3e-4, warmup 20, wd 0.01, clip 1):
  losses and ``grad_norm`` within 1.2e-6 (held at 1e-5); params within
  4.1e-6 (held at 1e-5) except the leaves initialised at zero (the
  biases ``bq``, ``bk``, ``bv`` and mamba's ``conv_b``), whose values
  after three steps are three AdamW updates of about lr each: AdamW
  divides each gradient entry by its own magnitude, so an entry below
  rounding (``bk``'s gradient is zero in exact arithmetic: softmax
  ignores a shift shared by every key) or near eps moves by up to lr
  whatever its sign or size, and the two frameworks part there
  (measured up to 1.4e-3 of the leaf's max, held at 1e-2; ROADMAP
  queue 3).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _torch_cores import share_cores  # noqa: E402

share_cores(torch)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.data import pipeline as jpipe  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.models import get_config as jget  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import warmup_cosine as jwarmup  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    lm_params_from_jax, lm_train_state_from_jax,
)
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import get_config as tget  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.optim import AdamW, warmup_cosine  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map, tree_paths  # noqa: E402

RTOL = 1e-5
ARCHS = ("glm4-9b", "granite-8b", "qwen1.5-4b", "qwen2.5-14b",
         "falcon-mamba-7b", "musicgen-medium")
ZERO_INIT_RTOL = 1e-2  # the params of leaves initialised at zero (above)
BF16_LOSS_RTOL = 1e-2
BF16_GRAD_RTOL = 0.15


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.max(np.abs(want))
    return float(np.max(np.abs(got - want)) / (scale if scale else 1.0))


def _cfgs(arch, dtype="float32", **kw):
    """(jax cfg, port cfg) of an arch's smoke config in ``dtype``."""
    jc = dataclasses.replace(jget(arch, smoke=True),
                             dtype=getattr(jnp, dtype), **kw)
    tc = dataclasses.replace(tget(arch, smoke=True),
                             dtype=getattr(torch, dtype), **kw)
    return jc, tc


def _params(jc, seed=0):
    jp = jlm.init(jc, jax.random.PRNGKey(seed))
    return jp, lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _batch(vocab, B=4, S=37, seed=0, pad_rows=True):
    r = np.random.default_rng(seed)
    toks = r.integers(0, vocab, (B, S)).astype(np.int32)
    labs = r.integers(0, vocab, (B, S)).astype(np.int32)
    if pad_rows:
        labs[0, :5] = -1
        labs[-1, -3:] = -1
    return ({"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)},
            {"tokens": torch.from_numpy(toks),
             "labels": torch.from_numpy(labs)})


def _loss_and_grads(tp, tb, tc):
    """lm_loss and autograd's gradients of every (stacked) leaf."""
    params = tree_map(lambda t: t.detach().requires_grad_(True), tp)
    leaves = tree_leaves(params)
    loss = tlm.lm_loss(params, tb, tc)
    return loss.detach(), torch.autograd.grad(loss, leaves)


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("batch,seq,vocab,seed,host_id,num_hosts", [
    (4, 16, 256, 0, 0, 1),
    (2, 33, 97, 5, 0, 1),
    (3, 8, 256, 1, 1, 2),
    (2, 12, 1000, 2, 3, 4),
])
def test_token_batch_iterator_is_byte_equal(batch, seq, vocab, seed,
                                            host_id, num_hosts):
    ji = jsyn.token_batch_iterator(batch, seq, vocab, seed=seed,
                                   host_id=host_id, num_hosts=num_hosts)
    ti = tsyn.token_batch_iterator(batch, seq, vocab, seed=seed,
                                   host_id=host_id, num_hosts=num_hosts)
    for _ in range(3):
        jb, tb = next(ji), next(ti)
        assert sorted(jb) == sorted(tb) == ["labels", "tokens"]
        for k in jb:
            assert tb[k].dtype == jb[k].dtype == np.int32
            assert tb[k].tobytes() == jb[k].tobytes(), k


@pytest.mark.parametrize("num,seq,vocab,seed,frac", [
    (3, 20, 50, 0, 0.75), (2, 9, 151936, 4, 0.75), (2, 15, 30, 1, 0.0),
])
def test_synth_tokens_is_byte_equal(num, seq, vocab, seed, frac):
    j = jsyn.synth_tokens(num, seq, vocab, seed=seed, bigram_frac=frac)
    t = tsyn.synth_tokens(num, seq, vocab, seed=seed, bigram_frac=frac)
    assert t.dtype == j.dtype and t.tobytes() == j.tobytes()


def test_step_monitor_flags_the_same_stragglers():
    r = np.random.default_rng(3)
    series = list(0.1 + 0.002 * r.standard_normal(120))
    for k in (9, 30, 31, 77, 110):  # straggling steps
        series[k] *= 4.0
    jm = jpipe.StepMonitor(alpha=0.2, window=20, z_thresh=3.0)
    tm = tpipe.StepMonitor(alpha=0.2, window=20, z_thresh=3.0)
    for i, dt in enumerate(series):
        jm.record(dt, i if i % 2 else None)
        tm.record(dt, i if i % 2 else None)
    assert tm.stragglers == jm.stragglers
    # step 9 by its label; step 30 unlabelled, so by its count (31)
    assert [s["step"] for s in tm.stragglers][:2] == [9, 31]
    assert (tm.ema, tm.steps, tm.straggler_fraction) == (
        jm.ema, jm.steps, jm.straggler_fraction)
    tm.start()
    assert tm.stop(7) >= 0.0 and tm.steps == 121


# ------------------------------------------------------------------ loss
@pytest.mark.parametrize("arch,S,chunk", [
    ("glm4-9b", 21, 8), ("glm4-9b", 16, 16), ("qwen1.5-4b", 21, 5),
    ("falcon-mamba-7b", 21, 512),
])
def test_chunked_xent_matches_jax(arch, S, chunk):
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc)
    r = np.random.default_rng(1)
    x = r.standard_normal((3, S, jc.d_model)).astype(np.float32)
    labels = r.integers(0, jc.vocab, (3, S)).astype(np.int32)
    labels[1, 2:7] = -1
    labels[2, -1] = -1

    def jloss(emb, xx):
        return jlm.chunked_xent({"embed": emb}, xx, jnp.asarray(labels), jc,
                                chunk=chunk)

    jl, (jge, jgx) = jax.value_and_grad(jloss, argnums=(0, 1))(
        jp["embed"], jnp.asarray(x))
    emb = tree_map(lambda t: t.detach().requires_grad_(True), tp["embed"])
    xt = torch.from_numpy(x).requires_grad_(True)
    tl = tlm.chunked_xent({"embed": emb}, xt, torch.from_numpy(labels), tc,
                          chunk=chunk)
    leaves = tree_leaves(emb) + [xt]
    tg = [torch.zeros_like(t) if g is None else g for t, g in zip(
        leaves, torch.autograd.grad(tl, leaves, allow_unused=True))]
    assert abs(float(tl) - float(jl)) <= RTOL * abs(float(jl))
    for got, want in zip(tg, jax.tree.leaves(jge) + [jgx]):
        assert _rel(got, want) <= RTOL


def test_chunked_xent_with_every_label_masked_is_zero():
    _, tc = _cfgs("glm4-9b")
    tp = tlm.init(tc, torch.Generator().manual_seed(0))
    x = torch.randn(2, 5, tc.d_model, generator=torch.Generator()
                    .manual_seed(1))
    loss = tlm.chunked_xent(tp, x, torch.full((2, 5), -1), tc, chunk=2)
    assert float(loss) == 0.0


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_jax(arch, remat):
    jc, tc = _cfgs(arch, remat=remat)
    jp, tp = _params(jc)
    jb, tb = _batch(jc.vocab)
    jl, jg = jax.value_and_grad(lambda p: jlm.lm_loss(p, jb, jc))(jp)
    tl, tg = _loss_and_grads(tp, tb, tc)
    assert abs(float(tl) - float(jl)) <= RTOL * abs(float(jl))
    for path, got, want in zip(tree_paths(tp), tg, jax.tree.leaves(jg)):
        assert _rel(got, want) <= RTOL, path


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_recomputes_the_same_values_bit_for_bit(arch):
    _, tc = _cfgs(arch)
    jc, _ = _cfgs(arch)
    _, tp = _params(jc)
    _, tb = _batch(tc.vocab)
    l1, g1 = _loss_and_grads(tp, tb, tc)
    l0, g0 = _loss_and_grads(tp, tb, dataclasses.replace(tc, remat=False))
    assert torch.equal(l1, l0)
    assert all(torch.equal(a, b) for a, b in zip(g1, g0))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_and_grads_stay_near_jax(arch):
    jc, tc = _cfgs(arch, dtype="bfloat16")
    jp, tp = _params(jc)
    jb, tb = _batch(jc.vocab)
    jl, jg = jax.value_and_grad(lambda p: jlm.lm_loss(p, jb, jc))(jp)
    tl, tg = _loss_and_grads(tp, tb, tc)
    loss_rel = abs(float(tl) - float(jl)) / abs(float(jl))
    grad_rel = max(_rel(a, b) for a, b in zip(tg, jax.tree.leaves(jg)))
    print(f"{arch} bf16: loss rel {loss_rel:.3e}, grads rel {grad_rel:.3e}")
    assert tl.dtype == torch.float32
    assert loss_rel <= BF16_LOSS_RTOL and grad_rel <= BF16_GRAD_RTOL


def test_loss_and_grads_equal_autograd_of_the_stacked_leaves():
    """The train step's per-layer leaves give autograd's gradients of the
    stacked parameters, bit for bit."""
    jc, tc = _cfgs("qwen1.5-4b")
    _, tp = _params(jc)
    _, tb = _batch(tc.vocab)
    want_l, want = _loss_and_grads(tp, tb, tc)
    loss, grads = tsteps.loss_and_grads(
        lambda p, b: tlm.lm_loss(p, b, tc), tp, tb)
    assert torch.equal(loss, want_l)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(grads), want))
    assert not any(t.requires_grad or t.grad is not None
                   for t in tree_leaves(tp))


# ------------------------------------------------------------------ steps
def _launcher_optimizers(state_dtype):
    kw = dict(weight_decay=0.01, grad_clip_norm=1.0)
    return (JAdamW(lr=jwarmup(3e-4, 20, 100), state_dtype=getattr(
                jnp, state_dtype), **kw),
            AdamW(lr=warmup_cosine(3e-4, 20, 100), state_dtype=getattr(
                torch, state_dtype), **kw))


@pytest.mark.parametrize("accum,state_dtype", [
    (1, "float32"), (2, "float32"), (1, "bfloat16"),
])
@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_match_jax(arch, accum, state_dtype):
    jc, tc = _cfgs(arch)
    jopt, topt = _launcher_optimizers(state_dtype)
    jstate = jsteps.init_train_state(jc, jax.random.PRNGKey(0), jopt)
    tstate = lm_train_state_from_jax(jax.tree.map(np.asarray, jstate),
                                     device="cpu")
    assert tstate["mu"]["embed"]["table"].dtype == getattr(torch, state_dtype)
    jfn = jax.jit(jsteps.make_train_step(jc, jopt, accum_steps=accum))
    tfn = tsteps.make_train_step(tc, topt, accum_steps=accum)
    for i in range(3):
        jb, tb = _batch(jc.vocab, seed=10 + i, pad_rows=False)
        jstate, jm = jfn(jstate, jb)
        tstate, tm = tfn(tstate, tb)
        for k in ("loss", "grad_norm"):
            assert abs(float(tm[k]) - float(jm[k])) <= RTOL * abs(
                float(jm[k])), (i, k, float(tm[k]), float(jm[k]))
    assert int(tstate["step"]) == 3
    inits = [spec.init for spec in tree_leaves(tlm.param_specs(tc))]
    for init, path, got, want in zip(inits, tree_paths(tstate["params"]),
                                     tree_leaves(tstate["params"]),
                                     jax.tree.leaves(jstate["params"])):
        tol = ZERO_INIT_RTOL if init == "zeros" else RTOL
        assert _rel(got, want) <= tol, path
    for name in ("mu", "nu"):
        for got, want in zip(tree_leaves(tstate[name]),
                             jax.tree.leaves(jstate[name])):
            assert got.dtype == getattr(torch, state_dtype)


def test_train_step_donates_the_state():
    jc, tc = _cfgs("glm4-9b")
    _, topt = _launcher_optimizers("float32")
    state = tsteps.init_train_state(tc, torch.Generator().manual_seed(0),
                                    topt)
    before = [t.data_ptr() for t in tree_leaves(state["params"])]
    _, tb = _batch(tc.vocab)
    new, m = tsteps.make_train_step(tc, topt)(state, tb)
    assert [t.data_ptr() for t in tree_leaves(new["params"])] == before
    assert set(m) == {"loss", "grad_norm"} and int(new["step"]) == 1


def test_compile_train_step_places_copies_and_refuses_meshes():
    _, tc = _cfgs("glm4-9b")
    specs = {"tokens": tsteps.ParamSpec((4, 8), torch.int32),
             "labels": tsteps.ParamSpec((4, 8), torch.int32)}
    fn, s_place, b_place, sspecs = tsteps.compile_train_step(
        tc, None, specs, donate=False, device="cpu", accum_steps=2)
    assert s_place == b_place == torch.device("cpu")
    assert sspecs["mu"]["embed"]["table"].init == "zeros"
    opt = AdamW(lr=1e-4, grad_clip_norm=1.0)
    state = tsteps.init_train_state(tc, torch.Generator().manual_seed(0), opt)
    keep = tree_map(torch.clone, state)
    _, tb = _batch(tc.vocab, B=4, S=8)
    new, _ = fn(state, tb)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state),
                                                 tree_leaves(keep)))
    assert not torch.equal(new["params"]["embed"]["table"],
                           state["params"]["embed"]["table"])
    with pytest.raises(ValueError, match="micro-batches"):
        tsteps.compile_train_step(tc, None, specs, accum_steps=3,
                                  device="cpu")

    class Mesh2:
        shape = {"data": 2, "model": 1}

    # a mesh beyond one device is no longer refused: the placements are
    # spec tuples (the ranks' steps run in test_torch_lm_mesh*.py)
    _, s_place, b_place, _ = tsteps.compile_train_step(tc, Mesh2(), specs,
                                                       device="cpu")
    assert s_place["params"]["embed"]["table"] == (None, "data")
    assert s_place["mu"]["blocks"]["attn"]["wq"] == (None, "data")
    assert s_place["step"] == ()
    assert b_place == {"tokens": ("data", None), "labels": ("data", None)}


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["glm4-9b", "falcon-mamba-7b"])
def test_train_state_specs_match_the_reference(arch, state_dtype):
    jc, tc = _cfgs(arch)
    js = jsteps.train_state_specs(jc, state_dtype=getattr(jnp, state_dtype),
                                  param_dtype=jnp.bfloat16)
    ts = tsteps.train_state_specs(tc, state_dtype=getattr(torch,
                                                          state_dtype),
                                  param_dtype=torch.bfloat16)
    jl = jax.tree.leaves(js, is_leaf=lambda x: hasattr(x, "init"))
    tl = tree_leaves(ts)
    assert len(jl) == len(tl)
    for a, b in zip(tl, jl):
        assert (tuple(a.shape), tuple(a.logical_axes), a.init) == (
            tuple(b.shape), tuple(b.logical_axes), b.init)
        assert str(a.dtype).split(".")[-1] == np.dtype(b.dtype).name
    sp = tsteps.serving_param_specs(tc, torch.bfloat16)
    assert all(s.dtype == torch.bfloat16 for s in tree_leaves(sp))


def test_lm_train_state_from_jax_keeps_bf16_moments_bit_for_bit():
    jc, _ = _cfgs("glm4-9b")
    jopt, _ = _launcher_optimizers("bfloat16")
    js = jsteps.init_train_state(jc, jax.random.PRNGKey(0), jopt)
    js["mu"] = jax.tree.map(lambda m: (m + 0.3).astype(jnp.bfloat16),
                            js["mu"])
    host = jax.tree.map(np.asarray, js)
    ts = lm_train_state_from_jax(host, device="cpu")
    for got, want in zip(tree_leaves(ts["mu"]), jax.tree.leaves(js["mu"])):
        assert got.dtype == torch.bfloat16
        assert got.view(torch.int16).numpy().tobytes() == np.asarray(
            want).tobytes()
    # copies: the train step's in-place update leaves the caller's arrays
    for t in tree_leaves(ts):
        t.add_(1)
    for got, want in zip(jax.tree.leaves(host), jax.tree.leaves(js)):
        assert np.asarray(got).tobytes() == np.asarray(want).tobytes()
    assert ts["step"].dtype == torch.int32
    with pytest.raises(ValueError, match="missing"):
        lm_train_state_from_jax({"params": {}}, device="cpu")


# ------------------------------------------------------------------ AdamW
@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("state_dtype", [torch.float32, torch.bfloat16])
def test_blocked_adamw_is_bitwise_the_unblocked_update(state_dtype, donate):
    g = torch.Generator().manual_seed(0)
    params = {"stack": torch.randn(40, 6, 5, generator=g),
              "odd": torch.randn(7, 9, generator=g),
              "vec": torch.randn(33, generator=g),
              "scalar": torch.randn((), generator=g)}
    kw = dict(lr=warmup_cosine(1e-2, 2, 10), weight_decay=0.01,
              grad_clip_norm=1.0, state_dtype=state_dtype)
    whole, blocked = AdamW(**kw), AdamW(scan_threshold=10, **kw)
    p1, s1 = params, whole.init(params)
    p2 = tree_map(torch.clone, params)
    s2 = blocked.init(params)
    for i in range(4):
        grads = tree_map(lambda t: torch.randn(t.shape, generator=g) * 3e-3,
                         params)
        p1, s1 = whole.update(grads, s1, p1, i)
        keep = tree_map(torch.clone, (grads, s2, p2))
        p2n, s2n = blocked.update(grads, s2, p2, i, donate=donate)
        if donate:  # written into the caller's tensors
            assert p2n["stack"] is p2["stack"]
        else:  # the arguments stay as they were
            assert all(torch.equal(a, b) for a, b in zip(
                tree_leaves((grads, s2, p2)), tree_leaves(keep)))
        p2, s2 = p2n, s2n
    for a, b in zip(tree_leaves((p1, s1)), tree_leaves((p2, s2))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert s2.mu["stack"].dtype == state_dtype


def test_adamw_blocks_follow_the_references_chunks():
    from repro_torch.optim.adamw import _chunks

    assert [_chunks(n) for n in (40, 64, 151936, 2560, 7, 1)] == [
        20, 32, 32, 32, 7, 1]


def test_adamw_state_dtype_matches_the_reference_update():
    jopt, topt = _launcher_optimizers("bfloat16")
    r = np.random.default_rng(0)
    p = {"w": r.standard_normal((4, 5)).astype(np.float32)}
    g = {"w": (1e-3 * r.standard_normal((4, 5))).astype(np.float32)}
    jp, js = {"w": jnp.asarray(p["w"])}, jopt.init({"w": jnp.asarray(p["w"])})
    tp, ts = {"w": torch.from_numpy(p["w"])}, topt.init(
        {"w": torch.from_numpy(p["w"])})
    for i in range(3):
        jp, js = jopt.update({"w": jnp.asarray(g["w"])}, js, jp,
                             jnp.asarray(i))
        tp, ts = topt.update({"w": torch.from_numpy(g["w"])}, ts, tp, i)
    assert _rel(tp["w"], jp["w"]) <= RTOL
    assert ts.mu["w"].dtype == torch.bfloat16
    assert _rel(ts.nu["w"].float(), np.asarray(js.nu["w"], np.float32)) \
        <= 1e-2


# ------------------------------------------------------------------ scan
def _plain_scan(dt, Bs, Cs, xc, A, h0):
    """The step loop with no chunking and no checkpoint."""
    h, ys = h0, []
    for t in range(xc.shape[1]):
        dA = torch.exp(dt[:, t][..., None] * A)
        h = dA * h + (dt[:, t] * xc[:, t])[..., None] * Bs[:, t, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, Cs[:, t]))
    return torch.stack(ys, dim=1), h


@pytest.mark.parametrize("S,chunk", [(13, 4), (16, 8), (5, 8)])
def test_chunk_checkpointed_scan_is_bitwise_the_plain_loop(S, chunk):
    g = torch.Generator().manual_seed(S)
    B, D, N = 2, 6, 3
    dt = (torch.rand(B, S, D, generator=g) * 0.5).requires_grad_(True)
    xc = torch.randn(B, S, D, generator=g).requires_grad_(True)
    Bs = torch.randn(B, S, N, generator=g).requires_grad_(True)
    Cs = torch.randn(B, S, N, generator=g).requires_grad_(True)
    A = (-torch.exp(torch.randn(D, N, generator=g))).requires_grad_(True)
    h0 = torch.randn(B, D, N, generator=g).requires_grad_(True)
    ins = (dt, Bs, Cs, xc, A, h0)
    y, h = tssm._selective_scan(*ins, chunk)
    y0, h0_ = _plain_scan(*ins)
    assert torch.equal(y, y0) and torch.equal(h, h0_)
    w = torch.randn(y.shape, generator=g)
    got = torch.autograd.grad((y * w).sum() + h.sum(), ins)
    want = torch.autograd.grad((y0 * w).sum() + h0_.sum(), ins)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with torch.no_grad():  # serving: no checkpoint, the same values
        y2, _ = tssm._selective_scan(*ins, chunk)
    assert torch.equal(y2, y0)


def test_selective_scan_grads_match_jax():
    jc, tc = _cfgs("falcon-mamba-7b")
    r = np.random.default_rng(2)
    B, S, D, N = 2, 11, 8, 4
    arrs = [r.uniform(0.01, 0.5, (B, S, D)), r.standard_normal((B, S, N)),
            r.standard_normal((B, S, N)), r.standard_normal((B, S, D)),
            -np.exp(r.standard_normal((D, N))), np.zeros((B, D, N))]
    arrs = [a.astype(np.float32) for a in arrs]

    def jf(*a):
        y, h = jssm._selective_scan(*a, chunk=4)
        return jnp.sum(y * y) + jnp.sum(h)

    jg = jax.grad(jf, argnums=tuple(range(6)))(*map(jnp.asarray, arrs))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrs]
    y, h = tssm._selective_scan(*ts, 4)
    tg = torch.autograd.grad((y * y).sum() + h.sum(), ts)
    for got, want in zip(tg, jg):
        assert _rel(got, want) <= RTOL


# ------------------------------------------------------------------ mesh
def test_launch_mesh_refusals_need_no_process_group():
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmesh.make_host_mesh(2, 1, device="cpu")
    with pytest.raises(ValueError, match="needs 8 ranks"):
        tmesh.make_mesh((2, 2, 2), ("pod", "data", "model"), device="cpu")
    with pytest.raises(NotImplementedError, match="meshes"):
        tmesh.make_mesh((2, 2), ("model", "data"), device="cpu")
    assert not torch.distributed.is_initialized()
