"""The port's LM mesh against the unmeshed JAX package, and its elastic
checkpoints, compressed mean, global norm and launchers, on the CPU.

GSPMD does not change what a step computes, and the reference's own LM
mesh tests (``tests/test_distributed.py``'s ``SUITE``) fail under jax 0.9
(``ShardingTypeError``), so the sharded port is held against the
reference's unmeshed functions: ``repro.models.lm.logits_fn``,
``decode_step`` and ``lm_loss``'s gradient, and
``jax.jit(repro.runtime.steps.make_train_step(cfg, opt))``.
Parameters come from the JAX ``init``; inputs from seeded numpy
generators.  The mesh cases run on gloo ranks (one spawn a mesh shape:
(2, 2), then (1, 2), beside (2, 4)); the launchers spawn their own.

Tolerances, each the reference's own for the same path:
- qwen1.5-4b smoke at (2, 2), f32: prefill logits, 4 decode steps, loss
  and gradients within 1e-5 of the max against the unmeshed JAX;
- ``SUITE`` case 1 (glm4-9b smoke, f32, d_model 64, 2 layers, mesh
  (2, 4), B 4, S 32, AdamW lr 1e-2, 3 steps): the losses against the
  unmeshed jitted JAX step at rtol 5e-4, atol 5e-4 (``np.allclose``, the
  reference's bound); the first step's loss and gradients within 1e-5 of
  the port's one-rank step;
- elastic restore (2, 2) -> (1, 2) and (1, 1): bit for bit;
- ``compressed_psum_mean`` over 4 ranks: the mean of the reference's own
  quantize/dequantize of each rank's values (1e-6 of the max), within
  max|x| / 100 of the exact mean (``SUITE`` case 3);
- the launchers in f32 (their configs patched to f32 inside the ranks): a
  2x2 run resumed at 1x2 against an uninterrupted 1x1 run, losses rtol
  1e-5 (measured 6.6e-7);
  1x2 serving emits the greedy tokens of 1x1; a rolled-back run's losses
  are a clean run's bit for bit;
- the rest (accumulation, llama-vision at (2, 4), the moe rank with no
  tokens) against the port's one rank at 1e-5, AdamW's zero-initialised
  leaves at 1e-2 (``test_torch_lm_train.py``'s convention).
"""
import concurrent.futures
import dataclasses
import os
import signal
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from _torch_cores import share_cores  # noqa: E402

share_cores(torch)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_lm_mesh_worker import (  # noqa: E402
    f32_launchers, family_case, launcher_serve, one_rank, run_cases,
)
from conftest import SRC  # noqa: E402
from repro.models import get_config as jget  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.nn import module as jmodule  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro.runtime import sharding as jshd  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch import nn as tnn  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import get_config, lm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.optim import compression as tcomp  # noqa: E402
from repro_torch.optim.adamw import global_norm  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402
from repro_torch.runtime import steps  # noqa: E402
from repro_torch.runtime.collectives import spawn_ranks  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map, tree_paths  # noqa: E402

RTOL = 1e-5
SUITE_RTOL = 5e-4
TRAIN = ["--arch", "glm4-9b", "--smoke", "--batch", "4", "--seq", "32",
         "--lr", "1e-2", "--warmup", "5", "--device", "cpu",
         "--log-every", "1"]
SERVE = ["--arch", "qwen1.5-4b", "--smoke", "--slots", "4", "--requests",
         "6", "--prompt-len", "4", "--max-new", "6", "--device", "cpu"]
CPU = "cpu"
JOIN_TIMEOUT_S = 240.0
DEC_STEPS, CACHE_LEN = 4, 8


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(arch, **kw):
    return (dataclasses.replace(jget(arch, smoke=True), dtype=jnp.float32,
                                **kw),
            dataclasses.replace(get_config(arch, smoke=True),
                                dtype=torch.float32, **kw))


def _batch(vocab, B, S, seed, pad=True):
    r = np.random.default_rng(seed)
    b = {"tokens": r.integers(0, vocab, (B, S)).astype(np.int32),
         "labels": r.integers(0, vocab, (B, S)).astype(np.int32)}
    if pad:
        b["labels"][0, :3] = -1
    return b


# ------------------------------------------------------------ references
def _qwen():
    """qwen1.5-4b smoke: inputs and the unmeshed JAX results."""
    jc, tc = _cfgs("qwen1.5-4b")
    jp = jlm.init(jc, jax.random.PRNGKey(0))
    params = _np(jp)
    batch = _batch(jc.vocab, 4, 16, seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, grads = jax.value_and_grad(lambda p: jlm.lm_loss(p, jb, jc))(jp)
    toks = np.random.default_rng(2).integers(0, jc.vocab, (2, DEC_STEPS))
    cache = jlm.init_cache(jc, 2, CACHE_LEN)
    step = jax.jit(lambda p, c, t, pos: jlm.decode_step(p, c, t, pos, jc))
    dec = []
    for t in range(DEC_STEPS):
        lg, cache = step(jp, cache, jnp.asarray(toks[:, t:t + 1], jnp.int32),
                         jnp.int32(t))
        dec.append(np.asarray(lg[:, 0]))
    want = {"logits": np.asarray(jlm.logits_fn(jp, jb["tokens"], jc)),
            "loss": float(loss), "grads": jax.tree.leaves(grads),
            "decode": np.stack(dec, 1)}
    case = {"cfg": tc, "params": params, "batch": batch,
            "decode": {"cfg": tc, "tokens": toks, "cache_len": CACHE_LEN}}
    return case, want


def _suite():
    """SUITE case 1: glm4-9b smoke, f32, d_model 64, 2 layers, B 4, S 32,
    AdamW lr 1e-2; the unmeshed jitted JAX step's 3 losses."""
    jc, tc = _cfgs("glm4-9b", d_model=64, n_layers=2)
    jp = jlm.init(jc, jax.random.PRNGKey(0))
    r = np.random.default_rng(0)
    toks = r.integers(0, jc.vocab, (4, 32)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}
    opt = JAdamW(lr=1e-2)
    state = jsteps.init_train_state(jc, jax.random.PRNGKey(0), opt)
    state["params"] = jp
    fn = jax.jit(jsteps.make_train_step(jc, opt))
    losses = []
    for _ in range(3):
        state, m = fn(state, batch)
        losses.append(float(m["loss"]))
    case = {"task": "suite_steps", "cfg": tc, "params": _np(jp),
            "batch": batch, "lr": 1e-2, "steps": 3}
    return case, losses


def _empty_experts_case():
    """mixtral smoke at top-1 with a router that sends every token to
    experts 0 or 1: at (1, 2) the second rank's experts get none."""
    _, tc = _cfgs("mixtral-8x7b", top_k=1)
    params = lm.init(tc, torch.Generator().manual_seed(3))
    router = params["blocks"]["moe"]["router"]
    v = torch.randn(router.shape[1], generator=torch.Generator()
                    .manual_seed(4))
    router.zero_()
    router[:, :, 0] = v
    router[:, :, 1] = -v
    return {"cfg": tc, "params": tree_map(lambda t: t.numpy(), params),
            "batch": _batch(tc.vocab, 2, 8, seed=5)}


NORM_SHAPES = {"embed": ((64,), ("embed",)), "heads": ((8, 6), ("heads",
                                                                None)),
               "both": ((6, 64, 8), (None, "embed", "mlp")),
               "none": ((3, 5), (None, None)), "step": ((), ())}


def _norm_tree():
    """Leaves sharded over both axes, one, or none (the step scalar)."""
    r = np.random.default_rng(6)
    return {k: r.standard_normal(s).astype(np.float32)
            for k, (s, _) in NORM_SHAPES.items()}


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    qwen, want_qwen = _qwen()
    suite, want_suite = _suite()
    d = str(tmp_path_factory.mktemp("elastic"))
    ck = str(tmp_path_factory.mktemp("ck"))
    _, tc = _cfgs("qwen1.5-4b")
    tree = _norm_tree()
    stand = _StandIn(data=2, model=2)
    places = {k: shd.resolve_pspec(s, ax, stand)
              for k, (s, ax) in NORM_SHAPES.items()}
    x = np.random.default_rng(7).standard_normal((4, 3000)).astype(
        np.float32)
    cases = {
        (2, 2): {"qwen": qwen,
                 "accum": {"cfg": tc, "params": qwen["params"],
                           "batch": qwen["batch"],
                           "step": {"batches": [qwen["batch"]], "accum": 2}},
                 "save": {"task": "save_state", "cfg": tc,
                          "params": qwen["params"], "batch": qwen["batch"],
                          "dir": d},
                 "psum": {"task": "compressed_mean", "x": x},
                 "norm": {"task": "sharded_norm", "tree": tree,
                          "places": places},
                 "train": {"task": "launcher_train", "argv": TRAIN + [
                     "--mesh", "2x2", "--steps", "3", "--ckpt-dir", ck,
                     "--ckpt-every", "3"]}},
        (1, 2): {"restore": {"task": "restore_state", "cfg": tc, "dir": d},
                 "rollback": {"task": "launcher_rollback", "poison_call": 7,
                              "argv": TRAIN + ["--mesh", "1x2", "--steps",
                                               "8", "--log-every", "100"],
                              "dir": str(tmp_path_factory.mktemp("rb"))},
                 "empty": _empty_experts_case(),
                 "train": {"task": "launcher_train", "argv": TRAIN + [
                     "--mesh", "1x2", "--steps", "6", "--ckpt-dir", ck,
                     "--ckpt-every", "3"]},
                 "serve": {"task": "launcher_serve",
                           "argv": SERVE + ["--mesh", "1x2"]}},
        (2, 4): {"suite": suite,
                 "vlm": family_case("llama-3.2-vision-11b", 9, 2, 8, 2,
                                    DEC_STEPS, CACHE_LEN)},
    }
    want = {"qwen": want_qwen, "suite": want_suite, "x": x, "tree": tree,
            "dir": d, "qwen_cfg": tc}
    return cases, want


class _StandIn:
    """A mesh seen through its shape (the rules read nothing else)."""

    def __init__(self, **shape):
        self.shape = shape


@pytest.fixture(scope="module")
def ranks(refs):
    """Rank 0's results: (2, 2) then (1, 2) (which restores what (2, 2)
    saved), beside (2, 4)."""
    cases, _ = refs

    def run(mesh):
        return spawn_ranks(run_cases, mesh[0] * mesh[1],
                           (mesh[0], mesh[1], cases[mesh]),
                           timeout=JOIN_TIMEOUT_S)[0]

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        wide = pool.submit(run, (2, 4))
        out = {(2, 2): run((2, 2))}
        out[(1, 2)] = run((1, 2))
        out[(2, 4)] = wide.result()
    return out


# ------------------------------------------------------------ mesh cases
def test_qwen_at_2x2_matches_unmeshed_jax(ranks, refs):
    got, want = ranks[(2, 2)]["qwen"], refs[1]["qwen"]
    assert rel(got["logits"], want["logits"]) <= RTOL
    assert rel(got["decode"], want["decode"]) <= RTOL
    assert abs(got["loss"] - want["loss"]) <= RTOL * abs(want["loss"])
    for path, g, w in zip(tree_paths(got["grads"]), tree_leaves(
            got["grads"]), want["grads"]):
        assert rel(g, w) <= RTOL, path


def test_accumulated_step_at_2x2_takes_the_unsharded_micro_batches(
        ranks, refs):
    """At accum 2 each data rank steps on its block of each of the
    global batch's micro-batches (the unsharded run's, padded labels and
    all): the one-rank accum-2 step's loss, grad norm and params."""
    from _torch_lm_mesh_worker import launcher_optimizer

    case = refs[0][(2, 2)]["accum"]
    got = ranks[(2, 2)]["accum"]
    params = tree_map(lambda a: torch.from_numpy(np.array(a)),
                      case["params"])
    opt = launcher_optimizer()
    moments = opt.init(params)
    state = {"params": params, "mu": moments.mu, "nu": moments.nu,
             "step": torch.zeros((), dtype=torch.int32)}
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    state, m = steps.make_train_step(case["cfg"], opt, accum_steps=2)(
        state, batch)
    for k in ("loss", "grad_norm"):
        want = float(m[k])
        assert abs(got["step_metrics"][0][k] - want) <= RTOL * want, k
    inits = [s.init for s in tree_leaves(lm.param_specs(case["cfg"]))]
    for init, path, g, w in zip(inits, tree_paths(state["params"]),
                                tree_leaves(got["step_params"]),
                                tree_leaves(state["params"])):
        assert rel(g, w.numpy()) <= (1e-2 if init == "zeros" else RTOL), path


def test_suite_case_glm4_at_2x4_tracks_the_unmeshed_step(ranks, refs):
    """The reference's SUITE case 1 (its ``head`` fallback: 2 KV heads on
    4 model ranks): three steps against ``jax.jit(make_train_step)``, and
    the first step's loss and gradients against the port's one rank."""
    got = ranks[(2, 4)]["suite"]
    assert np.allclose(got["losses"], refs[1]["suite"], rtol=SUITE_RTOL,
                       atol=SUITE_RTOL), (got["losses"], refs[1]["suite"])
    case = refs[0][(2, 4)]["suite"]
    params = tree_map(lambda a: torch.from_numpy(np.array(a)),
                      case["params"])
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    loss, grads = steps.loss_and_grads(
        lambda p, b: lm.lm_loss(p, b, case["cfg"]), params, batch)
    assert abs(got["loss0"] - float(loss)) <= RTOL * abs(float(loss))
    for path, g, w in zip(tree_paths(grads), tree_leaves(got["grads0"]),
                          tree_leaves(grads)):
        assert rel(g, w.numpy()) <= RTOL, path


def test_vlm_at_2x4_takes_the_head_fallback_like_one_rank(ranks, refs):
    """llama-3.2-vision smoke at (2, 4): 2 KV heads on 4 model ranks, so
    its self and cross caches split head_dim (the ``head`` fallback);
    prefill, 4 decode steps, the cache, loss, grads and one step against
    the port's one rank."""
    case = refs[0][(2, 4)]["vlm"]
    got, want = ranks[(2, 4)]["vlm"], one_rank(case)
    assert rel(got["logits"], want["logits"]) <= RTOL
    assert rel(got["decode"], want["decode"]) <= RTOL
    for k in want["cache"]:
        assert rel(got["cache"][k], want["cache"][k]) <= RTOL, k
    assert abs(got["loss"] - want["loss"]) <= RTOL * abs(want["loss"])
    for path, g, w in zip(tree_paths(want["grads"]),
                          tree_leaves(got["grads"]),
                          tree_leaves(want["grads"])):
        assert rel(g, w) <= RTOL, path
    for k in ("loss", "grad_norm"):
        w = want["step_metrics"][0][k]
        assert abs(got["step_metrics"][0][k] - w) <= RTOL * w, k
    inits = [s.init for s in tree_leaves(lm.param_specs(case["cfg"]))]
    for init, path, g, w in zip(inits, tree_paths(want["step_params"]),
                                tree_leaves(got["step_params"]),
                                tree_leaves(want["step_params"])):
        assert rel(g, w) <= (1e-2 if init == "zeros" else RTOL), path


def test_elastic_restore_is_bitwise(ranks, refs):
    """A state saved at (2, 2) restores at (1, 2) and on one rank bit for
    bit, each (1, 2) leaf its resolve_pspec block."""
    saved = ranks[(2, 2)]["save"]
    got = ranks[(1, 2)]["restore"]
    for a, b in zip(tree_leaves(got["state"]), tree_leaves(saved)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    sspecs = steps.train_state_specs(refs[1]["qwen_cfg"])
    mesh = _StandIn(data=1, model=2)
    want_shapes = [tuple(t.shape) for t in tree_leaves(
        shd.sharded_zeros(sspecs, mesh, device="meta"))]
    assert got["shapes"] == want_shapes
    one = ckpt.restore(refs[1]["dir"], 1, shd.abstract_like(sspecs),
                       device=CPU)
    for a, b in zip(tree_leaves(one), tree_leaves(saved)):
        assert np.array_equal(a.numpy(), b)


def test_compressed_psum_mean_over_four_ranks(ranks, refs):
    got = ranks[(2, 2)]["psum"]
    x = refs[1]["x"]
    deq = []
    for row in x:
        q, s, n = jcomp.quantize_int8(jnp.asarray(row))
        deq.append(np.asarray(jcomp.dequantize_int8(q, s, n, row.shape,
                                                    jnp.float32)))
    assert got["same"]
    assert rel(got["mean"], np.sum(deq, 0) / 4) <= 1e-6
    assert np.max(np.abs(got["mean"] - x.mean(0))) < np.abs(x).max() / 100


def test_global_norm_counts_replicated_leaves_once(ranks, refs):
    tree = tree_map(torch.from_numpy, refs[1]["tree"])
    want = float(global_norm(tree))
    assert abs(ranks[(2, 2)]["norm"] - want) <= 1e-6 * want


def test_moe_rank_whose_experts_get_no_tokens(ranks, refs):
    """Every token routes to experts 0 or 1 (rank 0's at (1, 2)): the rank
    with none runs its empty dispatch without stalling the other, and the
    results are the one rank's."""
    case = refs[0][(1, 2)]["empty"]
    got = ranks[(1, 2)]["empty"]
    cfg = case["cfg"]
    params = tree_map(torch.from_numpy, case["params"])
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    x = lm.embed_tokens(params["embed"], batch["tokens"], cfg)
    _, _, idx = tmoe.route(lm._layer(params["blocks"], 0)["moe"], x, cfg)
    assert int(idx.max()) <= 1
    with torch.no_grad():
        logits = lm.logits_fn(params, batch["tokens"], cfg)
    assert rel(got["logits"], logits.numpy()) <= RTOL
    loss, grads = steps.loss_and_grads(lambda p, b: lm.lm_loss(p, b, cfg),
                                       params, batch)
    assert abs(got["loss"] - float(loss)) <= RTOL * abs(float(loss))
    for path, g, w in zip(tree_paths(grads), tree_leaves(got["grads"]),
                          tree_leaves(grads)):
        assert rel(g, w.numpy()) <= RTOL, path


# --------------------------------------------------------------- launchers


@pytest.fixture
def one_thread_ranks(monkeypatch):
    """Spawned ranks inherit one torch thread each (four ranks share the
    test's cores)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_train_launcher_2x2_resumes_at_1x2_like_one_uninterrupted_run(
        ranks):
    """f32: 3 steps at 2x2 saved at step 3, resumed at 1x2 to step 6 (its
    3 steps are the resumed ones), against 6 steps at 1x1."""
    first = ranks[(2, 2)]["train"]
    rest = ranks[(1, 2)]["train"]
    with f32_launchers():
        whole = ttrain.main(TRAIN + ["--steps", "6"])
    assert len(first) == len(rest) == 3
    np.testing.assert_allclose(first + rest, whole, rtol=RTOL)
    assert not torch.distributed.is_initialized()


def test_train_launcher_rolls_back_a_non_finite_step_on_the_mesh(ranks):
    """At 1x2 a NaN loss at step 6 (every rank sees the same global loss)
    rolls every rank back to the step-5 checkpoint and replays the
    stream: the run's losses are a clean run's, bit for bit."""
    got = ranks[(1, 2)]["rollback"]
    assert len(got["clean"]) == 8 and got["rolled"] == got["clean"]


def test_train_launcher_sigterm_under_a_mesh(tmp_path, capfd,
                                            one_thread_ranks):
    """SIGTERM to a launcher that spawned 2 ranks: it forwards the signal,
    the ranks agree on the step to stop at, save through rank 0 and exit
    143, and the launcher exits 143; the run resumes at another mesh."""
    ck = tmp_path / "ck"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train"] + TRAIN
        + ["--mesh", "2x1", "--steps", "1000", "--ckpt-dir", str(ck),
           "--ckpt-every", "1000"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seen = ""
    try:
        for line in proc.stdout:
            seen += line
            if "step     4" in line:
                proc.send_signal(signal.SIGTERM)
                break
        rc = proc.wait(timeout=120)
        seen += proc.stdout.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == 143, f"rc={rc}\n{seen[-3000:]}"
    assert "mesh of 2 gloo ranks on the CPU" in seen
    assert "preempted; checkpoint committed" in seen
    last = ckpt.latest_step(ck)
    assert last is not None and last >= 5
    capfd.readouterr()
    losses = ttrain.main(TRAIN + ["--mesh", "1x2", "--steps", str(last + 2),
                                  "--ckpt-dir", str(ck)])
    assert f"resuming from step {last}" in capfd.readouterr().out
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_serve_launcher_1x2_emits_the_tokens_of_1x1(ranks):
    """f32: the greedy tokens of every request at 1x2 are those of 1x1."""
    got = ranks[(1, 2)]["serve"]
    want = launcher_serve(None, {"argv": SERVE + ["--mesh", "1x1"]})
    assert got["served"] == want["served"] == 36
    assert got["outputs"] == want["outputs"]


# -------------------------------------------------------------- in-process
def test_lm_spec_helpers_equal_reference():
    from jax.sharding import Mesh

    devs = np.array(jax.devices()[:1] * 8).reshape(2, 4)
    jmesh = Mesh(devs, ("data", "model"))
    for arch in ("glm4-9b", "mixtral-8x7b", "falcon-mamba-7b"):
        jc, tc = _cfgs(arch)
        jspecs, tspecs = jlm.param_specs(jc), lm.param_specs(tc)
        want = [tuple(jshd.spec_sharding(s, jmesh).spec) for s in
                jax.tree.leaves(jspecs, is_leaf=jmodule.is_spec)]
        assert [shd.spec_sharding(s, jmesh) for s in tree_leaves(tspecs)
                ] == want
        assert [tnn.logical_to_pspec(s.logical_axes, shd.DEFAULT_RULES)
                for s in tree_leaves(tspecs)] == [
            tuple(jmodule.logical_to_pspec(s.logical_axes,
                                           jshd.DEFAULT_RULES))
            for s in jax.tree.leaves(jspecs, is_leaf=jmodule.is_spec)]
        assert tnn.param_bytes(tspecs) == jmodule.param_bytes(jspecs)
        want_p = jax.tree.leaves(
            jmodule.specs_to_pspecs(jspecs, jshd.DEFAULT_RULES),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        got_p = []
        _collect(tnn.specs_to_pspecs(tspecs, shd.DEFAULT_RULES), got_p)
        assert got_p == [tuple(p) for p in want_p]
        assert [tuple(t.shape) for t in tree_leaves(
            tnn.abstract_params(tspecs))] == [
            s.shape for s in jax.tree.leaves(jspecs,
                                             is_leaf=jmodule.is_spec)]
    assert shd.scalar_sharding(jmesh) == tuple(
        jshd.scalar_sharding(jmesh).spec)
    for b in (8, 2, 1):
        assert shd.batch_sharding(jmesh, 2, batch_size=b) == tuple(
            jshd.batch_sharding(jmesh, 2, batch_size=b).spec) + (None,) * (
            2 - len(jshd.batch_sharding(jmesh, 2, batch_size=b).spec))


def _collect(tree, out: list) -> None:
    """The spec tuples of a tree of them, in key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            _collect(tree[k], out)
    else:
        out.append(tree)


def test_constrain_is_a_no_op_without_a_mesh_context():
    x = torch.randn(2, 8, 4)
    assert shd.constrain(x, ("batch", "seq", None)) is x
    assert shd.active() is None
    with shd.activation_sharding(None):
        assert shd.active() is None
    with shd.activation_sharding(_StandIn(data=1, model=1)):
        assert shd.active() is None


def test_int8_compression_equals_reference():
    x = np.random.default_rng(8).standard_normal((3, 1500)).astype(
        np.float32) * 3.0
    q, s, n = tcomp.quantize_int8(torch.from_numpy(x))
    jq, js, jn = jcomp.quantize_int8(jnp.asarray(x))
    assert n == jn and np.array_equal(q.numpy(), np.asarray(jq))
    assert np.array_equal(s.numpy(), np.asarray(js))
    assert np.array_equal(
        tcomp.dequantize_int8(q, s, n, x.shape, torch.float32).numpy(),
        np.asarray(jcomp.dequantize_int8(jq, js, jn, x.shape, jnp.float32)))
    err = np.random.default_rng(9).standard_normal(x.shape).astype(
        np.float32) * 0.01
    got = tcomp.ef_quantize(torch.from_numpy(x), torch.from_numpy(err))
    want = jcomp.ef_quantize(jnp.asarray(x), jnp.asarray(err))
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert rel(got[3].numpy(), np.asarray(want[3])) <= 1e-6
    assert tcomp.compression_ratio(torch.from_numpy(x)) == pytest.approx(
        jcomp.compression_ratio(jnp.asarray(x)))


class _FakeMesh:
    """A mesh seen from one coordinate, whose groups are never used (the
    refusals come first; cutting blocks needs none)."""

    mesh_dim_names = ("data", "model")

    def __init__(self, data, model, coord=(0, 0)):
        self.shape = (data, model)
        self.coord = list(coord)

    def get_coordinate(self):
        return self.coord

    def get_group(self, name):
        return object()


@pytest.mark.parametrize("coord", [(0, 0), (1, 1)])
def test_blocks_drawn_and_converted_leaf_by_leaf_equal_the_cut_tree(coord):
    """``lm.init(..., mesh=)`` draws each leaf whole and keeps the rank's
    block: bit for bit the blocks of the whole tree; so do
    ``lm_params_from_jax`` and ``lm_train_state_from_jax`` with ``mesh=``."""
    from repro_torch.convert import lm_params_from_jax, lm_train_state_from_jax

    mesh = _FakeMesh(2, 2, coord)
    _, tc = _cfgs("mixtral-8x7b")
    place = shd.tree_shardings(lm.param_specs(tc), mesh)
    got = lm.init(tc, torch.Generator().manual_seed(5), mesh=mesh)
    whole = lm.init(tc, torch.Generator().manual_seed(5))
    want = shd.local_tree(whole, place, mesh)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                 tree_leaves(want)))
    arrays = tree_map(lambda t: t.numpy(), whole)
    conv = lm_params_from_jax(arrays, device=CPU, mesh=mesh, pspecs=place)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(conv),
                                                 tree_leaves(want)))
    s_place = shd.tree_shardings(steps.train_state_specs(tc), mesh)
    state = lm_train_state_from_jax(
        {"params": arrays, "mu": arrays, "nu": arrays, "step": 3},
        device=CPU, mesh=mesh, pspecs=s_place)
    assert [tuple(t.shape) for t in tree_leaves(state)] == [
        tuple(t.shape) for t in tree_leaves(
            shd.sharded_zeros(steps.train_state_specs(tc), mesh,
                              device="meta"))]
    assert int(state["step"]) == 3


def test_mesh_refusals():
    _, tc = _cfgs("recurrentgemma-9b")  # lru 64 splits over 8, 4 heads not
    # no refusal: every model rank runs the whole block (held against one
    # rank by test_torch_lm_whole_heads.py)
    assert shd.MeshContext(_FakeMesh(1, 8)).whole(tc.n_heads)
    assert not shd.MeshContext(_FakeMesh(1, 4)).whole(tc.n_heads)
    ctx = shd.MeshContext(_FakeMesh(2, 1))
    # a 16-token group over 2 ranks: no refusal, the block runs on the
    # batch gathered over data (held against one rank by
    # test_torch_lm_replicate.py)
    assert tmoe._group_size(ctx, 1, 8, 16) == (16, True)
    assert tmoe._group_size(ctx, 2, 8, 8) == (8, False)
    # no refusal: a dim that does not divide is whole on every model rank
    assert shd.MeshContext(_FakeMesh(1, 3)).part(4) == (0, 4)
    with pytest.raises(ValueError, match="DATAxMODEL"):
        tserve.parse_mesh("2by2")
