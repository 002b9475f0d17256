"""The port's LM training launcher (``repro_torch.launch.train``) on the CPU.

At ``glm4-9b --smoke --device cpu``, the configuration the reference's
own ``tests/test_launchers.py`` trains: a falling loss, a bitwise resume,
SIGTERM -> rc 143 -> resume, the non-finite guardrail (rollback and
replay, abort without a checkpoint, the rollback bound), a train state
that the JAX package saved resumed by the port with the reference's own
next losses (f32 on both sides, within 1e-5), the refusals, and the
examples' train -> resume -> serve flow.  The launcher runs in-process
(``main(argv)``) except for the SIGTERM case, which needs a process to
signal.
"""
import dataclasses
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from _torch_cores import share_cores  # noqa: E402

share_cores(torch)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from conftest import SRC  # noqa: E402
from repro import checkpoint as jckpt  # noqa: E402
from repro.data.synthetic import token_batch_iterator  # noqa: E402
from repro.models import get_config as jget  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import warmup_cosine as jwarmup  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import get_config as tget  # noqa: E402

BASE = ["--arch", "glm4-9b", "--smoke", "--batch", "4", "--seq", "64",
        "--lr", "1e-2", "--warmup", "5", "--log-every", "5",
        "--device", "cpu"]
STEP_LINE_TIMEOUT_S = 120.0  # a started subprocess printing step 10


def _train(args, out=None):
    """``main`` in-process; returns (losses, metrics-out JSON or None)."""
    extra = ["--metrics-out", str(out)] if out else []
    losses = ttrain.main(BASE + args + extra)
    return losses, (json.loads(out.read_text()) if out else None)


def test_loss_decreases_over_40_steps(tmp_path):
    losses, m = _train(["--steps", "40"], tmp_path / "m.json")
    assert m["losses"] == losses and len(losses) == 40
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.3
    assert len(m["step_seconds"]) == 40 and m["stragglers"] == [
        s for s in m["stragglers"] if s["step"] < 40]


def test_resume_is_bitwise_ten_straight_steps(tmp_path, capsys):
    """Train 10 straight vs train 5 + resume 5: the same losses, bit for
    bit (the reference holds rtol 1e-5, then 1e-3 after the resume)."""
    straight, _ = _train(["--steps", "10"])
    ck = tmp_path / "ck"
    first, _ = _train(["--steps", "5", "--ckpt-dir", str(ck),
                       "--ckpt-every", "5"])
    capsys.readouterr()
    second, _ = _train(["--steps", "10", "--ckpt-dir", str(ck),
                        "--ckpt-every", "100"])
    assert "[train] resuming from step 5" in capsys.readouterr().out
    assert first + second == straight
    assert ckpt.latest_step(ck) == 10


def _reader(stream, q):
    for line in iter(stream.readline, ""):
        q.put(line)
    q.put(None)


def test_sigterm_checkpoints_exits_143_and_resumes(tmp_path, capsys):
    ck = tmp_path / "ck"
    env = dict(os.environ, PYTHONPATH=str(SRC))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train"] + BASE
        + ["--steps", "1000", "--ckpt-dir", str(ck), "--ckpt-every", "3"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    q: queue.Queue = queue.Queue()
    threading.Thread(target=_reader, args=(proc.stdout, q),
                     daemon=True).start()
    seen, deadline = "", time.monotonic() + STEP_LINE_TIMEOUT_S
    try:
        while "step    10" not in seen:
            line = q.get(timeout=max(deadline - time.monotonic(), 0.01))
            assert line is not None, f"exited early:\n{seen[-2000:]}"
            seen += line
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == 143, f"rc={rc}\n{seen[-2000:]}"
    last = ckpt.latest_step(ck)
    assert last is not None and last >= 3
    capsys.readouterr()
    losses, _ = _train(["--steps", str(last + 3), "--ckpt-dir", str(ck),
                        "--ckpt-every", "100"])
    assert f"resuming from step {last}" in capsys.readouterr().out
    assert len(losses) == 3 and all(np.isfinite(losses))


def _poisoning(monkeypatch, calls):
    """Make the launcher's step poison the state (a NaN final norm scale,
    so the loss is NaN and the params garbage) on the given call numbers."""
    real = ttrain.steps_mod.compile_train_step
    n = {"calls": 0}

    def compile_train_step(*a, **kw):
        fn, s_place, b_place, sspecs = real(*a, **kw)

        def step(state, batch):
            n["calls"] += 1
            if n["calls"] in calls:
                state["params"]["final_norm"]["scale"].fill_(float("nan"))
            return fn(state, batch)

        return step, s_place, b_place, sspecs

    monkeypatch.setattr(ttrain.steps_mod, "compile_train_step",
                        compile_train_step)


def test_non_finite_loss_rolls_back_and_replays_the_stream(
        tmp_path, monkeypatch, capsys):
    clean, _ = _train(["--steps", "10"])
    _poisoning(monkeypatch, {8})  # step 7; the last checkpoint is step 5
    losses, _ = _train(["--steps", "10", "--ckpt-dir", str(tmp_path / "ck"),
                        "--ckpt-every", "5"])
    out = capsys.readouterr().out
    assert "non-finite loss at step 7: rolling back to step 5 (1/2)" in out
    assert losses == clean  # the replayed steps are the clean run's


@pytest.mark.parametrize("calls,ckpt_every,message", [
    ({3}, "5", "non-finite loss at step 2"),  # before any checkpoint
    (set(range(8, 100)), "5", "non-finite loss at step 5"),  # every replay
])
def test_non_finite_loss_aborts_without_a_checkpoint_to_return_to(
        tmp_path, monkeypatch, capsys, calls, ckpt_every, message):
    ck = tmp_path / "ck"
    _poisoning(monkeypatch, calls)
    with pytest.raises(RuntimeError, match=message):
        _train(["--steps", "10", "--ckpt-dir", str(ck), "--ckpt-every",
                ckpt_every])
    out = capsys.readouterr().out
    assert "no rollback available; aborting" in out
    if min(calls) <= 5:
        assert ckpt.latest_step(ck) is None
    else:  # two rollbacks (--max-rollbacks 2), then the abort
        assert out.count("rolling back to step 5") == 2
        assert ckpt.latest_step(ck) == 5


def test_resumes_a_state_the_reference_saved(tmp_path, monkeypatch, capsys):
    """Two reference steps saved by ``repro.checkpoint.save``; the port's
    launcher resumes there and its losses are the reference's own next
    three within 1e-5 (both sides in f32)."""
    batch, seq, lr, warmup, steps = 4, 16, 3e-3, 2, 5
    jc = dataclasses.replace(jget("glm4-9b", smoke=True), dtype=jnp.float32)
    tc = dataclasses.replace(tget("glm4-9b", smoke=True),
                             dtype=torch.float32)
    monkeypatch.setattr(ttrain, "get_config", lambda arch, smoke: tc)
    opt = JAdamW(lr=jwarmup(lr, warmup, steps), weight_decay=0.01,
                 grad_clip_norm=1.0)
    state = jsteps.init_train_state(jc, jax.random.PRNGKey(3), opt)
    fn = jax.jit(jsteps.make_train_step(jc, opt))
    it = token_batch_iterator(batch, seq, jc.vocab, seed=0)
    ref = []
    for i in range(steps):
        if i == 2:
            jckpt.save(tmp_path / "ck", 2, state)
        state, m = fn(state, jax.tree.map(jnp.asarray, next(it)))
        ref.append(float(m["loss"]))
    capsys.readouterr()
    losses = ttrain.main([
        "--arch", "glm4-9b", "--smoke", "--batch", str(batch), "--seq",
        str(seq), "--lr", str(lr), "--warmup", str(warmup), "--steps",
        str(steps), "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every",
        "100", "--device", "cpu"])
    assert "resuming from step 2" in capsys.readouterr().out
    np.testing.assert_allclose(losses, ref[2:], rtol=1e-5)


def test_mesh_beyond_1x1_is_refused():
    """Meshes beyond 1x1 train (``test_torch_lm_mesh_ref.py``); a
    malformed ``--mesh`` is refused before a step is taken.  A model degree
    that splits neither the heads nor the MLP's columns nor the vocabulary
    runs them whole on every rank (``test_torch_lm_replicate.py``): the
    first step at 1x3 takes 1x1's loss."""
    with pytest.raises(ValueError, match="DATAxMODEL"):
        ttrain.main(BASE + ["--mesh", "2by1"])
    one = ttrain.main(BASE + ["--steps", "1"])
    three = ttrain.main(BASE + ["--mesh", "1x3", "--steps", "1"])
    np.testing.assert_allclose(three, one, rtol=1e-5)


def test_the_default_device_is_the_card():
    args = ["--arch", "glm4-9b", "--smoke", "--steps", "1", "--batch", "2",
            "--seq", "8"]
    if torch.cuda.is_available():
        assert len(ttrain.main(args)) == 1  # runs on the card
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(args)


def test_train_resume_and_serve_flow(tmp_path, capsys):
    """examples/lm_train_and_serve.py with the port's launchers, shortened:
    train with checkpoints, resume for more steps, serve."""
    ck = str(tmp_path / "ck")
    flags = ["--arch", "granite-8b", "--smoke", "--batch", "4", "--seq",
             "32", "--lr", "3e-3", "--warmup", "4", "--ckpt-dir", ck,
             "--ckpt-every", "10", "--log-every", "5", "--device", "cpu"]
    first = ttrain.main(flags + ["--steps", "20"])
    capsys.readouterr()
    second = ttrain.main(flags + ["--steps", "25"])
    assert "resuming from step 20" in capsys.readouterr().out
    assert len(first) == 20 and len(second) == 5
    assert np.mean(second) < np.mean(first[:5])
    served = tserve.main(["--arch", "granite-8b", "--smoke", "--slots", "4",
                          "--requests", "4", "--prompt-len", "4",
                          "--max-new", "4", "--cache-len", "32",
                          "--device", "cpu"])
    assert served == 16 and "4/4 requests" in capsys.readouterr().out


def test_accumulation_splits_the_batch():
    one, _ = _train(["--steps", "3"])
    two, _ = _train(["--steps", "3", "--accum", "2"])
    # equal counts of valid labels a micro-batch: the mean of the two
    # micro-batch means is the batch's mean
    assert abs(one[0] - two[0]) <= 1e-5 * one[0] and np.isfinite(two).all()
    with pytest.raises(ValueError, match="micro-batches"):
        _train(["--steps", "1", "--accum", "3"])


# ------------------------------------------------ the moe, hybrid and vlm
FAMILY_ARCHS = ("mixtral-8x7b", "recurrentgemma-9b", "llama-3.2-vision-11b")


def _family_args(arch, steps, *extra):
    # warmup 5: the first 5 steps' lr does not depend on --steps, so a
    # 5-step run is the first half of a 10-step one
    return ["--arch", arch, "--smoke", "--batch", "4", "--seq", "32",
            "--lr", "1e-2", "--warmup", "5", "--log-every", "5",
            "--steps", str(steps), "--device", "cpu", *extra]


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_smoke_configs_train_and_resume_bitwise(arch, tmp_path,
                                                       capsys):
    """10 steps: a falling loss, and 5 + resume 5 the same losses bit for
    bit."""
    straight = ttrain.main(_family_args(arch, 10))
    assert np.mean(straight[-3:]) < np.mean(straight[:3])
    ck = str(tmp_path / "ck")
    first = ttrain.main(_family_args(arch, 5, "--ckpt-dir", ck,
                                     "--ckpt-every", "5"))
    capsys.readouterr()
    second = ttrain.main(_family_args(arch, 10, "--ckpt-dir", ck,
                                      "--ckpt-every", "100"))
    assert "[train] resuming from step 5" in capsys.readouterr().out
    assert first + second == straight


def _recording(monkeypatch):
    """The launcher's step wrapped to keep each batch it is given."""
    real = ttrain.steps_mod.compile_train_step
    seen = []

    def compile_train_step(*a, **kw):
        fn, s_place, b_place, sspecs = real(*a, **kw)

        def step(state, batch):
            seen.append(batch)
            return fn(state, batch)

        return step, s_place, b_place, sspecs

    monkeypatch.setattr(ttrain.steps_mod, "compile_train_step",
                        compile_train_step)
    return seen


def test_mixtral_launcher_loss_carries_the_aux_term(monkeypatch):
    """The first step's loss is lm_loss of the seeded init on the first
    batch: the cross-entropy plus 0.01 times the layers' summed aux."""
    from repro_torch.models import lm as tlm
    from repro_torch.runtime import steps as tsteps
    from repro_torch.tree import tree_map

    seen = _recording(monkeypatch)
    losses = ttrain.main(_family_args("mixtral-8x7b", 1, "--accum", "2"))
    cfg = tget("mixtral-8x7b", smoke=True)
    state = tsteps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                    ttrain.AdamW(lr=1e-2))
    batch = tree_map(lambda t: t.clone(), seen[0])
    with torch.no_grad():
        halves = [{k: v.reshape(2, -1, *v.shape[1:])[i]
                   for k, v in batch.items()} for i in range(2)]
        parts = [tlm.forward(state["params"], h["tokens"], cfg) for h in
                 halves]
        xent = [tlm.chunked_xent(state["params"], x, h["labels"], cfg)
                for (x, _), h in zip(parts, halves)]
        aux = [float(a) for _, a in parts]
    want = np.mean([float(x) + 0.01 * a for x, a in zip(xent, aux)])
    assert min(aux) > 0
    assert abs(losses[0] - want) <= 1e-5 * want
    assert abs(losses[0] - np.mean([float(x) for x in xent])) > 1e-3


def test_vlm_launcher_batch_carries_the_reference_vision_stub(monkeypatch):
    """Every batch's ``vision`` is the reference launcher's draw, byte for
    byte: ``default_rng(0).normal(0, 1, (batch, vision_seq, d_model))``
    in float32."""
    seen = _recording(monkeypatch)
    losses = ttrain.main(_family_args("llama-3.2-vision-11b", 3))
    cfg = jget("llama-3.2-vision-11b", smoke=True)
    want = np.random.default_rng(0).normal(
        0, 1, (4, cfg.vision_seq, cfg.d_model)).astype("float32")
    assert len(seen) == 3 and all(np.isfinite(losses))
    for b in seen:
        assert sorted(b) == ["labels", "tokens", "vision"]
        assert b["vision"].dtype == torch.float32
        assert b["vision"].numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama-3.2-vision-11b"])
def test_serve_cli_serves_the_family_smoke_configs(arch, capsys):
    """launch/serve.py --device cpu; vlm with the zero vision K/V cache of
    init_cache, as the reference's launcher serves it."""
    n = tserve.main(["--arch", arch, "--smoke", "--slots", "3",
                     "--requests", "5", "--prompt-len", "4", "--max-new",
                     "5", "--cache-len", "32", "--device", "cpu"])
    assert n == 25 and "[serve] 5/5 requests" in capsys.readouterr().out
