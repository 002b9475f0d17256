"""``repro_torch.runtime.cost_analysis`` (the port's op-level cost counter)
against the reference's HLO analysis of the same programs' JAX twins
(``tests/test_hlo_analysis.py``'s cases), on the CPU.

- ``x @ w``: dot FLOPs exact, equal to ``analyze``'s;
- ``sum(relu(x @ w) ** 2)``: FLOPs within the reference's own 5% of
  ``analyze`` and of XLA's count; HBM bytes each op's inputs and outputs;
- a 13-step and a 3 x 5 nested loop: 13 and 15 times the body's dot
  FLOPs, as ``analyze`` trip-counts its scans;
- collectives on a fake process group of 4 (a subprocess): each of the
  port's collectives counted once with the reference's ring factors
  (``hlo_analysis._COLL_FACTOR``), ``reduce_scatter_dim`` as a
  reduce-scatter although the fake backend runs it as an all-reduce and a
  cut; a c10d op outside them raises;
- the qwen1.5-4b smoke train step (batch 4 x seq 64, f32): dot FLOPs
  within 2% of ``analyze`` of ``jax.jit(make_train_step(...))``.  The
  gap, 1.89%, is two recomputations: the port's checkpointed
  ``chunked_xent`` computes the unembedding product again in the backward
  (one (256, 64) x (64, 256) dot more), and XLA's backward of the
  chunked attention computes four (4, 4, 64, 32) score products that the
  port's autograd keeps from the forward (ROADMAP queue 3);
- the same step on fake tensors counts what it counts on real ones, and
  the peak live bytes of a small program are its tensors' bytes.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from _torch_cores import share_cores  # noqa: E402

share_cores(torch)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.compat import compiled_cost_analysis  # noqa: E402
from repro.models import get_config as jget  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.runtime import steps as jsteps  # noqa: E402
from repro.runtime.hlo_analysis import _COLL_FACTOR, analyze  # noqa: E402
from repro_torch.models import get_config as tget  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.runtime import steps as tsteps  # noqa: E402
from repro_torch.runtime.cost_analysis import count  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _analyze(f, *shapes):
    c = jax.jit(f).lower(*(jax.ShapeDtypeStruct(s, jnp.float32)
                           for s in shapes)).compile()
    return analyze(c.as_text()), compiled_cost_analysis(c)


def test_dot_flops_exact():
    ref, _ = _analyze(lambda x, w: x @ w, (64, 128), (128, 32))
    got = count(lambda x, w: x @ w, torch.ones(64, 128), torch.ones(128, 32))
    assert got.dot_flops == 2 * 64 * 128 * 32 == ref.dot_flops
    assert got.bytes == 4 * (64 * 128 + 128 * 32 + 64 * 32)


def test_flops_within_the_references_tolerance():
    ref, xla = _analyze(lambda x, w: jnp.sum(jax.nn.relu(x @ w) ** 2),
                        (128, 256), (256, 512))
    got = count(lambda x, w: torch.sum(torch.relu(x @ w) ** 2),
                torch.ones(128, 256), torch.ones(256, 512))
    assert abs(got.flops - ref.flops) / ref.flops < 0.05
    assert abs(got.flops - xla["flops"]) / xla["flops"] < 0.05
    out = 4 * 128 * 512
    # mm reads x, w and writes out; relu and pow read and write it; sum
    # reads it and writes a scalar
    assert got.bytes == 4 * (128 * 256 + 256 * 512) + out + 2 * (2 * out) \
        + out + 4
    assert got.elementwise_flops == 2 * 128 * 512


def test_loops_count_every_step():
    def scan(w, x):
        def body(c, _):
            return c @ w, None
        y, _ = jax.lax.scan(body, x, None, length=13)
        return jnp.sum(y)

    def nested(w, x):
        def outer(c, _):
            def inner(ci, _):
                return ci @ w, None
            c, _ = jax.lax.scan(inner, c, None, length=3)
            return c, None
        y, _ = jax.lax.scan(outer, x, None, length=5)
        return jnp.sum(y)

    def loop(w, x, n=13):
        for _ in range(n):
            x = x @ w
        return torch.sum(x)

    def loops(w, x):
        for _ in range(5):
            for _ in range(3):
                x = x @ w
        return torch.sum(x)

    ref13, _ = _analyze(scan, (32, 32), (8, 32))
    got13 = count(loop, torch.ones(32, 32), torch.ones(8, 32))
    assert got13.dot_flops == ref13.dot_flops == 13 * 2 * 8 * 32 * 32
    ref15, _ = _analyze(nested, (16, 16), (4, 16))
    got15 = count(loops, torch.ones(16, 16), torch.ones(4, 16))
    assert got15.dot_flops == ref15.dot_flops == 15 * 2 * 4 * 16 * 16


def test_memory_of_a_small_program():
    x = torch.ones(256, 256)
    got = count(lambda x: (x * 2).sum(), x)
    assert got.argument_bytes == x.nbytes
    assert got.peak_bytes == 2 * x.nbytes + 4  # x, x * 2, the sum
    assert got.output_bytes == 4 and got.alias_bytes == 0
    donated = count(lambda x: x.add_(1), torch.ones(64))
    assert donated.alias_bytes == donated.output_bytes == 256
    assert donated.peak_bytes == 256


COLLECTIVES = textwrap.dedent("""
    import json, sys
    import torch, torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.runtime import collectives as col
    from repro_torch.runtime.cost_analysis import count

    dist.init_process_group("fake", store=FakeStore(), rank=1,
                            world_size=4)
    g = dist.group.WORLD
    t = torch.ones(8, 32)
    cases = {
        "all-gather": lambda t: col.all_gather_dim(t, g, 0),
        "all-reduce": lambda t: col.all_reduce_sum(t, g),
        "reduce-scatter": lambda t: col.reduce_scatter_dim(t, g, 0),
        "all-to-all": lambda t: col.exchange(t, g),
        "all-max": lambda t: col.all_max(t, g),
        "gather-backward": lambda t: torch.autograd.grad(
            col.gather_dim(t, g, 0).sum(), t)[0],
    }
    out = {"backend": dist.get_backend(g)}
    for name, fn in cases.items():
        c = count(fn, t.clone().requires_grad_(name == "gather-backward"))
        out[name] = [c.collective_bytes, c.collective_breakdown]
    try:
        count(lambda t: dist.all_reduce(t), t)
        out["raw"] = "counted"
    except RuntimeError as e:
        out["raw"] = str(e)
    dist.destroy_process_group()
    print(json.dumps(out))
""")


def test_collectives_by_the_references_ring_factors():
    r = subprocess.run([sys.executable, "-c", COLLECTIVES],
                       capture_output=True, text=True, timeout=120,
                       env={**os.environ, "PYTHONPATH": os.path.join(
                           ROOT, "src"), "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["backend"] == "fake"  # not NCCL: reduce-scatter = AR + cut
    n = 8 * 32 * 4  # bytes of the input
    want = {
        "all-gather": ("all-gather", _COLL_FACTOR["all-gather"](4 * n, 4)),
        "all-reduce": ("all-reduce", _COLL_FACTOR["all-reduce"](n, 4)),
        "reduce-scatter": ("reduce-scatter",
                           _COLL_FACTOR["reduce-scatter"](n / 4, 4)),
        "all-to-all": ("all-to-all", _COLL_FACTOR["all-to-all"](n, 4)),
        "all-max": ("all-reduce", _COLL_FACTOR["all-reduce"](n, 4)),
    }
    for name, (kind, b) in want.items():
        assert got[name] == [b, {kind: b}], name
    # the gather's backward is a reduce-scatter of the (32, 32) cotangent
    gb = _COLL_FACTOR["all-gather"](4 * n, 4)
    rs = _COLL_FACTOR["reduce-scatter"](n, 4)
    assert got["gather-backward"] == [gb + rs, {"all-gather": gb,
                                                "reduce-scatter": rs}]
    assert "outside the port's collectives" in got["raw"]


def _qwen_smoke_step():
    jc = dataclasses.replace(jget("qwen1.5-4b", smoke=True),
                             dtype=jnp.float32)
    tc = dataclasses.replace(tget("qwen1.5-4b", smoke=True),
                             dtype=torch.float32)
    kw = dict(lr=1e-3, weight_decay=0.01, grad_clip_norm=1.0)
    return jc, tc, JAdamW(**kw), AdamW(**kw)


def test_train_step_dot_flops_match_the_reference():
    jc, tc, jopt, topt = _qwen_smoke_step()
    B, S = 4, 64
    jstate = jsteps.init_train_state(jc, jax.random.PRNGKey(0), jopt)
    jb = {k: jnp.zeros((B, S), jnp.int32) for k in ("tokens", "labels")}
    ref = analyze(jax.jit(jsteps.make_train_step(jc, jopt)).lower(
        jstate, jb).compile().as_text())
    state = tsteps.init_train_state(tc, torch.Generator().manual_seed(0),
                                    topt)
    tb = {k: torch.zeros((B, S), dtype=torch.int32)
          for k in ("tokens", "labels")}
    got = count(tsteps.make_train_step(tc, topt), state, tb)
    # the port's checkpointed chunked_xent recomputes the unembedding
    # (2 * 256 * 64 * 256 more); XLA recomputes four (4, 4, 64, 32) score
    # blocks over head_dim 16 (2 * 4 * 4 * 64 * 32 * 16 = 2 ** 20 each)
    assert got.dot_flops - ref.dot_flops == 2 * 256 * 64 * 256 - 4 * 2 ** 20
    assert abs(got.dot_flops - ref.dot_flops) / ref.dot_flops <= 0.02


def test_fake_tensors_count_what_real_ones_do():
    from torch._subclasses.fake_tensor import FakeTensorMode

    _, tc, _, topt = _qwen_smoke_step()
    step = tsteps.make_train_step(tc, topt)

    def batch():
        return {k: torch.zeros((2, 32), dtype=torch.int32)
                for k in ("tokens", "labels")}

    real = count(step, tsteps.init_train_state(
        tc, torch.Generator().manual_seed(0), topt), batch())
    specs = tsteps.train_state_specs(tc)
    with FakeTensorMode():
        state = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype),
                         specs)
        fake = count(step, state, batch())
    for k in ("flops", "dot_flops", "elementwise_flops", "bytes",
              "peak_bytes", "argument_bytes"):
        assert getattr(fake, k) == getattr(real, k), k
