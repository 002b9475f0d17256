"""The port's span recorder (``repro_torch.tracing``) and its span sites in
the serving engine, the design flow and the training driver (CPU)."""
import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cores import share_cores  # noqa: E402

share_cores(torch)

from repro_torch import tracing  # noqa: E402
from repro_torch.core.config import DONNConfig  # noqa: E402
from repro_torch.core.models import (  # noqa: E402
    build_model, clear_emulation_caches, emulate_batch,
)
from repro_torch.core.train_utils import make_train_chunk  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.runtime.inference import (  # noqa: E402
    InferenceEngine, MicroBatcher, freeze,
)

CPU = "cpu"
CFG = DONNConfig(name="trace", n=32, depth=2, distance=0.05, det_size=6,
                 input_size=28)


def _model(seed=0):
    model = build_model(CFG, device=CPU)
    return model, model.init(torch.Generator().manual_seed(seed))


def _images(b, seed=0):
    return np.random.default_rng(seed).random((b, 28, 28), np.float32)


def _named(spans, name):
    return [s for s in spans if s.name == name]


def _sites(spans):
    """The spans of the port's sites: a collection may land anywhere."""
    return [s for s in spans if s.name != "python.gc"]


# --------------------------------------------------------------------------
# The recorder
# --------------------------------------------------------------------------
def test_off_returns_the_shared_no_op_and_records_nothing():
    assert not tracing.is_on()
    with tracing.span("a", k=1) as s:
        s.set(hit=True)
        tracing.record("w", 0, 1)
    assert s is tracing.OFF and tracing.span("b") is tracing.OFF
    with tracing.recording() as spans:
        pass
    assert _sites(spans) == []


def test_on_nesting_parents_threads_attrs_and_waits():
    with tracing.recording() as spans:
        with tracing.span("outer", k=3) as outer:
            with tracing.span("inner") as inner:
                inner.set(hit=False)
            tracing.record("queued", 10, 20, parent=outer.id, request=7)
        done = threading.Event()

        def other():
            with tracing.span("elsewhere"):
                pass
            done.set()

        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
        assert done.is_set()
    with tracing.span("after"):
        pass
    assert not tracing.is_on()
    spans = _sites(spans)
    by = {s.name: s for s in spans}
    assert set(by) == {"outer", "inner", "queued", "elsewhere"}
    o, i, q, e = by["outer"], by["inner"], by["queued"], by["elsewhere"]
    assert o.parent is None and i.parent == o.id and q.parent == o.id
    assert o.t0 <= i.t0 <= i.t1 <= o.t1
    assert o.attrs == {"k": 3} and i.attrs == {"hit": False}
    assert (q.t0, q.t1, q.attrs, q.wait) == (10, 20, {"request": 7}, True)
    assert not o.wait and not i.wait
    assert o.thread == i.thread == threading.get_native_id() != e.thread
    assert e.parent is None  # another thread's stack is its own
    assert len({s.id for s in spans}) == 4


def test_collections_are_spans_while_recording():
    import gc

    with tracing.recording() as spans:
        with tracing.span("outer") as outer:
            gc.collect()
    gc.collect()
    full = [s for s in _named(spans, "python.gc")
            if s.attrs["generation"] == 2]
    assert full and all(s.parent == outer.id for s in full)
    assert tracing._collected not in gc.callbacks


def test_one_window_at_a_time_and_late_spans_dropped():
    with tracing.recording() as spans:
        late = tracing.span("late")
        late.__enter__()
        with pytest.raises(RuntimeError):
            with tracing.recording():
                pass
    late.__exit__(None, None, None)
    assert _sites(spans) == []


# --------------------------------------------------------------------------
# Span sites
# --------------------------------------------------------------------------
def test_micro_batcher_spans():
    model, params = _model()
    eng = InferenceEngine(freeze(model, params, device=CPU), buckets=(2, 4),
                          device=CPU)
    eng.warmup()
    mb = MicroBatcher(eng, max_wait_ms=5.0)
    x = _images(10)
    with tracing.recording() as spans:
        futures = [mb.submit(x[i]) for i in range(len(x))]
        for f in futures:
            f.result(timeout=60)
        assert mb.close()
    spans = _sites(spans)
    queue, batches = _named(spans, "serve.queue"), _named(spans, "serve.batch")
    assert len(queue) == len(x) and all(q.wait for q in queue)
    assert sorted(q.attrs["request"] for q in queue) == list(range(1, 11))
    by_id = {b.id: b for b in batches}
    assert all(q.parent in by_id for q in queue)
    assert sum(b.attrs["rows"] for b in batches) == len(x)
    for b in batches:
        mine = [q for q in queue if q.parent == b.id]
        assert len(mine) == b.attrs["rows"]
        assert b.attrs["bucket"] == (2 if b.attrs["rows"] <= 2 else 4)
        assert all(q.t1 <= b.t0 + 10**6 for q in mine)
        kids = {s.name for s in spans if s.parent == b.id and not s.wait}
        assert kids == {"serve.stack", "serve.upload", "serve.forward",
                        "serve.readback", "serve.resolve"}


def test_engine_infer_alone_records_the_inner_spans():
    model, params = _model()
    eng = InferenceEngine(freeze(model, params, device=CPU), buckets=(4,),
                          device=CPU)
    with tracing.recording() as spans:
        eng.infer(_images(3))
    spans = _sites(spans)
    assert [s.name for s in spans] == ["serve.stack", "serve.upload",
                                       "serve.forward", "serve.readback"]
    assert all(s.parent is None for s in spans)


def test_emulate_batch_spans_miss_then_hit():
    clear_emulation_caches()
    cfgs = [dataclasses.replace(CFG, name=f"c{k}", distance=0.04 + 0.01 * k)
            for k in range(3)]
    _, params = _model()
    x = _images(4)
    with tracing.recording() as spans:
        first = emulate_batch(cfgs, params, x, device=CPU)
        second = emulate_batch(cfgs, params, x, device=CPU)
    spans = _sites(spans)
    torch.testing.assert_close(first, second, rtol=0, atol=0)
    calls = _named(spans, "dse.emulate")
    assert [c.attrs for c in calls] == [{"K": 3, "B": 4}] * 2
    inputs = _named(spans, "dse.inputs")
    assert [s.attrs["hit"] for s in inputs] == [False, True]
    for call, inp in zip(calls, inputs):
        kids = [s.name for s in spans if s.parent == call.id]
        assert kids == ["dse.prepare", "dse.inputs", "dse.codesign",
                        "dse.upload_x", "dse.forward"]
        assert inp.parent == call.id
    build = [s.name for s in spans if s.parent == inputs[0].id]
    # validation and the geometry table, the planes' one build, the sources
    assert build == ["dse.inputs.geometry", "dse.inputs.planes",
                     "dse.inputs.sources"]
    assert not [s for s in spans if s.name.startswith("dse.inputs.")
                and s.parent != inputs[0].id]
    clear_emulation_caches()


def test_emulate_batch_outputs_unchanged_by_recording():
    clear_emulation_caches()
    cfgs = [dataclasses.replace(CFG, name=f"r{k}", distance=0.03 + 0.02 * k)
            for k in range(2)]
    _, params = _model(1)
    x = _images(2, seed=1)
    plain = emulate_batch(cfgs, params, x, device=CPU)
    clear_emulation_caches()
    with tracing.recording():
        traced = emulate_batch(cfgs, params, x, device=CPU)
    clear_emulation_caches()
    torch.testing.assert_close(plain, traced, rtol=0, atol=0)


def test_train_chunk_spans():
    model, params = _model()
    opt = AdamW(lr=1e-2)
    chunk = make_train_chunk(model, opt, CFG.num_classes)
    state = opt.init(params)
    xs = np.stack([_images(2, seed=s) for s in range(3)])
    ys = np.zeros((3, 2), np.int64)
    with tracing.recording() as spans:
        for call in range(2):
            params, state, losses, _ = chunk(params, state, 3 * call, xs, ys)
    spans = _sites(spans)
    assert losses.shape == (3,)
    chunks, uploads = _named(spans, "train.chunk"), _named(spans, "train.upload")
    assert [c.attrs for c in chunks] == [{"steps": 3}] * 2
    assert [u.parent for u in uploads] == [c.id for c in chunks]
    assert {s.name for s in spans} == {"train.chunk", "train.upload"}
