"""The port's spans on the trace's clock (``harness/spans.py``), the span
metrics' readers and ``port_spans.py``, on the CPU at the smoke twins."""
import re

import pytest

from portbench import port_spans
from portbench.harness import spec
from portbench.harness.spans import _label_gaps, _launches_by_span
from repro_torch.tracing import Span

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
SPAN_METRICS = port_spans.per_layer()


def _span(name, t0, t1, id, parent=None, thread=1, wait=False, **attrs):
    return Span(name, t0, t1, id, parent, thread, attrs, wait)


def test_label_gaps_name_the_innermost_work_span_never_a_wait():
    spans = [
        _span("portbench.dse.call", 0.0, 100.0, 1),
        _span("dse.emulate", 10.0, 90.0, 2, 1),
        _span("dse.inputs", 20.0, 50.0, 3, 2),
        _span("serve.queue", 0.0, 200.0, 4, wait=True),
        _span("serve.queue", 140.0, 160.0, 5, wait=True),
    ]
    calls = [(29.0, 31.0, "cudaMemcpyAsync"), (60.0, 61.0, "cudaLaunchKernel")]
    gaps = [(30.0, 1.0), (45.0, 2.0), (60.5, 4.0), (95.0, 8.0), (150.0, 16.0)]
    got = dict(_label_gaps(gaps, calls, spans))
    assert got == {
        "portbench.dse.call / dse.inputs / cudaMemcpyAsync": 1.0,
        "portbench.dse.call / dse.inputs / host code": 2.0,
        "portbench.dse.call / dse.emulate / cudaLaunchKernel": 4.0,
        "portbench.dse.call / - / host code": 8.0,
        "port / - / host code": 16.0,
    }
    assert list(dict(_label_gaps(gaps, calls, spans)))[0] == \
        "port / - / host code"  # the longest first


def test_launches_count_inside_spans_of_each_name():
    spans = [_span("serve.batch", 0.0, 10.0, 1),
             _span("serve.batch", 20.0, 30.0, 2),
             _span("serve.forward", 2.0, 4.0, 3, 1),
             _span("serve.stack", 1.0, 2.5, 4, 1),
             _span("serve.stack", 2.0, 3.5, 5, 1)]  # overlapping: once
    launches = [25.0, 3.0, 1.0, 15.0, 40.0]
    assert _launches_by_span(launches, spans) == {
        "serve.batch": 3, "serve.forward": 1, "serve.stack": 2}


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


@pytest.mark.parametrize("m", SPAN_METRICS, ids=lambda m: m["name"])
def test_span_metrics_are_ready_for_the_benchmark(m):
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    layers = {p["layer"] for p in BENCH["per_layer"]}
    assert NAME.match(m["name"]) and m["name"] not in {
        p["name"] for p in BENCH["per_layer"]}
    assert m["layer"] in layers and m["moves"] in e2e
    assert m["source"] in ("program_span", "device_trace")
    for cell in m["workloads"]:
        assert cell in CELLS and cell in e2e[m["moves"]]["workloads"]
    assert callable(spec.metric_reader(m["name"]).read)


def _reading(name, spans, **fields):
    from portbench.harness.spans import SpanTraceData

    data = SpanTraceData(window_s=1.0, busy_s=0.5, device_time_us={},
                         launches={}, launch_counts={}, ffts=[],
                         idle_gaps=[], spans=spans, **fields)
    return spec.metric_reader(name).read(data, None, None)


def test_span_readers_on_synthetic_spans():
    serve = [_span("serve.batch", 0.0, 10_000.0, 1, rows=32),
             _span("serve.forward", 1_000.0, 3_000.0, 2, 1),
             _span("serve.readback", 3_000.0, 9_000.0, 3, 1),
             _span("serve.queue", -4_000.0, 0.0, 4, 1, wait=True),
             _span("serve.queue", -2_000.0, 0.0, 5, 1, wait=True)]
    assert _reading("serve.queue_wait_ms", serve) == 3.0
    assert _reading("serve.serial_host_ms", serve) == 2.0
    assert _reading("serve.launches_per_batch", serve,
                    span_launches={"serve.batch": 190}) == 190.0
    assert _reading("serve.launches_per_batch", serve) is None
    dse = [_span("dse.emulate", 0.0, 300_000.0, 1, K=32, B=32),
           _span("dse.inputs", 1_000.0, 251_000.0, 2, 1, hit=False),
           _span("dse.forward", 260_000.0, 299_000.0, 3, 1),
           _span("dse.emulate", 400_000.0, 415_000.0, 4, K=32, B=32),
           _span("dse.inputs", 401_000.0, 402_000.0, 5, 4, hit=True),
           _span("dse.forward", 405_000.0, 414_000.0, 6, 4)]
    assert _reading("dse.inputs_build_ms", dse) == 250.0
    assert _reading("dse.prep_ms", dse) == 6.0  # the hit call alone
    train = [_span("train.chunk", 0.0, 800_000.0, 1, steps=8),
             _span("train.upload", 0.0, 16_000.0, 2, 1)]
    assert _reading("train.upload_wait_ms", train) == 2.0
    for m in port_spans.METRICS:  # a trace without the port's spans
        assert _reading(m["name"], []) is None


@pytest.mark.parametrize("name", CELLS)
def test_traced_smoke_run_reports_its_span_metrics(name):
    rows = []
    port_spans.run(name, 2_147_483_647, 0.3, ["on", "off"], "cpu",
                   rows.append, smoke=True)
    on, off, device = rows
    listed = {m["name"] for m in SPAN_METRICS
              if name in m["workloads"] and m["source"] == "program_span"}
    # what one window reads at the smoke twins, whatever its length, as
    # the cell's driver declares it for its traffic
    declared = port_spans.declared(spec.resolve(name, smoke=True))
    assert set(declared) <= {m["name"] for m in port_spans.METRICS}
    want = {m for m, every in declared.items() if every}
    assert want <= listed and want <= set(on["metrics"])
    assert all(on["metrics"][m] > 0 for m in want)
    # spans reach the trace only once placed on its clock by the anchors
    assert on["spans"] > 0
    assert off["spans"] == 0 and not listed & set(off["metrics"])
    assert on["rates"] and device["device"]["platform"] == "cpu"
