"""The traced window with the port's own spans on the device trace's clock.

``SpanTracer`` is ``trace.Tracer`` with the port's span recorder
(``repro_torch.tracing``) open inside the profiler window:

- the port's spans are mapped onto the trace's clock through two
  anchors, the synchronises that open and close the window, and kept in
  ``SpanTraceData.spans`` (times in microseconds, with their ids,
  parents, threads and attrs); ``drift_us`` is how far the close lands
  from where the open alone would place it;
- the harness's own spans (``span``) go through the same recorder under
  the ``portbench.`` prefix, so one span store and one clock remain;
- for each span name, ``span_launches`` counts the CUDA launch calls the
  profiler recorded inside spans of that name;
- each idle gap of the device is labelled ``<harness span> / <innermost
  port work span open at its middle, or "-"> / <innermost CUDA call>``,
  with ``port`` for the first part where no harness span is open.  A
  span recorded as a wait (``tracing.record``) never labels a gap.

``record=False`` keeps the profiler and leaves the recorder shut, which
is how ``portbench/port_spans.py`` reads what recording costs.  The
benchmark's own runs trace with ``trace.Tracer``; the readers under
``metrics/`` that read ``spans`` return ``None`` on its ``TraceData``.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import time
from collections import defaultdict

import torch

from portbench.counts.kernels import ENTRY_POINTS, FFT_FUNCTIONS
from portbench.harness.program import sync
from portbench.harness.trace import (
    GAP_MIN_US, SPAN_PREFIX, TraceData, Tracer, _fft_dims, _merge, _patched,
)

ANCHOR = SPAN_PREFIX + "anchor"  # a marker the CPU's host trace records
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC")


@dataclasses.dataclass
class SpanTraceData(TraceData):
    spans: list = dataclasses.field(default_factory=list)
    span_launches: dict = dataclasses.field(default_factory=dict)
    gaps: list = dataclasses.field(default_factory=list)  # (middle us, s)
    drift_us: float = 0.0


class _Sweep:
    """Intervals (start, end, name) open at increasing points."""

    def __init__(self, intervals):
        self.items = sorted(intervals)
        self.starts = [h[0] for h in self.items]
        self.active: list = []
        self.i = 0

    def at(self, t: float) -> list:
        j = bisect.bisect_right(self.starts, t)
        self.active.extend(self.items[self.i:j])
        self.i = max(self.i, j)
        self.active = [h for h in self.active if h[1] >= t]
        return self.active


def _label_gaps(gaps, calls, spans) -> list:
    """Sum each idle gap's length under what the host was doing at its
    middle: the outermost harness span open then, the innermost port span
    at work (not a wait), and the innermost CUDA call."""
    harness = _Sweep((s.t0, s.t1, s.name) for s in spans
                     if s.name.startswith(SPAN_PREFIX))
    work = _Sweep((s.t0, s.t1, s.name) for s in spans
                  if not s.wait and not s.name.startswith(SPAN_PREFIX))
    host = _Sweep(calls)
    totals: dict = defaultdict(float)
    for mid, length in sorted(gaps):
        outer, inner, call = harness.at(mid), work.at(mid), host.at(mid)
        totals[f"{min(outer)[2] if outer else 'port'} / "
               f"{max(inner)[2] if inner else '-'} / "
               f"{max(call)[2] if call else 'host code'}"] += length
    return sorted(totals.items(), key=lambda kv: -kv[1])


def _launches_by_span(launches, spans) -> dict:
    """{span name: the launch calls (times) inside its spans}.  By time
    alone: the profiler's thread ids are not the native ids the spans
    carry (none matched on the card), so a launch from another thread
    inside a span counts too."""
    launches = sorted(launches)
    groups: dict = defaultdict(list)
    for s in spans:
        groups[s.name].append((s.t0, s.t1))
    return {name: sum(bisect.bisect_right(launches, b)
                      - bisect.bisect_left(launches, a)
                      for a, b in _merge(intervals))
            for name, intervals in groups.items()}


class SpanTracer(Tracer):
    def __init__(self, enabled: bool, device, record: bool = True):
        super().__init__(enabled, device)
        self.record = record

    def span(self, name: str):
        from repro_torch import tracing

        return tracing.span(SPAN_PREFIX + name) if self.enabled else tracing.OFF

    @contextlib.contextmanager
    def window(self):
        """Trace what runs inside; ``self.data`` holds the result."""
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

        from repro_torch import tracing
        from repro_torch.kernels import ops

        calls: dict = defaultdict(list)
        ffts: list = []

        def launch(name, args, kw):
            calls[name].append(tuple(tuple(a.shape) for a in args
                                     if isinstance(a, torch.Tensor)))

        def transform(name, args, kw):
            ffts.append((name, tuple(args[0].shape), _fft_dims(name, args, kw)))

        cuda = self.device.type == "cuda"
        acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
        sync(self.device)
        before = ops.launch_counts()
        spans: list = []
        with profile(activities=acts) as prof, \
                _patched(ops, ENTRY_POINTS, launch), \
                _patched(torch.fft, FFT_FUNCTIONS, transform), \
                (tracing.recording() if self.record
                 else contextlib.nullcontext([])) as spans:
            anchors = [self._anchor()]  # the first synchronise on its clock
            t0 = time.perf_counter()
            yield
            anchors.append(self._anchor())
            window_s = time.perf_counter() - t0
        after = ops.launch_counts()
        t1 = time.perf_counter()
        self.data = _digest(prof, window_s, dict(calls), ffts,
                            {k: after[k] - before.get(k, 0) for k in after},
                            list(spans), anchors)
        self.data.digest_s = time.perf_counter() - t1

    def _anchor(self) -> int:
        """Synchronise, marked for the host trace; the ``perf_counter_ns``
        reading at its middle."""
        from torch.profiler import record_function

        t = time.perf_counter_ns()
        with record_function(ANCHOR):
            sync(self.device)
        return (t + time.perf_counter_ns()) // 2


def _on_clock(spans, anchors_ns, anchors_us) -> tuple:
    """The spans with their ``perf_counter_ns`` times on the trace's clock
    (us), through the two anchors; and the drift of the second."""
    (a0, a1), (u0, u1) = anchors_ns, anchors_us
    scale = (u1 - u0) / (a1 - a0) if a1 > a0 else 1e-3
    at = lambda t: u0 + (t - a0) * scale  # noqa: E731
    return ([s._replace(t0=at(s.t0), t1=at(s.t1)) for s in spans],
            u1 - (u0 + (a1 - a0) * 1e-3))


def _digest(prof, window_s, calls, ffts, counts, spans,
            anchors_ns) -> SpanTraceData:
    device_spans, host, launches = [], [], []
    per_name: dict = defaultdict(float)
    cuda = torch.autograd.DeviceType.CUDA
    markers, syncs = [], []
    events = prof.events()
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if getattr(e, "is_user_annotation", False):
                continue
            device_spans.append((start, end))
            per_name[e.name] += end - start
            continue
        if e.name == ANCHOR:
            markers.append((start + end) / 2.0)
            continue
        host.append((start, end, e.name))
        if e.name == "cudaDeviceSynchronize":
            syncs.append((start + end) / 2.0)
        if e.name in LAUNCH_CALLS:
            launches.append((start + end) / 2.0)
    # the host trace marks the anchors; the device trace has their syncs
    found = sorted(markers if len(markers) >= 2 else syncs)
    mapped, drift = [], 0.0
    if len(found) >= 2:
        mapped, drift = _on_clock(spans, anchors_ns, (found[0], found[-1]))
    merged = _merge(device_spans)
    busy_us = sum(e - s for s, e in merged)
    gaps = [((a[1] + b[0]) / 2.0, (b[0] - a[1]) * 1e-6)
            for a, b in zip(merged, merged[1:]) if b[0] - a[1] >= GAP_MIN_US]
    return SpanTraceData(window_s=window_s, busy_s=busy_us * 1e-6,
                         device_time_us=dict(per_name), launches=calls,
                         launch_counts=counts, ffts=ffts,
                         idle_gaps=_label_gaps(gaps, host, mapped),
                         events=len(events), spans=mapped,
                         span_launches=_launches_by_span(launches, mapped),
                         gaps=gaps,
                         drift_us=drift)


# --- what the readers under metrics/ share ---
def named(trace, name: str) -> list:
    """The trace's port spans named ``name`` (none on a plain trace)."""
    return [s for s in getattr(trace, "spans", ()) if s.name == name]


def children(trace) -> dict:
    """{span id: [its child spans]}."""
    out: dict = defaultdict(list)
    for s in getattr(trace, "spans", ()):
        if s.parent is not None:
            out[s.parent].append(s)
    return out


def ms(s) -> float:
    return (s.t1 - s.t0) * 1e-3


def mean(values) -> float:
    values = list(values)
    return sum(values) / len(values) if values else None
