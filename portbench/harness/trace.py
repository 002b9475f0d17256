"""The traced window of a ``--trace 1`` run.

``Tracer.window()`` runs ``torch.profiler`` on the device's activity
alone (kernels, copies and the CUDA calls that launched them): recording
every host op as well slowed a serving batch threefold and a training
step twofold on the card, which would make the idle share read the
profiler.  What the device trace cannot say is taken on the host, at
little cost:

- each call of the port's raw kernel entry points, with its argument
  shapes (``counts.kernels.ENTRY_POINTS``), so a kernel's bytes are
  counted at the shapes it was launched with;
- each ``torch.fft`` transform asked for, with its shape and dims;
- the harness's own spans around its calls into each layer of the port
  (``Tracer.span``), placed on the trace's clock by a synchronise at the
  window's start, so an idle gap of the device is named by what the
  harness and the CUDA calls were doing then.

The result, a ``TraceData``, is what the per-layer readers in
``metrics/`` read, with the driver's own readings beside it.  With
tracing off, ``span`` and ``window`` cost nothing.
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

SPAN_PREFIX = "portbench."
GAP_MIN_US = 5.0  # shorter gaps are launch spacing, not named
TOP = 10


@dataclasses.dataclass
class TraceData:
    window_s: float
    busy_s: float
    device_time_us: dict       # device kernel or copy name -> total us
    launches: dict             # entry point -> [argument shapes]
    launch_counts: dict        # the port's counter, delta over the window
    ffts: list                 # (function, input shape, dims)
    idle_gaps: list            # [(label, seconds)] by host activity
    events: int = 0            # profiler events read
    digest_s: float = 0.0      # seconds spent reading them
    readings: dict = dataclasses.field(default_factory=dict)

    def kernel_us(self, fragments) -> float:
        return sum(us for name, us in self.device_time_us.items()
                   if any(f in name for f in fragments))

    def breakdown(self) -> dict:
        ops = sorted(self.device_time_us.items(), key=lambda kv: -kv[1])
        return {"device_ops": [[_short(n), us * 1e-6] for n, us in ops[:TOP]],
                "idle_gaps": [[n, s] for n, s in self.idle_gaps[:TOP]]}


def _short(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


def _merge(spans) -> list:
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _label_gaps(gaps, host) -> list:
    """Sum each idle gap's length under what the host was doing at its
    middle: the harness span then open and the innermost CUDA call."""
    host = sorted(host)
    starts = [h[0] for h in host]
    active: list = []
    i = 0
    totals: dict = defaultdict(float)
    for mid, length in sorted(gaps):
        j = bisect.bisect_right(starts, mid)
        active.extend(host[i:j])
        i = max(i, j)
        active = [h for h in active if h[1] >= mid]
        spans = [h for h in active if h[2].startswith(SPAN_PREFIX)]
        calls = [h for h in active if not h[2].startswith(SPAN_PREFIX)]
        outer = min(spans)[2] if spans else "port"
        inner = max(calls)[2] if calls else "host code"
        totals[f"{outer} / {inner}"] += length
    return sorted(totals.items(), key=lambda kv: -kv[1])


@contextlib.contextmanager
def _patched(module, names, note):
    """Wrap ``module``'s functions ``names`` to call ``note(name, args,
    kwargs)`` first; a name the module no longer has is skipped."""
    saved = {}
    for name in names:
        fn = getattr(module, name, None)
        if fn is None:
            continue

        def noted(*args, _fn=fn, _name=name, **kw):
            note(_name, args, kw)
            return _fn(*args, **kw)

        saved[name] = fn
        setattr(module, name, noted)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def _fft_dims(name: str, args, kw) -> tuple:
    """The dims a ``torch.fft`` call transforms (its default if unnamed)."""
    default = (-2, -1) if name.endswith("2") else (-1,)
    dims = kw.get("dim", args[2] if len(args) > 2 else default)
    return tuple(dims) if isinstance(dims, (tuple, list)) else (dims,)


class Tracer:
    def __init__(self, enabled: bool, device):
        self.enabled = bool(enabled)
        self.device = torch.device(device)
        self.data = None
        self._spans: list = []

    @contextlib.contextmanager
    def _span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._spans.append((t0, time.perf_counter(), SPAN_PREFIX + name))

    def span(self, name: str):
        return self._span(name) if self.enabled else contextlib.nullcontext()

    @contextlib.contextmanager
    def window(self):
        """Trace what runs inside; ``self.data`` holds the result."""
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile

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
        self._spans = []
        before = ops.launch_counts()
        with profile(activities=acts) as prof, \
                _patched(ops, ENTRY_POINTS, launch), \
                _patched(torch.fft, FFT_FUNCTIONS, transform):
            anchor = time.perf_counter()
            sync(self.device)  # the first synchronise on the trace's clock
            anchor = (anchor + time.perf_counter()) / 2.0
            t0 = time.perf_counter()
            yield
            sync(self.device)
            window_s = time.perf_counter() - t0
        after = ops.launch_counts()
        t1 = time.perf_counter()
        self.data = _digest(prof, window_s, dict(calls), ffts,
                            {k: after[k] - before.get(k, 0) for k in after},
                            self._spans, anchor)
        self.data.digest_s = time.perf_counter() - t1


def _digest(prof, window_s, calls, ffts, counts, spans, anchor) -> TraceData:
    device_spans, host = [], []
    per_name: dict = defaultdict(float)
    cuda = torch.autograd.DeviceType.CUDA
    sync_at = None
    events = prof.events()
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == cuda:
            if getattr(e, "is_user_annotation", False):
                continue
            device_spans.append((start, end))
            per_name[e.name] += end - start
            continue
        host.append((start, end, e.name))
        if sync_at is None and e.name == "cudaDeviceSynchronize":
            sync_at = (start + end) / 2.0
    if sync_at is not None:  # the harness's spans on the trace's clock
        host += [((a - anchor) * 1e6 + sync_at, (b - anchor) * 1e6 + sync_at,
                  name) for a, b, name in spans]
    merged = _merge(device_spans)
    busy_us = sum(e - s for s, e in merged)
    gaps = [((a[1] + b[0]) / 2.0, (b[0] - a[1]) * 1e-6)
            for a, b in zip(merged, merged[1:]) if b[0] - a[1] >= GAP_MIN_US]
    return TraceData(window_s=window_s, busy_s=busy_us * 1e-6,
                     device_time_us=dict(per_name), launches=calls,
                     launch_counts=counts, ffts=ffts,
                     idle_gaps=_label_gaps(gaps, host), events=len(events))
