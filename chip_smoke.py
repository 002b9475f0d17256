#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py [--profile FILE]

Phases, each printing its own lines; any failure propagates and the
script exits non-zero without the final line:

1. device  — requires a CUDA card; prints its name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them.
2. build   — compiles the three hand-written kernels from
   ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a (in parallel).
3. kernels — runs each kernel (K1 conj_phase_scale, K2 phase_tf_apply,
   K3 intensity_readout) and its plain PyTorch version on the card on the
   serving path's shapes (32x200x200 with a shared plane, a P=5 stack)
   and an odd 37x53 shape; holds each to max|kernel - plain| <= 1e-5 *
   max|plain| and times both with CUDA events.
4. slice   — builds ``donn-mnist-5l`` (n=200, depth 5, qat 256 levels,
   use_pallas) on the card from a seeded generator, freezes it with f32,
   bf16 and int8 planes (and f32 with the rfft first hop), serves 32
   requests through ``InferenceEngine.infer`` and 64 single requests
   through ``MicroBatcher`` with the launch counters reset just before,
   holds the logits against the same deployment on CPU copies (plain
   versions) and reports req/s and per-batch p50/p99 at bucket 32, each
   row served for WINDOW_S seconds, REPEATS times, rows interleaved.
5. cli     — runs ``repro_torch.launch.serve_donn.main`` once at the
   config's width.

Then one JSON line lists every kernel with its launches on the serving
path, error and times, and the last line is the device record.
``--profile FILE`` adds a ``torch.profiler`` table of PROFILE_BATCHES
bucket-32 batches with the device's busy time and idle share per batch,
printed and written to FILE.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.models import build_model  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.launch import serve_donn  # noqa: E402
from repro_torch.runtime.inference import (  # noqa: E402
    InferenceEngine, MicroBatcher, freeze,
)

# NVIDIA H100 SXM data sheet: HBM3 rate and f32 rate outside the tensor
# cores (dense, at the 700 W limit) — the bound every kernel time sits
# beside.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
KERNEL_RTOL = 1e-5  # max|kernel - plain| / max|plain|
SLICE_RTOL = 1e-4  # logits on the card vs the CPU copy (cuFFT vs pocketfft)
WINDOW_S = 3.0  # seconds of closed-loop serving per row and repeat
REPEATS = 2
PROFILE_BATCHES = 100

KERNEL_META = {
    "conj_phase_scale": ("src/repro_torch/kernels/csrc/spectral_hop.cu",
                         "src/repro/kernels/spectral_hop.py:45"),
    "phase_tf_apply": ("src/repro_torch/kernels/csrc/complex_mul.cu",
                       "src/repro/kernels/complex_mul.py:91"),
    "intensity_readout": ("src/repro_torch/kernels/csrc/intensity_readout.cu",
                          "src/repro/kernels/intensity_readout.py:33"),
}


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; the port's smoke run "
                         "needs the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    # a reference states and sets both: the plain readout is a matmul
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def phase_build() -> None:
    secs = build.build_all()
    print(f"[build] {len(build.SOURCES)} kernels from "
          f"src/repro_torch/kernels/csrc (nvcc, sm_90a, parallel) in "
          f"{secs:.2f}s")
    for name, log in sorted(build.BUILD_LOG.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")


def device_ms(fn, reps: int = 100) -> float:
    """Device time per call: the stream is held by a sleep kernel while
    the host queues ``reps`` calls, so host overhead leaves no gaps."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _cfield(shape, gen, dev):
    re = torch.randn(shape, generator=gen)
    im = torch.randn(shape, generator=gen)
    return torch.complex(re, im).to(dev)


def _compare(name: str, case: str, got, want) -> float:
    got, want = got.cpu(), want.cpu()
    if got.shape != want.shape or not torch.isfinite(
            torch.view_as_real(got) if got.is_complex() else got).all():
        raise AssertionError(f"{name}/{case}: bad output {tuple(got.shape)}")
    err = (got - want).abs().max().item()
    scale = want.abs().max().item()
    print(f"[kernels] {name} {case}: max_abs_err {err:.3e} "
          f"rel {err / scale:.3e} (tol {KERNEL_RTOL:g})")
    if err > KERNEL_RTOL * scale:
        raise AssertionError(f"{name}/{case}: {err:.3e} > "
                             f"{KERNEL_RTOL:g} * {scale:.3e}")
    return err


def phase_kernels(dev) -> dict:
    """Every kernel against its plain version; returns the JSON rows."""
    gen = torch.Generator().manual_seed(1234)
    rows = {}
    B, n = 32, 200
    cases = [("32x200x200 shared plane", (B, n, n), 1, B),
             ("P=5 stack, nb=4", (20, n, n), 5, 4),
             ("odd 37x53, P=3, nb=2", (6, 37, 53), 3, 2)]
    for kname in ("conj_phase_scale", "phase_tf_apply"):
        errs = []
        for case, shape, P, nb in cases:
            x = _cfield(shape, gen, dev)
            th = ((torch.rand((P,) + shape[1:], generator=gen) * 4 - 2)
                  * math.pi).to(dev)
            amp = torch.rand((P,) + shape[1:], generator=gen).to(dev)
            if kname == "conj_phase_scale":
                for sign, scale in ((-1.0, 1.0), (1.0, 1.0 / (shape[1] * shape[2]))):
                    got = ops.conj_phase_scale(x, th, amp, nb, sign, scale)
                    want = ref.conj_phase_scale_ref(x, th, amp, nb, sign, scale)
                    errs.append(_compare(kname, f"{case} sign {sign:+g}",
                                         got, want))
            else:
                got = ops.phase_tf_apply_planes(x, th, amp, nb)
                want = ref.phase_tf_apply_ref(x, th, amp, nb)
                errs.append(_compare(kname, case, got, want))
        # timing at the serving path's shape, inputs rotated through more
        # than the 50 MB L2 so each launch reads its field from HBM
        xs = [_cfield((B, n, n), gen, dev) for _ in range(8)]
        th = (torch.rand((1, n, n), generator=gen) * 2 * math.pi).to(dev)
        amp = torch.rand((1, n, n), generator=gen).to(dev)
        it = iter(range(10 ** 9))
        if kname == "conj_phase_scale":
            kern = lambda: ops.conj_phase_scale(xs[next(it) % 8], th, amp, B,  # noqa: E731
                                                -1.0, 1.0)
            plain = lambda: ref.conj_phase_scale_ref(xs[next(it) % 8], th,  # noqa: E731
                                                     amp, B, -1.0, 1.0)
        else:
            kern = lambda: ops.phase_tf_apply_planes(xs[next(it) % 8], th,  # noqa: E731
                                                     amp, B)
            plain = lambda: ref.phase_tf_apply_ref(xs[next(it) % 8], th,  # noqa: E731
                                                   amp, B)
        elems = B * n * n
        nbytes = elems * 8 * 2 + 2 * n * n * 4
        flops = elems * 12  # sincos (2), 4 weight products, 6 rotation
        rows[kname] = dict(max_abs_err=max(errs), ms=device_ms(kern),
                           plain_ms=device_ms(plain), nbytes=nbytes,
                           flops=flops, library_ms=None)

    # K3: binary detector masks of the config, general masks, odd shape
    from repro_torch.core import diffraction as df
    from repro_torch.core.layers import Detector

    det = Detector(df.Grid(n, 36e-6), 10, 20, device=dev)
    errs = []
    k3_cases = [("32x200x200 detector masks", (B, n, n), det.masks_t),
                ("32x200x200 general masks", (B, n, n),
                 torch.randn((10, n, n), generator=gen).to(dev)),
                ("odd 37x53 general masks", (5, 37, 53),
                 torch.randn((10, 37, 53), generator=gen).to(dev))]
    for case, shape, masks in k3_cases:
        u = _cfield(shape, gen, dev)
        got = ops.intensity_readout_rows(u, masks)
        again = ops.intensity_readout_rows(u, masks)
        if not torch.equal(got, again):
            raise AssertionError("intensity_readout: repeated runs differ")
        errs.append(_compare("intensity_readout", case, got,
                             ref.intensity_readout_ref(u, masks)))
    us = [_cfield((B, n, n), gen, dev) for _ in range(8)]
    lib_want = ref.intensity_readout_ref(us[0], det.masks_t)
    lib_err = (_readout_einsum(us[0], det.masks_t) - lib_want).abs().max().item()
    lib_rel = lib_err / lib_want.abs().max().item()
    it = iter(range(10 ** 9))
    kern = lambda: ops.intensity_readout_rows(us[next(it) % 8], det.masks_t)  # noqa: E731
    plain = lambda: ref.intensity_readout_ref(us[next(it) % 8], det.masks_t)  # noqa: E731
    lib = lambda: _readout_einsum(us[next(it) % 8], det.masks_t)  # noqa: E731
    C = det.masks_t.shape[0]
    rows["intensity_readout"] = dict(
        max_abs_err=max(errs), ms=device_ms(kern), plain_ms=device_ms(plain),
        nbytes=B * n * n * 8 + C * n * n * 4 + B * C * 4,
        flops=B * n * n * (3 + 2 * C), library_ms=device_ms(lib))
    print(f"[kernels] intensity_readout library einsum (timed only, not "
          f"the port): max_abs_err {lib_err:.3e} rel {lib_rel:.3e} vs plain")
    for k, r in rows.items():
        t_bytes = r["nbytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["flops"] / F32_FLOP_PER_S * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        lib_txt = ("none" if r["library_ms"] is None
                   else f"{r['library_ms'] * 1e3:.2f} us")
        print(f"[kernels] {k}: {r['ms'] * 1e3:.2f} us/launch, plain "
              f"{r['plain_ms'] * 1e3:.2f} us, library {lib_txt}, bound "
              f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}: "
              f"{r['nbytes'] / 1e6:.2f} MB)")
    return rows


def _readout_einsum(u, masks):
    """K3's function as one library call (timed for comparison only; the
    port never calls it): sum_p masks[c, p] * (re^2 + im^2)."""
    r = torch.view_as_real(u).reshape(u.shape[0], -1, 2)
    return torch.einsum("bpk,bpk,cp->bc", r, r,
                        masks.reshape(masks.shape[0], -1))


def _digits(b, seed):
    return np.random.default_rng(seed).random((b, 28, 28), np.float32)


def phase_slice(dev, smi: str, profile) -> dict:
    cfg = dataclasses.replace(get_config("donn-mnist-5l"), use_pallas=True)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator().manual_seed(0))
    cpu_model = build_model(cfg, device="cpu")
    cpu_params = {"phase": {k: v.cpu() for k, v in params["phase"].items()}}
    variants = [("float32", False), ("bfloat16", False), ("int8", False),
                ("float32", True)]
    deps = {v: freeze(model, params, plane_dtype=v[0], rfft_first=v[1],
                      device=dev) for v in variants}
    engines = {v: InferenceEngine(d, buckets=(1, 8, 32), device=dev)
               for v, d in deps.items()}
    for eng in engines.values():
        eng.warmup()
    x32 = _digits(32, seed=7)
    singles = _digits(64, seed=8)

    # --- the serving path, counted: nothing else launches in this window
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    batches0 = {v: e.stats["batches"] for v, e in engines.items()}
    outs, mb_outs = {}, {}
    for v, eng in engines.items():
        outs[v] = eng.infer(x32)
        mb = MicroBatcher(eng, max_wait_ms=2.0)
        futs = [mb.submit(x) for x in singles]
        mb_outs[v] = np.stack([f.result(timeout=120) for f in futs])
        if not mb.close() or mb.stats["served"] != len(singles):
            raise AssertionError(f"MicroBatcher {v}: {mb.stats}")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    expect = dict.fromkeys(ops.KERNELS, 0)
    for v, eng in engines.items():
        nb = eng.stats["batches"] - batches0[v]
        rfft = v[1]
        expect["conj_phase_scale"] += 2 * (cfg.depth - rfft) * nb
        expect["phase_tf_apply"] += (1 + rfft) * nb
        expect["intensity_readout"] += nb
    print(f"[slice] serving-path launches {launches} (expected {expect})")
    if launches != expect or min(launches.values()) == 0:
        raise AssertionError("the serving path did not run every kernel")

    # --- hold every deployment against its CPU copy (plain versions)
    ref_f32 = None
    for v, out in outs.items():
        dep_cpu = freeze(cpu_model, cpu_params, plane_dtype=v[0],
                         rfft_first=v[1], device="cpu")
        want = dep_cpu.forward(torch.from_numpy(x32)).numpy()
        if out.shape != (32, cfg.num_classes) or not np.isfinite(out).all():
            raise AssertionError(f"{v}: bad logits {out.shape}")
        rel = np.max(np.abs(out - want)) / np.max(np.abs(want))
        mb_rel = (np.max(np.abs(mb_outs[v] - dep_cpu.forward(
            torch.from_numpy(singles)).numpy())) / np.max(np.abs(want)))
        same = bool(np.array_equal(out.argmax(-1), want.argmax(-1)))
        print(f"[slice] {v[0]} rfft_first={v[1]}: logits rel err vs CPU "
              f"{rel:.3e}, MicroBatcher {mb_rel:.3e} (tol {SLICE_RTOL:g}), "
              f"argmax equal {same}")
        if rel > SLICE_RTOL or mb_rel > SLICE_RTOL or not same:
            raise AssertionError(f"{v}: card and CPU disagree")
        if v == ("float32", False):
            ref_f32 = out
        elif v[1] is False:
            d = np.max(np.abs(out - ref_f32)) / np.max(np.abs(ref_f32))
            print(f"[slice] {v[0]} planes vs f32 on the card: rel {d:.3e}")

    # --- throughput and latency at bucket 32 (host clock; infer ends in
    # the device-to-host copy of the logits).  Each row is a closed loop of
    # WINDOW_S seconds after a warm-up, repeated REPEATS times with the rows
    # interleaved, so drift on the shared host reaches every row alike.
    plain_cfg = dataclasses.replace(cfg, use_pallas=False)
    plain_model = build_model(plain_cfg, device=dev)
    plain_eng = InferenceEngine(freeze(plain_model, params, device=dev),
                                buckets=(32,), device=dev)
    plain_eng.warmup()
    runs = [(f"{v[0]}{'+rfft' if v[1] else ''}", e)
            for v, e in engines.items()]
    runs.append(("float32 use_pallas=False (plain torch)", plain_eng))
    perf = {label: [] for label, _ in runs}
    for rep in range(REPEATS):
        for label, eng in runs:
            for _ in range(20):
                eng.infer(x32)
            lat = []
            t_end = time.perf_counter() + WINDOW_S
            while time.perf_counter() < t_end:
                t0 = time.perf_counter()
                eng.infer(x32)
                lat.append(time.perf_counter() - t0)
            lat_ms = np.asarray(lat) * 1e3
            r = dict(batches=len(lat), req_s=32 * len(lat) / float(np.sum(lat)),
                     p50_ms=float(np.percentile(lat_ms, 50)),
                     p99_ms=float(np.percentile(lat_ms, 99)))
            perf[label].append(r)
            print(f"[slice] {label} (repeat {rep + 1}/{REPEATS}): "
                  f"{r['req_s']:.1f} req/s at bucket 32 over {r['batches']} "
                  f"batches, per-batch p50 {r['p50_ms']:.4f} ms p99 "
                  f"{r['p99_ms']:.4f} ms ({smi})")
    for label, reps in perf.items():
        rps = [r["req_s"] for r in reps]
        print(f"[slice] {label}: req/s {min(rps):.1f}-{max(rps):.1f} across "
              f"{REPEATS} repeats (spread {max(rps) / min(rps) - 1:.1%})")
    if profile:
        p50 = min(r["p50_ms"] for r in perf["float32"])
        _profile(engines[("float32", False)], x32, profile, p50)
    return launches


def _profile(eng, x32, path: str, p50_ms: float) -> None:
    from torch.profiler import ProfilerActivity, profile

    for _ in range(20):
        eng.infer(x32)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_BATCHES):
            eng.infer(x32)
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    table = events.table(sort_by="cuda_time_total", row_limit=25)
    # device busy time: the self time of device-side events (kernels and
    # copies), which the host-side ops' totals would count twice
    busy_us = sum(getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0) for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    per_batch_us = busy_us / PROFILE_BATCHES
    wall_us = wall / PROFILE_BATCHES * 1e6
    table += (f"\n{PROFILE_BATCHES} batches: device busy {per_batch_us:.1f} "
              f"us per batch; wall {wall_us:.1f} us per batch under the "
              f"profiler (idle share {1 - per_batch_us / wall_us:.1%}), "
              f"unprofiled p50 {p50_ms * 1e3:.1f} us (idle share "
              f"{1 - per_batch_us / (p50_ms * 1e3):.1%})\n")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(table)
    print(table)


def phase_cli() -> None:
    rps = serve_donn.main(["--n", "200", "--depth", "5", "--distance",
                           "0.30", "--det-size", "20", "--use-pallas",
                           "--requests", "64", "--device", "cuda"])
    if not rps > 0:
        raise AssertionError("serve_donn served nothing")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", metavar="FILE", default=None,
                    help="write a torch.profiler table of the serving path")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    rows = phase_kernels(dev)
    launches = phase_slice(dev, smi, args.profile)
    phase_cli()
    kernels = []
    for name in ops.KERNELS:
        r = rows[name]
        source, replaces = KERNEL_META[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(f"[done] {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
