#!/usr/bin/env python3
"""Reproduce and localize the fused-hop mismatch at 37x53 on the card.

    python3 scripts/hop_fault.py [--loops 200] [--random 200] [--fresh 20]
                                 [--pytest-runs 5] [--out FILE]

``tests/test_torch_device.py::test_wrappers_launch_kernels_never_plain_versions``
holds ``ops.fused_spectral_hop`` at x (4, 3, 37, 53) on the card against
the same call on CPU copies (max|card - cpu| <= 1e-5 max|cpu|).  This
script runs that comparison on the test's own inputs:

1. ``loops`` times in one process, through the public call and stage by
   stage (cuFFT ``fft2`` at 37x53, K1 ``conj_phase_scale`` alone against
   its plain version on the same card input, the whole
   ``_fused_hop_planes``), recording each stage's error against the CPU
   chain and whether the card's output is bitwise the first iteration's;
2. the same with a second thread running cuFFT and K1 at 32x200x200
   beside it (what a serving worker does);
3. ``random`` fresh inputs of the test's shape and distribution: the
   spread of the error over inputs;
4. ``fresh`` new processes, each computing the test's hop once;
5. ``pytest-runs`` runs of the CUDA-only test file;
6. ``poison`` iterations with the caching allocator's free blocks filled
   with NaN before each hop, with cuFFT's plan cache on and off: cuFFT
   plans 37 and 53 (primes above 7) with Bluestein's algorithm, and
   PyTorch hands each execution a fresh work area from the allocator, so
   a plan that kept state in its work area would read the NaNs;
7. the CPU side at 1, 2, 4 and 8 threads (its FFT library may split the
   work differently).

It prints one JSON summary line last and writes the per-iteration record
to ``--out``.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402

TOL = 1e-5


def _rel(got, want) -> float:
    got, want = got.detach().cpu(), want.detach().cpu()
    return float((got - want).abs().max() / want.abs().max())


def test_inputs(dev, gen=None):
    """The inputs of the CUDA-only test (seed 0), or fresh ones from
    ``gen`` with the same shapes and distributions."""
    gen = gen or torch.Generator().manual_seed(0)
    shape = (4, 3, 37, 53)
    x = torch.complex(torch.randn(shape, generator=gen),
                      torch.randn(shape, generator=gen)).to(dev)
    th = torch.rand((3, 37, 53), generator=gen).to(dev) * 6.0
    amp = torch.rand((3, 37, 53), generator=gen).to(dev)
    return x, th, amp


def _digest(t) -> str:
    return hashlib.sha256(t.detach().cpu().numpy().tobytes()).hexdigest()[:16]


def stages(x, th, amp):
    """The hop's stages on x's device, plane-major as ``_apply_stacked``
    runs them: s = fft2, t = K1(s), w = fft2(t), o = K1(w), and the plain
    version of each K1 on the same input."""
    x3, B, lead, squeeze = ops._plane_major(x, (3,), 37, 53)
    nb = B
    s = torch.fft.fft2(x3)
    t = ops.conj_phase_scale(s, th, amp, nb, -1.0, 1.0)
    t_plain = ref.conj_phase_scale_ref(s, th, amp, nb, -1.0, 1.0)
    w = torch.fft.fft2(t)
    o = ops.conj_phase_scale(w, th, amp, nb, 1.0, 1.0 / (37 * 53))
    o_plain = ref.conj_phase_scale_ref(w, th, amp, nb, 1.0, 1.0 / (37 * 53))
    fused = ops._fused_hop_planes(x3, (th, amp, th, amp), nb)
    return {"x3": x3, "fft2_1": s, "k1_1": t, "k1_1_plain": t_plain,
            "fft2_2": w, "k1_2": o, "k1_2_plain": o_plain, "fused": fused}


def cpu_chain(x, th, amp):
    """The same stages on CPU copies (plain versions, pocketfft/MKL)."""
    return stages(x.cpu(), th.cpu(), amp.cpu())


def stage_errors(card, cpu) -> dict:
    return {
        "fft2_1 vs cpu": _rel(card["fft2_1"], cpu["fft2_1"]),
        "k1_1 vs plain (card input)": _rel(card["k1_1"], card["k1_1_plain"]),
        "k1_1 vs cpu": _rel(card["k1_1"], cpu["k1_1"]),
        "fft2_2 vs cpu": _rel(card["fft2_2"], cpu["fft2_2"]),
        "k1_2 vs plain (card input)": _rel(card["k1_2"], card["k1_2_plain"]),
        "k1_2 vs cpu": _rel(card["k1_2"], cpu["k1_2"]),
        "fused vs cpu": _rel(card["fused"], cpu["fused"]),
    }


def loop(dev, n: int, background: bool) -> dict:
    x, th, amp = test_inputs(dev)
    want = ops.fused_spectral_hop(x.cpu(), th.cpu(), amp.cpu(), th.cpu(),
                                  amp.cpu())
    cpu = cpu_chain(x, th, amp)
    stop = threading.Event()
    worker = None
    if background:
        def busy():
            g = torch.Generator().manual_seed(7)
            u = torch.complex(torch.randn((32, 200, 200), generator=g),
                              torch.randn((32, 200, 200), generator=g)).to(dev)
            p = torch.rand((1, 200, 200), generator=g).to(dev)
            while not stop.is_set():
                ops.conj_phase_scale(torch.fft.fft2(u), p, p, 32, -1.0, 1.0)
                torch.cuda.synchronize()
        worker = threading.Thread(target=busy, daemon=True)
        worker.start()
    rels, digests, worst = [], [], {}
    misses = []
    try:
        for i in range(n):
            got = ops.fused_spectral_hop(x, th, amp, th, amp)
            card = stages(x, th, amp)
            torch.cuda.synchronize()
            rel = _rel(got, want)
            rels.append(rel)
            digests.append(_digest(got))
            errs = stage_errors(card, cpu)
            for k, v in errs.items():
                worst[k] = max(worst.get(k, 0.0), v)
            if rel > TOL or errs["fused vs cpu"] > TOL:
                misses.append({"iteration": i, "public": rel, **errs})
    finally:
        stop.set()
        if worker is not None:
            worker.join(timeout=60)
    srt = sorted(rels)
    return {
        "iterations": n, "background_thread": background,
        "misses": len(misses), "miss_records": misses[:20],
        "rel_min": srt[0], "rel_median": srt[len(srt) // 2],
        "rel_max": srt[-1], "distinct_outputs": len(set(digests)),
        "worst_stage_errors": worst,
    }


def random_inputs(dev, n: int) -> dict:
    gen = torch.Generator().manual_seed(99)
    rels = []
    for _ in range(n):
        x, th, amp = test_inputs(dev, gen)
        got = ops.fused_spectral_hop(x, th, amp, th, amp)
        want = ops.fused_spectral_hop(x.cpu(), th.cpu(), amp.cpu(),
                                      th.cpu(), amp.cpu())
        rels.append(_rel(got, want))
    srt = sorted(rels)
    return {"draws": n, "misses": sum(r > TOL for r in rels),
            "rel_min": srt[0], "rel_median": srt[len(srt) // 2],
            "rel_p99": srt[int(0.99 * (len(srt) - 1))], "rel_max": srt[-1]}


def poisoned(dev, n: int, plan_cache: bool) -> dict:
    """The test's hop with NaN in every block the allocator hands out."""
    x, th, amp = test_inputs(dev)
    want = ops.fused_spectral_hop(x.cpu(), th.cpu(), amp.cpu(), th.cpu(),
                                  amp.cpu())
    cache = torch.backends.cuda.cufft_plan_cache[dev.index]
    old = cache.max_size
    cache.clear()
    cache.max_size = old if plan_cache else 0
    rels, digests = [], []
    try:
        for _ in range(n):
            junk = [torch.full((1 << k,), float("nan"), device=dev)
                    for k in range(8, 24) for _ in range(2)]
            del junk  # back to the allocator's cache, NaN inside
            got = ops.fused_spectral_hop(x, th, amp, th, amp)
            torch.cuda.synchronize()
            rels.append(_rel(got, want))
            digests.append(_digest(got))
    finally:
        cache.max_size = old
    return {"iterations": n, "plan_cache": plan_cache,
            "misses": sum(not r <= TOL for r in rels),
            "rel_max": max(rels), "distinct_outputs": len(set(digests))}


def cpu_threads() -> dict:
    """Digest of the CPU hop (the test's reference side) per thread count."""
    x, th, amp = test_inputs(torch.device("cpu"))
    before = torch.get_num_threads()
    out = {}
    try:
        for n in (1, 2, 4, 8):
            torch.set_num_threads(n)
            out[n] = _digest(ops.fused_spectral_hop(x, th, amp, th, amp))
    finally:
        torch.set_num_threads(before)
    return {"digests": out, "distinct": len(set(out.values()))}


def child() -> None:
    dev = torch.device("cuda", 0)
    x, th, amp = test_inputs(dev)
    got = ops.fused_spectral_hop(x, th, amp, th, amp)
    want = ops.fused_spectral_hop(x.cpu(), th.cpu(), amp.cpu(), th.cpu(),
                                  amp.cpu())
    print(json.dumps({"rel": _rel(got, want), "digest": _digest(got),
                      "cpu_digest": _digest(want)}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--loops", type=int, default=200)
    ap.add_argument("--random", type=int, default=200)
    ap.add_argument("--fresh", type=int, default=20)
    ap.add_argument("--pytest-runs", type=int, default=5)
    ap.add_argument("--poison", type=int, default=50)
    ap.add_argument("--out", default="chiprun_out/hop_fault.json")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("hop_fault: needs a CUDA card")
    if args.child:
        child()
        return 0
    dev = torch.device("cuda", 0)
    print(f"[hop] {torch.cuda.get_device_name(0)} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    out = {"device": torch.cuda.get_device_name(0)}
    if args.loops:
        out["loop"] = loop(dev, args.loops, background=False)
        print("[hop] loop", json.dumps(out["loop"])[:2000], flush=True)
        out["loop_with_worker"] = loop(dev, args.loops, background=True)
        print("[hop] loop with a worker thread",
              json.dumps(out["loop_with_worker"])[:2000], flush=True)
    if args.random:
        out["random"] = random_inputs(dev, args.random)
        print("[hop] random inputs", json.dumps(out["random"]), flush=True)
    if args.fresh:
        fresh = []
        for _ in range(args.fresh):
            p = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--child"], capture_output=True, text=True,
                               timeout=300, check=True)
            fresh.append(json.loads(p.stdout.strip().splitlines()[-1]))
        out["fresh"] = {
            "processes": len(fresh),
            "misses": sum(f["rel"] > TOL for f in fresh),
            "rel_max": max(f["rel"] for f in fresh),
            "distinct_outputs": len({f["digest"] for f in fresh}),
            "distinct_cpu_outputs": len({f["cpu_digest"] for f in fresh})}
        print("[hop] fresh processes", json.dumps(out["fresh"]), flush=True)
    runs = []
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for _ in range(args.pytest_runs):
        p = subprocess.run([sys.executable, "-m", "pytest", "-q", "-x",
                            "-p", "no:cacheprovider",
                            os.path.join(ROOT, "tests", "test_torch_device.py")],
                           capture_output=True, text=True, timeout=900,
                           env=env, cwd=ROOT)
        runs.append({"rc": p.returncode,
                     "tail": p.stdout.strip().splitlines()[-1:]})
    if runs:
        out["pytest"] = runs
        print("[hop] pytest runs", json.dumps(runs), flush=True)
    if args.poison:
        for plan_cache in (True, False):
            key = f"poisoned_plan_cache_{'on' if plan_cache else 'off'}"
            out[key] = poisoned(dev, args.poison, plan_cache)
            print(f"[hop] {key}", json.dumps(out[key]), flush=True)
    out["cpu_threads"] = cpu_threads()
    print("[hop] cpu threads", json.dumps(out["cpu_threads"]), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({k: v for k, v in out.items() if k != "pytest"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
