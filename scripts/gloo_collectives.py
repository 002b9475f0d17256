"""Latency of one small all-reduce between gloo ranks sharing one card.

    python3 scripts/gloo_collectives.py [--elems N] [--reps R]

Spawns 2, then 4 gloo ranks on the CUDA card (``spawn_ranks``) and times,
on each rank's host clock over R calls after a warm-up: ``all_reduce`` of
a CUDA tensor of N float32 (the LM decode's exit sum at 8 slots of
qwen1.5-4b is 8 x 2560), the same tensor staged through the host by hand
(``.cpu()``, a CPU all-reduce, a copy back), a CPU tensor's all-reduce
(gloo alone) and a bare ``torch.cuda.synchronize``.
Prints rank 0's numbers with the card's name; needs a CUDA card.
"""
import argparse
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, "src")

from repro_torch.runtime.collectives import spawn_ranks  # noqa: E402


def _rank(rank, n, reps):
    torch.set_num_threads(1)
    dev = torch.device("cuda", torch.cuda.current_device())
    x = torch.randn(n, device=dev)
    xc = torch.randn(n)

    def ms(fn):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    def staged():
        h = x.cpu()
        dist.all_reduce(h)
        x.copy_(h)

    return {"cuda all_reduce": ms(lambda: dist.all_reduce(x)),
            "staged by hand": ms(staged),
            "cpu all_reduce": ms(lambda: dist.all_reduce(xc)),
            "synchronize": ms(torch.cuda.synchronize)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--elems", type=int, default=8 * 2560)
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    name = torch.cuda.get_device_name(0)
    for world in (2, 4):
        res = spawn_ranks(_rank, world, (args.elems, args.reps),
                          device_type="cuda", backend="gloo", timeout=600)
        print(f"{world} gloo ranks sharing {name}, {args.elems} float32: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in res[0].items()),
              flush=True)


if __name__ == "__main__":
    main()
