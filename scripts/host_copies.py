"""Host <-> card copy rates on the CUDA card: pageable against pinned.

    python3 scripts/host_copies.py [--gb G] [--reps R]

Times, on the host clock around a synchronize, over R copies of a G GB
float32 tensor: card -> host into a new pageable tensor (``t.to("cpu")``,
what ``chip_smoke.py``'s CPU copies do), card -> host into a pinned
buffer, host -> card from a pageable and from a pinned tensor, a host
memcpy, and allocating the pinned buffer.  Prints GB/s with the card's
name; needs a CUDA card.
"""
import argparse
import time

import torch


def _seconds(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--gb", type=float, default=2.0)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    n = int(args.gb * 1e9) // 4
    dev = torch.device("cuda", 0)
    t = torch.randn(n, device=dev)
    page = torch.randn(n)
    other = torch.empty(n)
    t0 = time.perf_counter()
    pinned = torch.empty(n, pin_memory=True)
    pin_s = time.perf_counter() - t0
    rows = {
        "card -> pageable (t.to('cpu'))": _seconds(lambda: t.to("cpu"),
                                                   args.reps),
        "card -> pinned": _seconds(lambda: pinned.copy_(t), args.reps),
        "pageable -> card": _seconds(lambda: page.to(dev), args.reps),
        "pinned -> card": _seconds(lambda: t.copy_(pinned), args.reps),
        "host memcpy": _seconds(lambda: other.copy_(page), args.reps),
    }
    gb = n * 4 / 1e9
    print(f"{torch.cuda.get_device_name(0)}, {gb:.2f} GB float32, "
          f"{torch.get_num_threads()} host threads: "
          + ", ".join(f"{k} {gb / v:.2f} GB/s" for k, v in rows.items())
          + f"; pinning the buffer {pin_s:.3f} s", flush=True)


if __name__ == "__main__":
    main()
