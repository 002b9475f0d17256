"""Batched LM serving launcher on the card: lockstep decode over slots.

The port of ``repro.launch.serve``: a fixed pool of decode slots; finished
sequences (length budget) are refilled at once from the request queue.
Requests are synthetic prompts from ``--seed``; prefill runs through the
decode path token by token, and one position counter is shared by every
slot (the reference's lockstep demo: a request admitted after the first
wave starts emitting at once).  Parameters are random, drawn on the device
from a ``torch.Generator`` seeded with ``--seed``.

Every registered architecture serves; vlm with the zero vision K/V cache
of ``lm.init_cache``, as the reference's launcher does.  The flags are the
reference's.  ``--mesh`` takes only ``1x1``: LM tensor parallelism is
ROADMAP queue 1, item 5; the DONN mesh is
``repro_torch.runtime.sharding``.  ``--device`` defaults to the CUDA
card.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \
      --slots 8 --requests 24 --prompt-len 16 --max-new 32
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import get_config, lm
from repro_torch.runtime import steps as steps_mod


def serve_requests(cfg, params, *, slots: int, requests: int,
                   prompt_len: int, max_new: int, cache_len: int, seed: int,
                   device) -> dict:
    """The reference's lockstep slot loop over ``requests`` synthetic
    prompts.  Returns ``served_tokens``, ``completed`` (request ids in
    completion order), ``outputs`` ({request id: greedy tokens}), ``steps``
    and ``seconds`` (host clock; each step ends in the argmax's copy to
    the host)."""
    dev = resolve_device(device)
    step_fn = steps_mod.make_decode_step(cfg)
    cache = lm.init_cache(cfg, slots, cache_len, device=dev)
    rng = np.random.default_rng(seed)
    queue = [rng.integers(0, cfg.vocab, size=prompt_len).astype(np.int32)
             for _ in range(requests)]
    slot_state = [None] * slots  # [request_id, tokens, emitted]
    completed, served_tokens = [], 0
    outputs = {}
    next_req = 0
    pos = 0
    current = np.zeros((slots, 1), np.int64)
    t0 = time.perf_counter()
    with torch.no_grad():
        while len(completed) < requests and pos < cache_len - 1:
            for s in range(slots):
                if slot_state[s] is None and next_req < requests:
                    slot_state[s] = [next_req, list(queue[next_req]), 0]
                    outputs[next_req] = []
                    current[s, 0] = slot_state[s][1][0]
                    next_req += 1
            logits, cache = step_fn(params, cache,
                                    torch.tensor(current, device=dev), pos)
            nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
            for s in range(slots):
                st = slot_state[s]
                if st is None:
                    continue
                rid, toks, _ = st
                consumed = pos + 1
                if consumed < len(toks):  # still prefill: next prompt token
                    current[s, 0] = toks[min(consumed, len(toks) - 1)]
                else:
                    current[s, 0] = int(nxt[s])
                    outputs[rid].append(int(nxt[s]))
                    st[2] += 1
                    served_tokens += 1
                    if st[2] >= max_new:
                        completed.append(rid)
                        slot_state[s] = None
            pos += 1
    return {"served_tokens": served_tokens, "completed": completed,
            "outputs": outputs, "steps": pos,
            "seconds": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.mesh != "1x1":
        raise NotImplementedError(
            f"--mesh {args.mesh}: multi-device LM serving (tensor "
            "parallelism) is not ported yet (ROADMAP queue 1, item 5)"
        )
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(args.seed))
    res = serve_requests(cfg, params, slots=args.slots,
                         requests=args.requests, prompt_len=args.prompt_len,
                         max_new=args.max_new, cache_len=args.cache_len,
                         seed=args.seed, device=dev)
    dt, served_tokens = res["seconds"], res["served_tokens"]
    print(f"[serve] {len(res['completed'])}/{args.requests} requests, "
          f"{served_tokens} tokens in {dt:.2f}s "
          f"({served_tokens / max(dt, 1e-9):.1f} tok/s, "
          f"{args.slots} slots, mesh {args.mesh})")
    return served_tokens


if __name__ == "__main__":
    main()
