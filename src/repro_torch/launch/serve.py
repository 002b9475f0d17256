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
reference's, plus ``--device`` (the CUDA card by default).

``--mesh DxM`` serves over a ``(data, model)`` mesh of D*M ranks
(``runtime.steps.compile_decode_step``): every rank holds its blocks of
the parameters (drawn leaf by leaf) and of the cache, decodes its
``vocab`` part of the logits, and the greedy token is the argmax reduced
over ``model`` (the first maximum of the whole vocabulary, as one rank
picks it), gathered over ``data``.  Any ``DxM`` serves every config: a
dim that does not divide over ``model`` (heads, ``d_ff``, vocabulary,
``d_inner``, experts) runs whole on every ``model`` rank, as the
reference replicates it.  Without a process group the launcher
spawns its ranks: one a card under NCCL when there are D*M cards, else
gloo ranks sharing the card (it says which), gloo ranks on the CPU.

Example:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-4b \
      --slots 8 --requests 24 --prompt-len 16 --max-new 32 [--mesh 1x2]
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.models import get_config, lm
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import steps as steps_mod
from repro_torch.runtime.collectives import all_gather_dim


def parse_mesh(text: str) -> tuple:
    """``"DxM"`` -> (D, M)."""
    try:
        data, model = (int(x) for x in text.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {text!r}: expected DATAxMODEL, e.g. 2x2"
                         ) from None
    if data < 1 or model < 1:
        raise ValueError(f"--mesh {text!r}: both degrees must be >= 1")
    return data, model


def rank_backend(world: int, dev: torch.device) -> tuple:
    """(backend, what the ranks run on) of ``world`` spawned ranks."""
    if dev.type != "cuda":
        return "gloo", f"{world} gloo ranks on the CPU"
    if torch.cuda.device_count() >= world:
        return "nccl", f"{world} NCCL ranks, one card each"
    return "gloo", (f"{world} gloo ranks sharing {torch.cuda.device_count()}"
                    " card(s), collectives staged through the host")


def spawn_mesh(rank_fn, world: int, argv, device, tag: str):
    """Run ``rank_fn(rank, argv)`` on ``world`` spawned ranks (NCCL, one
    card each, when there are enough cards; else gloo) and return rank
    0's result; a rank's ``SystemExit`` code becomes the launcher's."""
    from repro_torch.runtime.collectives import spawn_ranks

    dev = torch.device("cuda" if device is None else device)
    backend, what = rank_backend(world, dev)
    print(f"[{tag}] mesh of {what}", flush=True)
    out = spawn_ranks(rank_fn, world, (list(argv),), device_type=dev.type,
                      backend=backend, timeout=24 * 3600.0)
    codes = [r[1] for r in out if r[0] == "exit"]
    if codes:
        sys.exit(codes[0])
    return out[0][1]


def run_rank(main, argv) -> tuple:
    """A spawned rank's ``main(argv)``: ("ok", its result) or ("exit", the
    code of its ``SystemExit``)."""
    try:
        return ("ok", main(argv))
    except SystemExit as e:
        return ("exit", e.code)


def greedy_tokens(logits: torch.Tensor, mesh, batch: int,
                  vocab: int) -> np.ndarray:
    """The argmax over the whole vocabulary of each row of ``logits``
    (B, V) as numpy, every rank alike.  On a mesh ``logits`` is this
    rank's block (``steps.logits_sharding``): where it holds a part of the
    ``vocab`` the argmax is reduced over ``model`` (the first maximum, as
    one rank's ``argmax``); the rows are gathered over ``data``."""
    idx = torch.argmax(logits, dim=-1)
    if mesh is None:
        return idx.cpu().numpy()
    sizes = shd.mesh_shape(mesh)
    g_model = (shd.axes_group(mesh, "model")
               if logits.shape[-1] < vocab else None)
    if g_model is not None:  # one gather of (max, its vocabulary index)
        lo = shd.axes_index(mesh, "model")[0] * logits.shape[-1]
        val = torch.gather(logits, -1, idx[:, None])[:, 0].double()
        both = all_gather_dim(torch.stack([val, (idx + lo).double()])[None],
                              g_model, 0)  # (model, 2, B)
        best = torch.argmax(both[:, 0], dim=0)  # the first rank's max
        idx = torch.gather(both[:, 1], 0, best[None])[0].long()
    if sizes["data"] > 1 and idx.shape[0] != batch:
        idx = all_gather_dim(idx.contiguous(), shd.axes_group(mesh, "data"),
                             0)
    return idx.cpu().numpy()


def serve_requests(cfg, params, *, slots: int, requests: int,
                   prompt_len: int, max_new: int, cache_len: int, seed: int,
                   device, mesh=None) -> dict:
    """The reference's lockstep slot loop over ``requests`` synthetic
    prompts.  Returns ``served_tokens``, ``completed`` (request ids in
    completion order), ``outputs`` ({request id: greedy tokens}), ``steps``
    and ``seconds`` (host clock; each step ends in the argmax's copy to
    the host).  With a ``mesh`` of more than one rank ``params`` are this
    rank's blocks (``steps.compile_decode_step``'s placement) and every
    rank runs the loop alike."""
    dev = resolve_device(device)
    step_fn, _, c_place, cspecs = steps_mod.compile_decode_step(
        cfg, mesh, slots, cache_len, device=dev)
    if isinstance(c_place, torch.device):
        mesh = None
        cache = lm.init_cache(cfg, slots, cache_len, device=dev)
    else:
        cache = shd.sharded_zeros(cspecs, mesh, device=dev)
        tok_place = shd.batch_sharding(mesh, 2, batch_size=slots)
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
            toks = torch.tensor(current, device=dev)
            if mesh is not None:
                toks = shd.local_block(toks, tok_place, mesh)
            logits, cache = step_fn(params, cache, toks, pos)
            nxt = greedy_tokens(logits[:, 0], mesh, slots, cfg.vocab)
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
    data, model = parse_mesh(args.mesh)
    if data * model > 1 and not dist.is_initialized():
        return spawn_mesh(_rank, data * model,
                          sys.argv[1:] if argv is None else argv,
                          args.device, "serve")
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    mesh = (shd.make_mesh_2d(data, model, device=dev)
            if data * model > 1 else None)
    rank0 = mesh is None or dist.get_rank() == 0
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                     mesh=mesh)
    res = serve_requests(cfg, params, slots=args.slots,
                         requests=args.requests, prompt_len=args.prompt_len,
                         max_new=args.max_new, cache_len=args.cache_len,
                         seed=args.seed, device=dev, mesh=mesh)
    dt, served_tokens = res["seconds"], res["served_tokens"]
    if rank0:
        print(f"[serve] {len(res['completed'])}/{args.requests} requests, "
              f"{served_tokens} tokens in {dt:.2f}s "
              f"({served_tokens / max(dt, 1e-9):.1f} tok/s, "
              f"{args.slots} slots, mesh {args.mesh})", flush=True)
    return served_tokens


def _rank(rank, argv):
    return run_rank(main, argv)


if __name__ == "__main__":
    main()
