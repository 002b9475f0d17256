"""Multi-pod dry-run: the cost of one step of a cell on the production
mesh, traced without allocating (port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell on 512 fake XLA host devices
and reads the compiled HLO.  The port traces the step of **rank 0**:

- a fake process group of 256 or 512 ranks
  (``torch.testing._internal.distributed.fake_pg``; its collectives
  return at once and move nothing) and the production ``DeviceMesh`` on
  it (``launch.mesh.make_production_mesh``);
- rank 0's blocks of the state and the batch as zeros under
  ``FakeTensorMode`` (shapes, dtypes and devices, no memory;
  ``local_zeros``);
- the step that the card runs, made by the step compilers
  (``compile_train_step`` with the cell's overrides,
  ``compile_prefill_step``, ``compile_decode_step``,
  ``compile_donn_train_step_shardmap``), never the launchers, which read
  losses on the host;
- ``runtime.cost_analysis.count`` over the one call: FLOPs, HBM bytes and
  collective bytes per device, and the peak live bytes of the device.

Each record has the reference's keys (``tests/test_artifacts.py``):
``fits_16GiB_hbm`` is ``fits_hbm``, against the card's
``launch.mesh.HBM_PER_DEVICE``; ``xla_cost_raw`` has no counterpart;
``compile_wall_s`` is the trace's seconds.  The three roofline terms are
the counts over the card's datasheet rates (``launch.mesh``), and
``roofline_fraction`` the model FLOPs' share of the larger.

The trace's device is the CUDA card (fake CUDA tensors: the program the
card runs) unless ``--device cpu``.  A cell whose config routes a fake
tensor into a hand-written kernel raises (``kernels.ops``).

  python -m repro_torch.launch.dryrun --arch qwen1.5-4b --shape train_4k \\
      --mesh both [--smoke] [--device cpu] [--out DIR]
  python -m repro_torch.launch.dryrun --all --smoke --device cpu
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import pathlib
import sys
import time

import torch
import torch.distributed as dist

from repro_torch.configs import DONN_ARCHS, LM_ARCHS
from repro_torch.core.config import DONNConfig
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.specs import (
    cell_status, get_config, input_specs, shapes_for,
)
from repro_torch.models import lm
from repro_torch.nn import param_count
from repro_torch.runtime import sharding as shd
from repro_torch.runtime import steps as steps_mod
from repro_torch.runtime.cost_analysis import count
from repro_torch.tree import tree_map

# Per-cell memory-feasibility overrides, the reference's (keyed (arch,
# shape, multi_pod)): microbatched gradient accumulation and/or
# reduced-precision optimizer state for the cells whose exact-f32
# footprint exceeds the reference's per-device memory on one pod.
OVERRIDES = {
    ("mixtral-8x7b", "train_4k", False): dict(accum_steps=2),
    ("mixtral-8x7b", "train_4k", True): dict(accum_steps=2),
    ("llama-3.2-vision-11b", "train_4k", False): dict(
        accum_steps=8, state_dtype=torch.bfloat16,
        param_dtype=torch.bfloat16,
    ),
    ("llama-3.2-vision-11b", "train_4k", True): dict(accum_steps=2),
    ("recurrentgemma-9b", "train_4k", False): dict(accum_steps=2),
    ("arctic-480b", "train_4k", False): dict(
        accum_steps=8, param_dtype=torch.bfloat16,
        state_dtype=torch.bfloat16, accum_dtype=torch.bfloat16,
    ),
    ("arctic-480b", "train_4k", True): dict(accum_steps=4),
}

# Inference-side overrides: serving holds bf16 params (no f32 masters).
PREFILL_OVERRIDES = {
    ("arctic-480b", "prefill_32k"): dict(param_dtype=torch.bfloat16),
}


def override_names(over: dict) -> dict:
    """An overrides dict as the record writes it (dtypes by name)."""
    return {k: str(v).removeprefix("torch.") for k, v in over.items()}


# ----------------------------------------------------------- model flops
def lm_model_flops(cfg, kind: str, cell) -> tuple:
    """(N_total, N_active, MODEL_FLOPS) for the 6ND convention."""
    n = param_count(lm.param_specs(cfg))
    n_active = n
    if cfg.family == "moe":
        f = cfg.expert_d_ff or cfg.d_ff
        expert_params = cfg.n_layers * cfg.n_experts * 3 * cfg.d_model * f
        n_active = n - expert_params * (cfg.n_experts - cfg.top_k) / \
            cfg.n_experts
    tokens = {
        "train": cell.global_batch * cell.seq_len,
        "prefill": cell.global_batch * cell.seq_len,
        "decode": cell.global_batch,  # one new token per sequence
    }[kind]
    mult = 6.0 if kind == "train" else 2.0
    return n, n_active, mult * n_active * tokens


def donn_model_flops(cfg: DONNConfig, batch: int) -> tuple:
    """FFT2+iFFT2+ComplexMM per layer, x3 for fwd+bwd (train)."""
    n = cfg.n
    fft2 = 10.0 * n * n * math.log2(max(n, 2))  # ~5 N log N a 1-D line
    per_layer = 2.0 * fft2 + 6.0 * n * n  # FFT2 + iFFT2 + complex multiply
    hops = cfg.depth + 1
    chans = max(cfg.channels, 1)
    n_params = cfg.depth * n * n * chans
    flops = 3.0 * batch * chans * hops * per_layer  # train: fwd + ~2x bwd
    return n_params, n_params, flops


# ------------------------------------------------------- the fake world
@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks in which this process is
    rank 0, destroyed on exit.  One group a process: raises when one is
    up."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised in this "
                           "process; run the dry-run in a process of its "
                           "own")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def local_zeros(specs, places, mesh, device):
    """This rank's zero block of every leaf of ``specs`` (anything with a
    ``shape`` and a ``dtype``) under the spec tree ``places``; whole
    leaves where ``places`` is a device (one rank)."""
    if isinstance(places, torch.device):
        return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                              device=device), specs)
    return tree_map(lambda s, p: torch.zeros(
        shd.block_shape(s.shape, p, mesh), dtype=s.dtype, device=device),
        specs, places)


def _trace(fn, make_args, device):
    """``count`` of ``fn`` on the trees ``make_args()`` builds, all under
    ``FakeTensorMode``; real tensors built before it (a DONN plan's
    transfer functions) enter as constants."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        return count(fn, *make_args(), device=device)


def trace_donn_step(fn, sspecs, s_place, batch_specs, b_place, mesh,
                    device):
    """The cost of one step of a compiled DONN step ``fn`` on fake blocks,
    after one real step on zero blocks: the plan uploads its
    transfer-function planes at their first use, which the trace must
    neither count as the step's traffic nor cache as fake tensors."""
    def blocks():
        return (local_zeros(sspecs, s_place, mesh, device),
                local_zeros(batch_specs, b_place, mesh, device))

    fn(*blocks())
    return _trace(fn, blocks, device=device)


def trace_train_step(cfg, batch_specs: dict, mesh=None, device=None,
                     **step_kw):
    """The cost of one ``compile_train_step`` step of ``cfg`` on fake
    blocks of a train state (moments present) and a batch
    (``batch_specs``: name -> shape and dtype)."""
    dev = resolve_device(device)
    fn, s_place, b_place, sspecs = steps_mod.compile_train_step(
        cfg, mesh, batch_specs, device=dev, **step_kw)
    return _trace(fn, lambda: (local_zeros(sspecs, s_place, mesh, dev),
                               local_zeros(batch_specs, b_place, mesh, dev)),
                  device=dev)


# ------------------------------------------------------------- one cell
def _cell_cost(cfg, cell, kind, specs, mesh, dev, over: dict):
    if isinstance(cfg, DONNConfig):
        # production DONN path: data parallel, local FFTs
        from repro_torch.runtime.donn_steps import (
            compile_donn_train_step_shardmap,
        )

        fn, s_ps, b_ps, sspecs = compile_donn_train_step_shardmap(
            cfg, mesh, global_batch=cell.global_batch, device=dev)
        return trace_donn_step(fn, sspecs, s_ps, specs, b_ps, mesh, dev)
    if kind == "train":
        return trace_train_step(cfg, specs, mesh, dev, **over)
    if kind == "prefill":
        fn, p_place, b_place, pspecs = steps_mod.compile_prefill_step(
            cfg, mesh, specs, device=dev, **over)
        return _trace(fn, lambda: (local_zeros(pspecs, p_place, mesh, dev),
                                   local_zeros(specs, b_place, mesh, dev)),
                      device=dev)
    fn, p_place, c_place, cspecs = steps_mod.compile_decode_step(
        cfg, mesh, cell.global_batch, cell.seq_len, device=dev)
    tok = shd.batch_sharding(mesh, 2, batch_size=cell.global_batch)
    pos = cell.seq_len - 1  # the cache's last slot: attention over all of it
    return _trace(
        lambda p, c, t: fn(p, c, t, pos),
        lambda: (local_zeros(lm.param_specs(cfg), p_place, mesh, dev),
                 local_zeros(cspecs, c_place, mesh, dev),
                 torch.zeros(shd.block_shape(specs["tokens"].shape, tok,
                                              mesh),
                             dtype=torch.int32, device=dev)),
        device=dev)


def roofline(cost, model_flops: float, chips: int) -> dict:
    """The three terms of one step on the card's rates, the dominant one
    and the model FLOPs' share of the bound."""
    terms = {"compute_s": cost.flops / mesh_mod.PEAK_FLOPS_BF16,
             "memory_s": cost.bytes / mesh_mod.HBM_BW,
             "collective_s": cost.collective_bytes / mesh_mod.LINK_BW}
    bound_s = max(terms.values())
    return {
        "terms": terms, "dominant": max(terms, key=terms.get),
        "bound_s": bound_s,
        "roofline_fraction": (
            (model_flops / chips / mesh_mod.PEAK_FLOPS_BF16) / bound_s
            if bound_s > 0 else 0.0),
    }


def memory_record(cost) -> dict:
    per_dev = cost.peak_bytes
    return {
        "argument_bytes": cost.argument_bytes,
        "output_bytes": cost.output_bytes,
        "temp_bytes": per_dev - cost.argument_bytes,
        "alias_bytes": cost.alias_bytes,
        "per_device_bytes": per_dev,
        "fits_hbm": bool(per_dev <= mesh_mod.HBM_PER_DEVICE),
    }


def run_cell(arch: str, shape: str, multi_pod: bool, smoke: bool = False,
             device=None) -> dict:
    """The record of one cell on the production mesh; the process group
    must be a (fake) group of the mesh's 256 or 512 ranks."""
    t0 = time.time()
    mesh_name = "pod2-512" if multi_pod else "pod1-256"
    cfg, cell, kind, specs = input_specs(arch, shape, smoke=smoke)
    rec = {
        "arch": arch, "shape": shape, "kind": kind, "mesh": mesh_name,
        "seq_len": cell.seq_len, "global_batch": cell.global_batch,
    }
    skip = cell_status(cfg, cell)
    if skip:
        rec["status"] = skip
        return rec

    dev = resolve_device(device)
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod, device=dev)
    chips = math.prod(shd.mesh_shape(mesh).values())
    is_donn = isinstance(cfg, DONNConfig)
    over = {}
    if not is_donn and kind == "train":
        over = OVERRIDES.get((arch, shape, multi_pod), {})
    elif kind == "prefill":
        over = PREFILL_OVERRIDES.get((arch, shape), {})
    if over:
        rec["overrides"] = override_names(over)
    cost = _cell_cost(cfg, cell, kind, specs, mesh, dev, over)

    if is_donn:
        n_total, n_active, model_flops = donn_model_flops(
            cfg, cell.global_batch)
    else:
        n_total, n_active, model_flops = lm_model_flops(cfg, kind, cell)
    roof = roofline(cost, model_flops, chips)
    rec.update({
        "status": "ok",
        "chips": chips,
        "device": str(dev),
        "n_params": n_total,
        "n_active_params": n_active,
        "model_flops": model_flops,
        "hlo_flops_per_dev": cost.flops,
        "hlo_dot_flops_per_dev": cost.dot_flops,
        "hlo_bytes_per_dev": cost.bytes,
        "collective_bytes_per_dev": cost.collective_bytes,
        "collective_breakdown": cost.collective_breakdown,
        "terms": roof["terms"],
        "dominant": roof["dominant"],
        "roofline_fraction": roof["roofline_fraction"],
        "model_over_hlo_flops": (
            model_flops / (cost.flops * chips) if cost.flops else 0.0),
        "memory": memory_record(cost),
        "ops": cost.ops,
        "compile_wall_s": time.time() - t0,
    })
    return rec


def all_cells(smoke: bool = False) -> list:
    """The sweep's (arch, shape) cells, in the reference's order: the
    shapes of the configs traced (donn-xl-500's smoke config, n = 96, has
    ``train_b1024`` where the full one has ``train_b256``)."""
    return [(arch, cell.name) for arch in LM_ARCHS + DONN_ARCHS
            for cell in shapes_for(get_config(arch, smoke=smoke))]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--device", default=None,
                    help="device of the fake tensors (default: the CUDA "
                         "card)")
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    if args.all:
        cells = all_cells(args.smoke)
    else:
        if not args.arch or not args.shape:
            ap.error("need --arch and --shape (or --all)")
        cells = [(args.arch, args.shape)]

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = 0
    for multi in meshes:  # one process group a mesh
        with fake_world(512 if multi else 256):
            for arch, shape in cells:
                tag = f"{arch}__{shape}__{'pod2' if multi else 'pod1'}"
                path = out_dir / f"{tag}.json"
                if path.exists():
                    print(f"[skip-cached] {tag}")
                    continue
                print(f"[dryrun] {tag} ...", flush=True)
                try:
                    rec = run_cell(arch, shape, multi, smoke=args.smoke,
                                   device=args.device)
                except Exception as e:  # noqa: BLE001 - record, keep sweeping
                    rec = {
                        "arch": arch, "shape": shape,
                        "mesh": "pod2-512" if multi else "pod1-256",
                        "status": f"FAIL: {type(e).__name__}: {e}",
                    }
                    failures += 1
                path.write_text(json.dumps(rec, indent=2, default=float))
                print(f"[done] {tag}: {rec.get('status')} "
                      f"({rec.get('compile_wall_s', 0.0):.1f}s)", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
