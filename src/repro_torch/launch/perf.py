"""Named experiment variants of three dry-run cells, each traced and
costed like a dry-run cell (port of ``repro.launch.perf``).

  python -m repro_torch.launch.perf --cell glm4 [--variant NAME] \\
      [--multi-pod] [--device cpu] [--out DIR]

Cells (the reference's):
  donn   — donn-xl-500/train_b256: the paper's technique.  The reference
           compares GSPMD's auto-sharded step (``baseline_pjit``) with its
           explicit data-parallel one (``shardmap_dp``); in the port both
           compilers run one program (``runtime.donn_steps._data_parallel``:
           every rank the whole optical step on its batch shard), which the
           record says (``same_program_as``).
  glm4   — glm4-9b/train_4k: a dense-LM train step.
  arctic — arctic-480b/train_4k: the moe train step.

Each record is traced on a fake process group of 256 (or, with
``--multi-pod``, 512) ranks, as ``launch.dryrun`` traces a cell.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import sys
import time

import torch

from repro_torch.device import resolve_device
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.dryrun import (
    OVERRIDES, donn_model_flops, fake_world, lm_model_flops, memory_record,
    roofline, trace_donn_step, trace_train_step,
)
from repro_torch.launch.specs import input_specs
from repro_torch.runtime import sharding as shd
from repro_torch.runtime.donn_steps import (
    compile_donn_train_step, compile_donn_train_step_shardmap,
)

# variant := (name, cfg_patch, step_kwargs, use_shardmap)
VARIANTS = {
    "donn": {
        "arch": "donn-xl-500", "shape": "train_b256",
        "variants": [
            ("baseline_pjit", {}, {}, False),
            ("shardmap_dp", {}, {}, True),
        ],
    },
    "glm4": {
        "arch": "glm4-9b", "shape": "train_4k",
        "variants": [
            ("baseline", {}, {}, False),
            ("bf16_gather", {}, {"cast_params_to": torch.bfloat16}, False),
            ("bf16_gather_chunk2048", {"attn_chunk": 2048},
             {"cast_params_to": torch.bfloat16}, False),
            ("bf16_gather_chunk4096", {"attn_chunk": 4096},
             {"cast_params_to": torch.bfloat16}, False),
            ("bf16_gather_accum2", {},
             {"cast_params_to": torch.bfloat16, "accum_steps": 2}, False),
            ("bf16_gather_chunk2048_pbf16",
             {"attn_chunk": 2048, "attn_p_bf16": True},
             {"cast_params_to": torch.bfloat16}, False),
            ("pbf16_only", {"attn_p_bf16": True}, {}, False),
        ],
    },
    "arctic": {
        "arch": "arctic-480b", "shape": "train_4k",
        "variants": [
            ("baseline_overrides", {}, {}, False),
            ("cap1.0", {"capacity_factor": 1.0}, {}, False),
            ("cap1.0_group2048",
             {"capacity_factor": 1.0, "moe_group": 2048}, {}, False),
            ("cap1.0_accum16", {"capacity_factor": 1.0},
             {"accum_steps": 16}, False),
        ],
    },
}


def run_variant(cell_key: str, name, cfg_patch, step_kwargs, use_shardmap,
                multi_pod=False, device=None) -> dict:
    """One variant's record; the process group must be a (fake) group of
    the production mesh's ranks."""
    spec = VARIANTS[cell_key]
    arch, shape = spec["arch"], spec["shape"]
    t0 = time.time()
    cfg, cell, kind, specs = input_specs(arch, shape)
    if cfg_patch:
        cfg = dataclasses.replace(cfg, **cfg_patch)
    dev = resolve_device(device)
    mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod, device=dev)
    chips = math.prod(shd.mesh_shape(mesh).values())
    is_donn = not hasattr(cfg, "family")
    rec = {"cell": f"{arch}/{shape}", "variant": name,
           "mesh": "pod2-512" if multi_pod else "pod1-256"}

    if is_donn:
        compile_fn = (compile_donn_train_step_shardmap if use_shardmap
                      else compile_donn_train_step)
        fn, s_ps, b_ps, sspecs = compile_fn(
            cfg, mesh, global_batch=cell.global_batch, device=dev)
        cost = trace_donn_step(fn, sspecs, s_ps, specs, b_ps, mesh, dev)
        rec["same_program_as"] = ("shardmap_dp" if not use_shardmap
                                  else "baseline_pjit")
        _, _, model_flops = donn_model_flops(cfg, cell.global_batch)
    else:
        over = dict(OVERRIDES.get((arch, shape, multi_pod), {}))
        over.update(step_kwargs)
        cost = trace_train_step(cfg, specs, mesh, dev, **over)
        _, _, model_flops = lm_model_flops(cfg, kind, cell)
    roof = roofline(cost, model_flops, chips)
    mem = memory_record(cost)
    rec.update({
        "status": "ok",
        "terms": roof["terms"], "dominant": roof["dominant"],
        "bound_s": roof["bound_s"],
        "roofline_fraction": roof["roofline_fraction"],
        "collective_breakdown": cost.collective_breakdown,
        "memory_per_dev_GB": mem["per_device_bytes"] / 1e9,
        "fits_hbm": mem["fits_hbm"],
        "compile_wall_s": time.time() - t0,
    })
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", choices=list(VARIANTS) + ["all"],
                    default="all")
    ap.add_argument("--variant", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default="artifacts/perf_torch")
    ap.add_argument("--device", default=None,
                    help="device of the fake tensors (default: the CUDA "
                         "card)")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    cells = list(VARIANTS) if args.cell == "all" else [args.cell]
    failures = 0
    with fake_world(512 if args.multi_pod else 256):
        for ck in cells:
            for v in VARIANTS[ck]["variants"]:
                name, cfg_patch, step_kwargs, use_sm = v[:4]
                if args.variant and name != args.variant:
                    continue
                tag = f"{ck}__{name}__{'pod2' if args.multi_pod else 'pod1'}"
                path = out / f"{tag}.json"
                if path.exists():
                    print(f"[skip-cached] {tag}")
                    continue
                print(f"[perf] {tag} ...", flush=True)
                try:
                    rec = run_variant(ck, name, cfg_patch, step_kwargs,
                                      use_sm, args.multi_pod, args.device)
                except Exception as e:  # noqa: BLE001
                    rec = {"cell": ck, "variant": name,
                           "status": f"FAIL: {type(e).__name__}: {e}"}
                    failures += 1
                path.write_text(json.dumps(rec, indent=2, default=float))
                print(f"[done] {tag}: "
                      + (f"bound={rec['bound_s']:.3f}s "
                         f"dom={rec['dominant']} "
                         f"frac={rec['roofline_fraction']:.4f} "
                         f"mem={rec['memory_per_dev_GB']:.1f}GB"
                         if "terms" in rec else rec.get("status", "")),
                      flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
