#!/usr/bin/env python3
"""Write the JAX-written serving artifacts the port is held against.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/write_jax_artifact_fixture.py

Runs the JAX package (the reference, on the CPU: its Pallas kernels in
interpret mode) and writes ``tests/fixtures/jax_artifact_n64/``:

- ``f32/``, ``bf16/``, ``int8/`` — format-2 ``cls`` artifacts
  (``repro.runtime.resilience.save_deployed``) of one DONN at n=64, depth
  3, ``use_pallas=True``, parameters from ``jax.random.PRNGKey(0)``, with
  float32, bfloat16 and int8 frozen planes;
- ``x.npy`` — a seeded batch of 8 20x20 inputs (numpy ``default_rng(0)``);
- ``jax_out_{f32,bf16,int8}.npy`` — the JAX deployment's logits for it.

One of the two scripts of the repo that import the JAX package (with
``reference_mesh_gap.py``): the port never runs it.  The tests and ``chip_smoke.py`` only read what it wrote
(committed, under 300 KB); rerun it after a change to the artifact format
and commit the result.
"""
from __future__ import annotations

import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import DONNConfig, build_model
from repro.runtime.inference import freeze
from repro.runtime.resilience import save_deployed

OUT = (pathlib.Path(__file__).resolve().parent.parent / "tests" / "fixtures"
       / "jax_artifact_n64")
VARIANTS = {"f32": "float32", "bf16": "bfloat16", "int8": "int8"}
CFG = DONNConfig(name="fixture-n64", n=64, depth=3, distance=0.05,
                 det_size=8, input_size=20, codesign="qat",
                 use_pallas=True)


def main() -> None:
    if OUT.exists():
        shutil.rmtree(OUT)
    OUT.mkdir(parents=True)
    model = build_model(CFG)
    params = model.init(jax.random.PRNGKey(0))
    x = np.random.default_rng(0).random((8, CFG.input_size, CFG.input_size),
                                        np.float32)
    np.save(OUT / "x.npy", x)
    for tag, dtype in VARIANTS.items():
        dep = freeze(model, params, plane_dtype=dtype)
        save_deployed(dep, OUT / tag)
        out = np.asarray(jax.jit(dep.forward)(jnp.asarray(x)), np.float32)
        np.save(OUT / f"jax_out_{tag}.npy", out)
        print(f"{tag}: logits {out.shape}, argmax {out.argmax(-1).tolist()}")
    size = sum(f.stat().st_size for f in OUT.rglob("*") if f.is_file())
    print(f"wrote {OUT} ({size} bytes)")


if __name__ == "__main__":
    main()
