#!/usr/bin/env python3
"""The reference's own sharded-vs-single-device gap at ``donn-xl-500``.

    PYTHONPATH=src JAX_PLATFORMS=cpu python scripts/reference_mesh_gap.py \
        [--batch 8]

Runs the JAX package (the reference) on 8 host CPU devices: its
``make_donn_sharded_loss`` on a (2, 4) ``(data, model)`` mesh (pencil FFT
hops, per-class partial readouts summed over ``model``) against its
single-device loss (``fft2`` hops, one readout), at the full width and
depth of ``donn-xl-500`` (n=500, depth 30, det 40), parameters from
``jax.random.PRNGKey(0)``, ``--batch`` seeded images.  It prints the loss
and d/dphase gaps (max|a - b| / max|b|) at the config's gamma 1.05 and at
the gamma ``calibrate_gamma`` picks, beside the largest logit and the
median gap between each image's two largest logits: the softmax's
saturation, which turns f32 rounding of the two computations into a
d/dphase gap.  ``chip_smoke.py``'s mesh phase holds the port's sharded
loss to 1e-5 at the calibrated gamma for this reason.

One of the two scripts of the repo that import the JAX package (with
``write_jax_artifact_fixture.py``); the port never runs it.  The batch is
cut from the card's 32 to 8 by default to keep the CPU run small.
"""
from __future__ import annotations

import argparse
import dataclasses
import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import DONNConfig  # noqa: E402
from repro.core.models import cached_model  # noqa: E402
from repro.core.regularization import calibrate_gamma  # noqa: E402
from repro.core.train_utils import mse_softmax_loss  # noqa: E402
from repro.runtime import donn_steps as ds  # noqa: E402
from repro.runtime import sharding as shd  # noqa: E402

XL = DONNConfig(name="donn-xl-500", n=500, pixel_size=36e-6,
                wavelength=532e-9, distance=0.30, depth=30, num_classes=10,
                det_size=40, gamma=1.05)


def _gap(a, b) -> float:
    return float(jnp.max(jnp.abs(a - b)) / jnp.max(jnp.abs(b)))


def measure(cfg, params, batch, mesh) -> dict:
    model = cached_model(cfg)

    def single(p, b):
        return mse_softmax_loss(model.apply(p, b["images"]), b["labels"],
                                cfg.num_classes)

    l0, g0 = jax.jit(jax.value_and_grad(single))(params, batch)
    l1, g1 = jax.jit(jax.value_and_grad(
        ds.make_donn_sharded_loss(cfg, mesh)))(params, batch)
    logits = model.apply(params, batch["images"])
    top2 = jax.lax.top_k(logits, 2)[0]
    return {
        "loss": float(l0),
        "loss_gap": abs(float(l1) - float(l0)) / abs(float(l0)),
        "grad_gap": max(_gap(a, b) for a, b in zip(jax.tree.leaves(g1),
                                                   jax.tree.leaves(g0))),
        "logit_max": float(jnp.max(logits)),
        "median_top_gap": float(jnp.median(top2[:, 0] - top2[:, 1])),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args(argv)
    mesh = shd.make_mesh_2d(data=2, model=4)
    params = cached_model(XL).init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(31)
    batch = {"images": rng.random((args.batch, 28, 28), np.float32),
             "labels": (np.arange(args.batch) % 10).astype(np.int32)}
    gamma = calibrate_gamma(cached_model(XL), params, batch["images"])
    for label, cfg in (("config gamma 1.05", XL),
                       (f"calibrated gamma {gamma:.6f}",
                        dataclasses.replace(XL, gamma=gamma))):
        r = measure(cfg, params, batch, mesh)
        print(f"[reference] donn-xl-500, batch {args.batch}, (2, 4) mesh of "
              f"{jax.device_count()} CPU devices, {label}: loss "
              f"{r['loss']:.6f}, loss gap {r['loss_gap']:.3e}, d/dphase gap "
              f"{r['grad_gap']:.3e}; largest logit {r['logit_max']:.1f}, "
              f"median top-2 logit gap {r['median_top_gap']:.3f}")


if __name__ == "__main__":
    main()
