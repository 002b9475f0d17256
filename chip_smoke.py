#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card, end to end.

    python3 chip_smoke.py [--profile FILE]

Phases, each printing its own lines; any failure propagates and the
script exits non-zero without the final line:

1. device  — requires a CUDA card; prints its name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
   gives them.
2. build   — compiles the hand-written kernels from
   ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a (one nvcc per
   source, in parallel).  The facts phase prints each kernel entry's
   registers, spills, static and dynamic shared memory and resident
   blocks a SM (worked out from ptxas's numbers and the launcher's
   dynamic bytes), K7's SASS instructions a state-step with the issue and
   FP32 bounds they give, K7 at B 1 (one sequence's prefill) against its
   own bound, K3 at one mask beside ten, and the launch floor of K3 and K5
   at a 1x1 field.
3. kernels — runs each kernel (K1 conj_phase_scale, K2 phase_tf_apply,
   K3 intensity_readout, K4 phase_apply) and its plain PyTorch version on
   the card on the main path's shapes (32x200x200 with a shared plane, a
   P=5 stack) and odd 37x53 shapes; holds each to max|kernel - plain|
   <= 1e-5 * max|plain| and times both with CUDA events, and prints each
   kernel's share of its bound.  K3 is also held at B 1 and 33, C 1 and
   17 and on an 8-byte-aligned view, repeated to the bit, and one field's
   readout is held to the bit across the buckets 1, 8 and 32 and alone
   against inside a batch.  Then holds the backward of each autograd
   Function (_PhaseTFApply, _FusedHop, _Readout, _PhaseApply) at
   32x200x200 against autograd through the plain versions on the card,
   to the same tolerance.
   physics — the paper's physics on the card (``diffraction.propagate``,
   the one-shot API): at donn-mnist-5l's grid (n 200, 36 um, 532 nm,
   z 0.30 m) and donn-xl-500's (n 500), PHYSICS_BATCH seeded fields
   through RS and Fresnel with and without the band limit, padded RS and
   Fraunhofer, each within SLICE_RTOL of the max of its CPU copy; then
   tests/test_diffraction.py's identities at the same grids and its
   tolerances (unitarity, the band limit only removing energy, two hops
   equal one, forward/backward, superposition, a Gaussian's waist
   against theory, Fresnel against RS, a slit's sinc far field); then
   donn-mnist-5l's plan at zero phases and gamma 1 through K1 (counted:
   K1 2L, K2 once) against depth + 1 chained propagate calls, and
   ``ops.fused_spectral_hop`` against ``fused_spectral_hop_ref``.
4. slice   — builds ``donn-mnist-5l`` (n=200, depth 5, qat 256 levels,
   use_pallas) on the card from a seeded generator, freezes it with f32,
   bf16 and int8 planes (and f32 with the rfft first hop), serves 32
   requests through ``InferenceEngine.infer`` and 64 single requests
   through ``MicroBatcher`` with the launch counters reset just before,
   holds the logits against the same deployment on CPU copies (plain
   versions) and reports req/s and per-batch p50/p99 at bucket 32, each
   row served for WINDOW_S seconds, REPEATS times, rows interleaved.
5. train   — ``donn-mnist-5l`` training at full width on both engines
   (scan: K1/K2/K3 with K2 in the backward; eager: K4 forward and
   backward, K3): the loss and every layer's d/dphase on the card against
   a CPU copy (plain versions) and eager against scan, both to 1e-4 of
   the max; the launches of TRAIN_STEPS counted optimizer steps on each
   engine against the per-step formula; ``train_classifier`` for 40
   steps with a falling loss (gamma calibrated first, as the reference's
   quickstart does); optimizer steps/s at batch 32 for three
   rows (scan + kernels, eager + K4, plain torch), each a closed loop of
   WINDOW_S seconds, REPEATS times, rows interleaved; then
   ``serve_donn --train-steps 16`` at the config's width.
6. cli     — runs ``repro_torch.launch.serve_donn.main`` at the config's
   width: once as is, once with ``--save-artifact``, and once from that
   artifact with ``--artifact --replicas 2`` (a two-replica fleet).
7. families — the paper's advanced DONNs, parameters from seeded
   generators on the card, each result held against a CPU copy (plain
   versions) within SLICE_RTOL: ``donn-rgb`` (n=200, 3 channels, 6
   classes, depth 5; gamma calibrated first) trains TRAIN_STEPS steps on
   each engine through ``make_train_chunk``, is frozen with f32, bf16 and
   int8 planes and serves buckets 1, 8 and 32 through
   ``InferenceEngine.infer`` and 64 single requests through
   ``MicroBatcher`` (argmax equal); ``donn-seg`` (n=350, depth 5, the
   optical skip from layer 0, layer norm) takes TRAIN_STEPS AdamW steps
   of BCE written by hand and serves frozen f32 intensity maps at bucket
   32; each family's launches are held against ``family_launches`` (RGB:
   K3 over the B*C rows; segmentation: no K3), and both serve at bucket
   32 on the kernel path and on plain torch, rows interleaved.  The cost
   of K1's plane-major copies for the RGB (32, 3, 200, 200) field is
   timed beside the fused hop.  ``hybrid-slm-printed`` (two segments, one
   resample stitch) is held forward, backward and frozen.
8. design  — the paper's design flow (Fig. 3, §4), each result held
   against K sequential ``build_model(c).apply`` calls on the card and
   against a CPU copy (plain versions) within SLICE_RTOL, launches held
   against their formula: ``donn-mnist-5l`` with Gumbel codesign (256
   levels, gamma calibrated) trains TRAIN_STEPS steps with noise from a
   CUDA generator on each engine through ``make_train_chunk``, the CPU
   copy replaying the card's draws; the peak memory of a step and
   steps/s against the qat step; a falling loss in 40 steps.
   ``emulate_batch`` at n=200, batch 32: 8 geometries (wavelength, pitch,
   distance), a mixed-depth set (2-5, masked) and sensitivity_analysis's
   15 points, each timed against the K sequential calls (fresh and cached
   models); ``donn-rgb`` and ``donn-seg`` (skip, train=True) at K=4; one
   call launches K1 2L, K2 once (twice with the skip hop) and K3 once for
   all K.  ``LightRidgeDSE.explore`` and ``sensitivity_analysis`` through
   ``emulate_batch`` against the sequential ``emulate``.  ``remat``
   "layer"/"segment" against "none" at depth 5 (2L more K1 a step, the
   recompute) and each policy's peak memory at depth 16.  Then the
   examples' flows: quickstart (DSL -> train -> export -> serve, accuracy
   >= 0.95 asserted) and the four steps of the codesign flow, its DSE
   verified through ``emulate_batch``.
9. lm      — the LM serving slice with random parameters from seeded
   generators on the card, TF32 off: ``repro_torch.launch.serve.main``
   serves qwen1.5-4b (full width and depth, bf16 matmuls) at 8 slots, 24
   requests, prompt 16, 32 new tokens, once; a full-width depth-2 f32
   copy holds one 16-token prefill against the CPU (SLICE_RTOL, argmax
   equal) and 16 decode steps against that prefill on the card; K6 runs
   through ``apply_rotary(use_pallas=True)`` on layer 0's q and k of a
   batch-8, S=2048 prefill of the served parameters, held against the
   flag off.  Then falcon-mamba-7b (full width, all 64 layers) is served
   the same way and K7 is held against ``ssm._selective_scan`` on layer
   0's mixer tensors (dt, x, B, C, A) of a batch-8, S=2048 prefill.  Each
   model is freed before the next is built.
10. lm_train — LM training on the card, no kernel on its path (as in the
   reference): ``repro_torch.launch.train.main`` trains qwen1.5-4b at full
   width and depth (40 layers, d_model 2560, vocab 151936) and
   falcon-mamba-7b at full width, depth 16 of 64 (its f32 state at 64
   layers would be 116 GB) for 8 steps at batch 8, seq 128, lr 1e-3,
   warmup 2, bf16 matmuls, f32 masters and moments: finite, falling
   losses, steps/s and tokens/s (median of the steps after the second),
   the peak memory of step 3 (``--profile``: FILE.lmtrain and
   FILE.lmtrain_ssm, a table of step 5).  At full width, depth 2, f32,
   batch 2, seq 16, each model on the card against a CPU copy (plain
   torch both sides, SLICE_RTOL): ``lm_loss``, the grad norm, every leaf's
   grad (qwen's ``bk``, zero in exact arithmetic, against the largest
   grad), the blocked AdamW update bitwise the unblocked one, and one
   ``make_train_step`` step at accum 1 and 2 (against the CPU copy's
   ``loss_and_grads`` and AdamW update at accum 1, its own
   ``make_train_step`` at accum 2: loss, grad norm; every
   param within Adam's sign bound, 2 lr, and within SLICE_RTOL where the
   gradient is clear of rounding noise and of AdamW's eps).  The qwen depth-2 train state (11 GB)
   through ``AsyncCheckpointer`` and back, bitwise, timed.  The launcher's
   control flow at glm4-9b --smoke: 10 straight steps against 5 + resume
   5, a subprocess SIGTERM'd after step 10 (rc 143, then resumed), and the
   examples' train 200 / resume to 250 / serve 16 requests.  K1-K7
   launches across the phase: zero, asserted.
11. dryrun — the dry-run tools (``launch/dryrun.py``,
   ``runtime/cost_analysis.py``) held against the card, no kernel on
   their path: ``launch.mesh.HBM_PER_DEVICE`` equals the card's
   ``total_memory``; the qwen1.5-4b step of the lm_train phase (full width
   and depth, batch 8 x seq 128, its optimizer, moments present) traced on
   fake CUDA tensors on one rank, its peak live bytes within 5% of the
   step-3 peak that phase measured; one real depth-2 step counted on the
   card against its fake trace (FLOPs, dot FLOPs and bytes within 0.1%, no
   collective bytes); the full step's compute and memory terms beside its
   step-3 time on the stream (CUDA events; printed, not held); and three
   production cells through the CLI in subprocesses started together
   (fake CUDA tensors on a fake process group: qwen1.5-4b ``train_4k`` and
   glm4-9b ``decode_32k`` on ``pod1-256``, donn-xl-500 ``train_b256`` on
   ``pod1-256`` and ``pod2-512``), each record ``ok`` with its terms,
   dominant term and roofline fraction printed, beside ``launch/perf.py
   --cell donn`` (its two variants one program in the port: equal terms).
   Zero K1-K7 launches, asserted.
12. lm_families — the audio, moe, hybrid and vlm LM families on the card
   at full width, bf16 matmuls over f32 parameters, no kernel on their
   path (as in the reference): ``serve.main`` (8 slots, 24 requests,
   prompt 16, 32 new tokens, cache 128, once: tokens/s and peak memory)
   serves musicgen-medium, recurrentgemma-9b and llama-3.2-vision-11b at
   full depth, mixtral-8x7b at depth 8 of 32 and arctic-480b at depth 1
   of 35 (the f32 parameters of more do not fit 80 GB); the launcher
   trains musicgen at full depth, mixtral at depth 2, recurrentgemma at
   depth 8 and llama-vision at depth 10 for 8 steps as the lm_train phase
   does (``--profile``: FILE.lmtrain_moe, FILE.lmtrain_hybrid); arctic's
   smoke config runs 8 launcher steps and 4 + resume 4, bitwise (one
   full-width arctic layer's training state is 225 GB).  At f32, batch 2,
   seq 16 (musicgen depth 2, mixtral depth 1, recurrentgemma depth 3,
   llama-vision depth 5 with its cross gates opened, arctic smoke):
   decode against prefill on the card (moe capacity lifted, vlm's xk/xv
   from the vision states; 1e-4 of the max), then logits, ``lm_loss``
   (moe: with aux), the grad norm, every grad and one ``make_train_step``
   step against a CPU copy (SLICE_RTOL; the step held as in lm_train),
   with the tokens that route to another expert set on the card than on
   the CPU counted and their router margins printed.  K1-K7 launches
   across the phase: zero, asserted.
13. persistence — artifacts, supervision, the fleet and rollback on the
   card, every hold raising: ``donn-mnist-5l`` (f32, bf16, int8, f32 with
   ``rfft_first``), ``donn-rgb``, ``donn-seg`` and ``hybrid-slm-printed``
   are saved and cold-started with ``load_deployed`` (no device: the
   card), bitwise equal to the in-memory deployment at buckets 1, 8 and
   32 and within SLICE_RTOL of a CPU load of the same artifact, with the
   ms of the load, the warmup and the first request; the committed
   JAX-written fixture (``tests/fixtures/jax_artifact_n64``) served within
   1e-4 of its JAX outputs, argmax equal; ``corrupt_chunk`` and
   ``flip_crc`` refused at load, format 99 by ``validate_artifact``;
   ``EngineSupervisor`` over a ``CrashingEngine`` through 5 kill/restart
   cycles (outputs bitwise, ``memory_allocated`` flat within one
   deployment's bytes); ``FleetRouter.from_artifact`` at 1, 2 and 4
   replicas beside ``MicroBatcher`` (128 requests in flight, bucket 32,
   WINDOW_S a row, REPEATS times, rows interleaved, with each row's mean
   batch fill); ``kill_replica`` mid-run and a rolling ``swap_artifact`` under load
   (zero drops, bitwise outputs); ``train_classifier`` with ``ckpt_dir``
   over a fully poisoned chunk (one rollback, losses bitwise a clean
   run's) and a timed ``AsyncCheckpointer.save``; ``perturb_frozen``
   (no fault is the identity; accuracy at phase sigma 0.1, 0.5, 1.0 on the
   card and the CPU copy, equal).  Its K1-K3 launches are held against
   what its engines' forwards and training steps owe.

14. mesh — the multi-device slice, after every earlier phase: the
   card's machine has one card and NCCL takes one rank a card, so the
   k > 1 paths run as k gloo ranks sharing it (``collectives.spawn_ranks``,
   2 ranks, then 4; collectives staged through the host).  Data parallel
   with the kernels (``donn-mnist-5l``, bucket 32): ``InferenceEngine(
   mesh_devices=2|4)`` against the single-rank engine (1e-5, argmax
   equal, repeats bitwise, every rank the whole logits) and 3 steps of
   ``compile_donn_train_step`` against the single-device step (losses rtol
   1e-5, params 2e-3 of the max), each rank's K1-K3 launches held to
   ``serve_launches`` and ``train_launches_per_step``.  Row-sharded at full
   width (``donn-xl-500``, n=500, depth 30, no kernels): the sharded loss
   and d/dphase at meshes (1, 2), (2, 2), (1, 4), 3 sharded steps at (2,
   2) and the engines at (1, 2), (1, 4), (2, 2) against the single rank;
   ``donn-rgb`` and ``donn-seg`` at (2, 2) and ``hybrid-slm-printed`` at
   (1, 2).  NCCL at world size 1 on a (1, 1) mesh: the engine and the
   data-parallel step bitwise the calls without a process group (with 2+
   cards the holds repeat over NCCL, one rank a card).  Times (pencil fft2
   of (32, 500, 500), the xl engine's req/s at k = 1, 2, 4, a sharded
   step) are labelled as ranks sharing one card: none is a multi-GPU
   rate.  Every hold is printed; the phase raises after the last if any
   failed.

15. lm_mesh — LM tensor, data, sequence and expert parallelism over
   ``(data, model)`` meshes of gloo ranks sharing the card (4 ranks, 3,
   then 2): ``repro_torch.launch.serve.main --mesh 1x4`` and ``1x2`` serve
   qwen1.5-4b at full width and depth (8 slots, 24 requests, prompt 16, 32
   new tokens, cache 128; tokens/s and each rank's peak memory);
   ``repro_torch.launch.train.main --mesh 2x2`` trains it at full width,
   depth 8, batch 8 x seq 128 for 4 steps (steps/s, each rank's peak
   memory); a musicgen-medium full-width depth-2 train state (moments
   drawn) saved at 2x2 restores at 1x2 bit for bit (sha1 of every
   gathered leaf), each rank's leaves their ``resolve_pspec`` blocks; f32
   holds against one rank on the card (logits, loss, every gradient and
   8 decode steps within 1e-5; decode within 1e-5 of the prefill) for
   qwen1.5-4b at (2, 2) depth 2, falcon-mamba-7b at (1, 2) depth 2 and
   mixtral-8x7b at (1, 2) depth 1 (4 experts a rank; the tokens routed
   differently from one rank counted, their margins printed), and
   qwen1.5-4b at (1, 3) depth 2, where its 20 heads and its vocabulary of
   151936 do not divide and run whole on every rank beside the split MLP
   (6912 = 3 x 2304); each hold's time printed.  Zero K1-K7
   launches over every rank.  With 2+ cards the serving launcher runs
   again as NCCL ranks, one a card; on one card that path does not run.

Phase 3 also holds K5 complex_mul (32x200x200 x (200, 200); at odd
37x53, a[1:] and a[1:3] of an odd batch, whose starts are 8 bytes off 16),
K6 rope (the qwen1.5-4b prefill shape (160, 2048, 128), bf16 and f32) and
K7 selective_scan against their plain versions, and their autograd
Functions (_ComplexMul, _Rope) backward.  K7 is held at general A
(-exp(randn), dt log-uniform over 1e-3..1) as well as the s4d A =
-(n+1): ragged D 203 with N 1, 4, 16 and 32 and S 37, D 260 at S 35, and
the timed shape B 8, S 2048, D 8192, N 16 both ways; each case repeats
to the bit and its batch row 1 alone equals the row inside its batch.

Then one JSON line lists every kernel with its launches on the main path
(the physics phase's plan, DONN serving + training, the families, the
design flow, LM serving, persistence, the mesh's ranks, LM training, the
dry-run, the LM families, the LM mesh's ranks; the physics plan's also
under ``physics_launches`` and the last six under
``persistence_launches``, ``mesh_launches``, ``lm_train_launches``,
``dryrun_launches``, ``lm_families_launches`` and ``lm_mesh_launches``)
and in the LM holds apart, its launches per training step on each engine,
per family, per design part and per LM window, error and times, and the
last line is the device record.
``--profile FILE`` adds ``torch.profiler`` tables of PROFILE_BATCHES
bucket-32 batches and of PROFILE_CHUNKS 8-step training chunks, with the
device's busy time and idle share, printed and written to FILE (the
training table to FILE.train, RGB and segmentation serving to FILE.rgb
and FILE.seg, an emulate_batch call of 8 candidates to FILE.design, an
LM training step to FILE.lmtrain, FILE.lmtrain_ssm, FILE.lmtrain_moe and
FILE.lmtrain_hybrid).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import multiprocessing
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.checkpoint import AsyncCheckpointer  # noqa: E402
from repro_torch.checkpoint import latest_step as ckpt_latest  # noqa: E402
from repro_torch.checkpoint import restore as ckpt_restore  # noqa: E402
from repro_torch.checkpoint import save as ckpt_save  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.donn import HYBRID_SLM_PRINTED  # noqa: E402
from repro_torch.core import codesign, dse, dsl  # noqa: E402
from repro_torch.core import diffraction as df  # noqa: E402
from repro_torch.core.config import DONNConfig  # noqa: E402
from repro_torch.core.models import (  # noqa: E402
    build_model, cached_model, emulate_batch,
)
from repro_torch.core.propagation import plan_from_config  # noqa: E402
from repro_torch.core.regularization import calibrate_gamma  # noqa: E402
from repro_torch.core.train_utils import (  # noqa: E402
    bce_segmentation_loss, evaluate_classifier, loss_and_grads,
    make_train_chunk, make_train_step, mse_softmax_loss, train_classifier,
)
from repro_torch.data.synthetic import (  # noqa: E402
    batch_iterator, synth_digits, synth_rgb_scenes, synth_seg,
)
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.launch import dryrun as dry  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import serve, serve_donn  # noqa: E402
from repro_torch.launch import train as lm_train  # noqa: E402
from repro_torch.models import attention as lm_attn  # noqa: E402
from repro_torch.models import get_config as lm_config  # noqa: E402
from repro_torch.models import lm, moe, ssm  # noqa: E402
from repro_torch.models.config import ShapeCell  # noqa: E402
from repro_torch.models.layers import (  # noqa: E402
    apply_norm, apply_rotary, embed_tokens, rope_angles,
)
from repro_torch.nn.module import init_params  # noqa: E402
from repro_torch.optim import AdamW, warmup_cosine  # noqa: E402
from repro_torch.runtime import donn_steps as ds  # noqa: E402
from repro_torch.runtime import pencil_fft  # noqa: E402
from repro_torch.runtime import sharding as shd  # noqa: E402
from repro_torch.runtime import steps as lm_steps  # noqa: E402
from repro_torch.runtime.collectives import spawn_ranks  # noqa: E402
from repro_torch.runtime.cost_analysis import count as cost_count  # noqa
from repro_torch.runtime.fleet import FleetRouter  # noqa: E402
from repro_torch.runtime.inference import (  # noqa: E402
    InferenceEngine, MicroBatcher, expected_request_shape, freeze,
)
from repro_torch.runtime.resilience import (  # noqa: E402
    ARTIFACT_FILE, PLANES_DIR, DrainingError, EngineSupervisor,
    load_deployed, save_deployed, validate_artifact,
)
from repro_torch.testing import (  # noqa: E402
    CrashingEngine, corrupt_chunk, flip_crc, kill_replica, perturb_frozen,
    poison_batches,
)
from repro_torch.tree import (  # noqa: E402
    tree_leaves, tree_map, tree_paths, tree_unflatten,
)

# NVIDIA H100 SXM data sheet: HBM3 rate and f32 rate outside the tensor
# cores (dense, at the 700 W limit) — the bound every kernel time sits
# beside.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# H100 SXM: 16 special-function (ex2) results a clock per SM, 132 SMs, at
# its 1.98 GHz maximum clock (Hopper architecture white paper): the rate
# K7's exps are reckoned against, printed beside its bound.  Not a
# published peak: it limits K7's design, which puts every exp on the
# MUFU, not the function, so the roofline bound stays bytes vs f32.
SFU_PER_S = 16 * 132 * 1.98e9
# warp instructions a second over the H100's 4 schedulers a SM, each
# issuing one a clock; the FP32 pipe of a scheduler (32 lanes) also takes
# one a clock: what K7's SASS instruction mix is reckoned against
ISSUE_PER_S = 4 * 132 * 1.98e9
KERNEL_RTOL = 1e-5  # max|kernel - plain| / max|plain|
TP_ATOL = 1e-6  # max|H_kernel - H_plain|, H of unit modulus or less
ROPE_F32_RTOL = 1e-6  # K6 in f32: one rounding apart from the plain version
# K6 in bf16: per element within ref.rope_rounding_bound, 3 * 2^-8 *
# (|x1 c| + |x2 s|): the plain version rounds each bf16 product and the
# result, the kernel rounds once
SLICE_RTOL = 1e-4  # logits on the card vs the CPU copy (cuFFT vs pocketfft)
PHYSICS_ARCHS = ("donn-mnist-5l", "donn-xl-500")  # n 200 and n 500 grids
PHYSICS_BATCH = 32  # seeded fields a one-shot propagate call
PHYSICS_BL_Z = 2.0  # m: the band limit cuts both grids' spectra there
WINDOW_S = 1.0  # seconds of closed-loop serving/training per row, repeat
REPEATS = 2
PROFILE_BATCHES = 100
PROFILE_CHUNKS = 5
TRAIN_STEPS = 3  # counted optimizer steps per engine
CHUNK = 8  # optimizer steps per make_train_chunk call (steps_per_call)
GAMMA = 1.12  # donn-mnist-5l's gamma, K4's scalar
SERVING_KERNELS = ("conj_phase_scale", "phase_tf_apply", "intensity_readout")
LM_SERVE_FLAGS = ["--slots", "8", "--requests", "24", "--prompt-len", "16",
                  "--max-new", "32", "--device", "cuda"]
LM_HOLD_BATCH, LM_HOLD_SEQ = 8, 2048
K6_SHAPE = (8 * 20, 2048, 128)  # qwen1.5-4b q of a batch-8, S=2048 prefill
K7_SHAPE = (8, 2048, 8192, 16)  # B, S, D (falcon-mamba-7b d_inner), N
K7_PREFILL_1 = (1, 2048, 8192, 16)  # one sequence's prefill

KERNEL_META = {
    "conj_phase_scale": ("src/repro_torch/kernels/csrc/spectral_hop.cu",
                         "src/repro/kernels/spectral_hop.py:45"),
    "phase_tf_apply": ("src/repro_torch/kernels/csrc/complex_mul.cu",
                       "src/repro/kernels/complex_mul.py:91"),
    "intensity_readout": ("src/repro_torch/kernels/csrc/intensity_readout.cu",
                          "src/repro/kernels/intensity_readout.py:33"),
    "phase_apply": ("src/repro_torch/kernels/csrc/complex_mul.cu",
                    "src/repro/kernels/complex_mul.py:60"),
    "complex_mul": ("src/repro_torch/kernels/csrc/complex_mul.cu",
                    "src/repro/kernels/complex_mul.py:30"),
    "rope": ("src/repro_torch/kernels/csrc/rope.cu",
             "src/repro/kernels/rope.py:30"),
    "selective_scan": ("src/repro_torch/kernels/csrc/selective_scan.cu",
                       "src/repro/kernels/selective_scan.py:48"),
    # the design flow's candidate-set build; it has no Pallas counterpart
    "transfer_planes": ("src/repro_torch/kernels/csrc/transfer_planes.cu",
                        None),
}


def train_launches_per_step(depth: int) -> dict:
    """Kernel launches of one optimizer step of a depth-L DONN.

    scan: K1 twice per fused layer (forward only); K2 once for the final
    hop's TF multiply, once in its backward, and twice in each fused
    layer's backward except layer 0's, whose input needs no gradient; K3
    once (its backward is a matmul).  eager: K4 once per layer forward and
    once per layer backward except layer 0's; K3 once.
    """
    zero = dict.fromkeys(ops.KERNELS, 0)
    return {
        "scan": {**zero, "conj_phase_scale": 2 * depth,
                 "phase_tf_apply": 2 + 2 * (depth - 1),
                 "intensity_readout": 1},
        "eager": {**zero, "phase_apply": 2 * depth - 1,
                  "intensity_readout": 1},
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


# block size of each kernel entry where it is not 256 threads
BLOCK_THREADS = {"selective_scan_kernel": 128}
_ENTRY = re.compile(r"Compiling entry function '(\w+)'")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")
_SPILL = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def _entries(log: str):
    """(mangled name, registers, spill bytes, static smem bytes) of every
    kernel entry in an ``nvcc -Xptxas -v`` log."""
    out, cur = [], None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            cur = {"entry": m.group(1), "spill": 0, "smem": 0}
            continue
        if cur is None:
            continue
        m = _SPILL.search(line)
        if m:
            cur["spill"] = int(m.group(1)) + int(m.group(2))
        m = _USED.search(line)
        if m:
            cur["regs"] = int(m.group(1))
            m = _SMEM.search(line)
            cur["smem"] = int(m.group(1)) if m else 0
            out.append(cur)
            cur = None
    return out


def _demangle(entry: str) -> str:
    m = re.match(r"_Z(\d+)", entry)
    return entry[m.end():m.end() + int(m.group(1))] if m else entry


def _blocks_per_sm(regs: int, smem: int, threads: int) -> int:
    """Resident blocks a SM of a kernel entry, worked out as the occupancy
    API does from ptxas's registers and the shared memory of a block
    (static plus the dynamic bytes its launcher sets) and the H100's
    per-SM limits: 65,536 registers allocated 256 a warp, 64 warps, 32
    blocks, 233,472 bytes of shared memory with 1 KB reserved a block."""
    warps = -(-threads // 32)
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = (65536 // per_warp) // warps if regs else 32
    by_smem = 233472 // (smem + 1024)
    return min(by_regs, 64 // warps, 32, by_smem)


def _dynamic_smem(name: str, entry: str) -> int:
    """Dynamic shared memory the launcher of a kernel entry sets: K7's
    ring, by the entry's template argument NP (N's next power of two)."""
    m = re.search(r"ILi(\d+)E", entry)
    if name != "selective_scan" or m is None:
        return 0
    return build.library(name).selective_scan_smem_bytes(int(m.group(1)))


_SASS_FUNCTION = re.compile(r"Function : (\S+)")
_SASS_LABEL = re.compile(r"^\s*(\.L_x_\d+):")
_SASS_INSTR = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)([^;]*);")
_SASS_TARGET = re.compile(r"`\((\.L_x_\d+)\)|\b0x([0-9a-f]+)\b")
FP32_OPS = ("FFMA", "FMUL", "FADD")


def sass_loops(lib_path) -> dict:
    """{mangled entry: [(first, last, opcode counts), ...]}: every loop of
    each function in ``cuobjdump -sass``, a body being the instructions
    from a branch's target up to the branch when it jumps back."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    out = {}
    for chunk in re.split(r"\n(?=\s*Function : )", text):
        m = _SASS_FUNCTION.search(chunk)
        if m is None:
            continue
        instrs, labels, pending = [], {}, []
        for line in chunk.splitlines():
            lm = _SASS_LABEL.match(line)
            if lm:
                pending.append(lm.group(1))
                continue
            im = _SASS_INSTR.search(line)
            if im:
                addr = int(im.group(1), 16)
                labels.update(dict.fromkeys(pending, addr))
                pending = []
                instrs.append((addr, im.group(2).split(".")[0], im.group(3)))
        loops = []
        for addr, op, args in instrs:
            tm = _SASS_TARGET.search(args) if op == "BRA" else None
            if tm is None:
                continue
            target = labels.get(tm.group(1)) if tm.group(1) else int(
                tm.group(2), 16)
            if target is None or target > addr:
                continue
            counts: dict = {}
            for a, o, _ in instrs:
                if target <= a <= addr:
                    counts[o] = counts.get(o, 0) + 1
            loops.append((target, addr, counts))
        out[m.group(1)] = loops
    return out


def k7_loop_mix(loops) -> tuple:
    """(step loop, tile loop) of a K7 entry: the smallest loop that holds
    a MUFU (the exps), and the smallest loop around it that holds the
    barrier; either is None where the SASS has no such loop."""
    size = lambda lp: sum(lp[2].values())  # noqa: E731
    step = min((lp for lp in loops if lp[2].get("MUFU")), key=size,
               default=None)
    if step is None:
        return None, None
    tile = min((lp for lp in loops if lp[2].get("BAR") and lp[0] <= step[0]
                and step[1] <= lp[1]), key=size, default=None)
    return step, tile


def _facts_k7(dev, entries) -> None:
    """K7's instruction mix a state-step in the SASS of each entry's step
    loop (one MUFU.EX2 a state-step, so the MUFU count is the state-steps of
    the body) and the instructions its tile loop adds, the issue and FP32
    bounds the mix gives at the timed shape, and the time of one sequence's
    prefill beside its own bound."""
    try:
        loops = sass_loops(build._target("selective_scan"))
    except (OSError, subprocess.SubprocessError) as exc:
        print(f"[facts] selective_scan SASS not read: {exc}")
        loops = {}
    B, S, D, N = K7_SHAPE
    warp_steps = B * S * D * N / 32
    for entry in entries:
        step, tile = k7_loop_mix(loops.get(entry, []))
        if step is None:
            print(f"[facts] selective_scan {entry}: no loop with a MUFU")
            continue
        mix = step[2]
        steps = mix["MUFU"]
        total = sum(mix.values())
        fp32 = sum(mix.get(op, 0) for op in FP32_OPS)
        top = ", ".join(f"{op} {c / steps:.2f}" for op, c in sorted(
            mix.items(), key=lambda kv: -kv[1])[:8])
        extra = (0 if tile is None or tile is step
                 else sum(tile[2].values()) - total)
        line = (f"[facts] selective_scan {entry} step loop: {total} "
                f"instructions for {steps} state-steps (MUFU): "
                f"{total / steps:.2f} a state-step, {fp32 / steps:.2f} FP32 "
                f"({top}); the tile loop around it holds {extra} more "
                f"(both copy paths, one runs)")
        if re.search(rf"ILi{N}E", entry):
            line += (f"; at B {B}, S {S}, D {D}, N {N} the step loop's issue "
                     f"bound is "
                     f"{total / steps * warp_steps / ISSUE_PER_S * 1e6:.2f}"
                     f" us, its FP32 pipe "
                     f"{fp32 / steps * warp_steps / ISSUE_PER_S * 1e6:.2f} us"
                     f", the SFU {B * S * D * N / SFU_PER_S * 1e6:.2f} us")
        print(line)
    B, S, D, N = K7_PREFILL_1
    args = _scan_inputs(B, S, D, N, torch.Generator().manual_seed(7), dev,
                        general=True)
    t = device_ms(lambda: ops.selective_scan(*args), reps=20, warmup=2)
    bound = max(_scan_bytes(B, S, D, N) / HBM_BYTES_PER_S,
                B * S * D * N * 8 / F32_FLOP_PER_S) * 1e3
    sfu = B * S * D * N / SFU_PER_S * 1e3
    print(f"[facts] selective_scan B {B}, S {S}, D {D}, N {N} (one "
          f"sequence's prefill): {t * 1e3:.2f} us, bound {bound * 1e3:.2f} "
          f"us (bytes), {bound / t:.1%} of it; SFU {sfu * 1e3:.2f} us, "
          f"{sfu / t:.1%} of it")


def phase_facts(dev) -> None:
    """What a kernel redesign rests on: each entry's registers, spills,
    shared memory (static, and dynamic where its launcher sets it) and
    resident blocks a SM; K7's SASS instruction mix and one sequence's
    prefill; K3 at one class beside ten, and the launch floor of K3 and K5
    at a 1x1 field."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"[facts] {sms} SMs")
    k7_entries = []
    for name in sorted(build.SOURCES):
        for e in _entries(build.BUILD_LOG.get(name, "")):
            short = _demangle(e["entry"])
            threads = BLOCK_THREADS.get(short, 256)
            dyn = _dynamic_smem(name, e["entry"])
            bps = _blocks_per_sm(e["regs"], e["smem"] + dyn, threads)
            print(f"[facts] {name}: {short} ({e['entry']}): {e['regs']} "
                  f"registers, {e['spill']} bytes spilled, {e['smem']} bytes "
                  f"static smem, {dyn} dynamic; {bps} blocks of {threads} "
                  f"threads a SM, {bps * sms} resident")
            if name == "selective_scan":
                k7_entries.append(e["entry"])
    _facts_k7(dev, k7_entries)
    gen = torch.Generator().manual_seed(99)
    B, n = 32, 200
    from repro_torch.core import diffraction as df
    from repro_torch.core.layers import Detector

    masks = Detector(df.Grid(n, 36e-6), 10, 20, device=dev).masks_t
    us = [_cfield((B, n, n), gen, dev) for _ in range(8)]
    it = iter(range(10 ** 9))
    for c in (10, 1):
        m = masks[:c].contiguous()
        t = device_ms(lambda: ops.intensity_readout_rows(us[next(it) % 8], m))
        print(f"[facts] intensity_readout 32x200x200, {c} masks: "
              f"{t * 1e3:.2f} us")
    tiny = _cfield((B, 1, 1), gen, dev)
    m1 = masks[:, :1, :1].contiguous()
    t = device_ms(lambda: ops.intensity_readout_rows(tiny, m1))
    print(f"[facts] intensity_readout 32x1x1, 10 masks (launch floor): "
          f"{t * 1e3:.2f} us")
    b1 = _cfield((1, 1), gen, dev)
    t = device_ms(lambda: ops.complex_mul_rows(tiny, b1))
    print(f"[facts] complex_mul 32x1x1 (launch floor): {t * 1e3:.2f} us")


def device_ms(fn, reps: int = 100, warmup: int = 5) -> float:
    """Device time per call: the stream is held by a sleep kernel while
    the host queues ``reps`` calls, so host overhead leaves no gaps (for
    a call of thousands of launches, such as K7's plain version, the host
    outruns the sleep and the time includes its dispatch)."""
    for _ in range(warmup):
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
    odd = _cfield((7, 37, 53), gen, dev)
    k3_cases = [("32x200x200 detector masks", _cfield((B, n, n), gen, dev),
                 det.masks_t),
                ("32x200x200 general masks", _cfield((B, n, n), gen, dev),
                 torch.randn((10, n, n), generator=gen).to(dev)),
                ("B 1, 200x200 detector masks", _cfield((1, n, n), gen, dev),
                 det.masks_t),
                ("B 33 (beyond one field group), 200x200",
                 _cfield((33, n, n), gen, dev), det.masks_t),
                ("odd 37x53 general masks", odd[:5],
                 torch.randn((10, 37, 53), generator=gen).to(dev)),
                ("odd 37x53, C 1", odd, torch.randn((1, 37, 53),
                                                    generator=gen).to(dev)),
                ("odd 37x53, C 17 (two class chunks)", odd,
                 torch.randn((17, 37, 53), generator=gen).to(dev)),
                ("odd 37x53, u[1:] (8-byte-aligned fields)", odd[1:],
                 torch.randn((10, 37, 53), generator=gen).to(dev))]
    for case, u, masks in k3_cases:
        got = ops.intensity_readout_rows(u, masks)
        again = ops.intensity_readout_rows(u, masks)
        if not torch.equal(got, again):
            raise AssertionError(f"intensity_readout/{case}: repeated runs "
                                 "differ")
        errs.append(_compare("intensity_readout", case, got,
                             ref.intensity_readout_ref(u, masks)))
    _hold_readout_batch_independence(dev, gen, det.masks_t)
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

    # K4: one shared phase plane, gamma a host float
    errs = []
    for case, shape in (("32x200x200 shared plane", (B, n, n)),
                        ("odd 37x53", (6, 37, 53))):
        u = _cfield(shape, gen, dev)
        phi = ((torch.rand(shape[1:], generator=gen) * 4 - 2)
               * math.pi).to(dev)
        errs.append(_compare("phase_apply", case,
                             ops.phase_apply_rows(u, phi, GAMMA),
                             ref.phase_apply_ref(u, phi, GAMMA)))
    us = [_cfield((B, n, n), gen, dev) for _ in range(8)]
    phi = (torch.rand((n, n), generator=gen) * 2 * math.pi).to(dev)
    it = iter(range(10 ** 9))
    kern = lambda: ops.phase_apply_rows(us[next(it) % 8], phi, GAMMA)  # noqa: E731
    plain = lambda: ref.phase_apply_ref(us[next(it) % 8], phi, GAMMA)  # noqa: E731
    rows["phase_apply"] = dict(
        max_abs_err=max(errs), ms=device_ms(kern), plain_ms=device_ms(plain),
        nbytes=B * n * n * 16 + n * n * 4,
        flops=B * n * n * 6 + n * n * 4,  # rotation; sincos + 2 per pixel
        library_ms=None)
    rows.update(kernels_k5(dev, gen))
    rows.update(kernels_k6(dev, gen))
    rows.update(kernels_k7(dev, gen))
    rows.update(kernels_transfer_planes(dev))
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
              f"{r['nbytes'] / 1e6:.2f} MB, {r['flops'] / 1e9:.2f} GFLOP), "
              f"{r['bound_ms'] / r['ms']:.1%} of the bound")
        if "exps" in r:
            r["sfu_bound_ms"] = r["exps"] / SFU_PER_S * 1e3
            print(f"[kernels] {k}: {r['exps'] / 1e9:.3f}e9 exps over the "
                  f"SFU rate {SFU_PER_S / 1e12:.2f}e12/s: "
                  f"{r['sfu_bound_ms'] * 1e3:.2f} us, the bound of this "
                  f"design, {r['sfu_bound_ms'] / r['ms']:.1%} of it")
    return rows


def _hold_close(what: str, got, want, tol: float) -> None:
    """The reference's assert_allclose(rtol=tol, atol=tol), elementwise."""
    got, want = got.cpu(), want.cpu()
    excess = ((got - want).abs() - tol * want.abs()).max().item()
    print(f"[physics] {what}: max(|a-b| - {tol:g}|b|) {excess:.3e} "
          f"(tol {tol:g})")
    if not excess <= tol:
        raise AssertionError(f"physics/{what}: {excess:.3e} > {tol:g}")


def _energies(u) -> torch.Tensor:
    return df.intensity(u).double().sum(dim=(-2, -1)).cpu()


def _physics_card_vs_cpu(grid, z: float, wl: float, dev) -> None:
    """The one-shot propagate on the card against its CPU copy, every
    method, with and without the band limit, and padded RS."""
    gen = torch.Generator().manual_seed(grid.n)
    u = _cfield((PHYSICS_BATCH, grid.n, grid.n), gen, "cpu")
    u_dev = u.to(dev)
    for method, band_limit, pad in ((df.RS, True, False),
                                    (df.RS, False, False),
                                    (df.FRESNEL, True, False),
                                    (df.FRESNEL, False, False),
                                    (df.RS, True, True),
                                    (df.FRAUNHOFER, True, False)):
        got = df.propagate(u_dev, grid, z, wl, method, band_limit, pad)
        want = df.propagate(u, grid, z, wl, method, band_limit, pad)
        _hold_out(f"n {grid.n} {method} band_limit {band_limit} pad {pad}",
                  got.cpu().numpy(), want.numpy(), False, tag="physics")


def _physics_identities(grid, z: float, wl: float, dev) -> None:
    """tests/test_diffraction.py's identities on the card at the config's
    grid, with the reference test's tolerances."""
    n = grid.n
    gen = torch.Generator().manual_seed(7 * n)
    u = _cfield((PHYSICS_BATCH, n, n), gen, dev)
    e0 = _energies(u)
    for method in (df.RS, df.FRESNEL):
        e = _energies(df.propagate(u, grid, z, wl, method, band_limit=False))
        rel = ((e - e0).abs() / e0).max().item()
        print(f"[physics] n {n} {method} unitary: max rel energy change "
              f"{rel:.3e} (tol 1e-4)")
        if not rel <= 1e-4:
            raise AssertionError(f"physics/n {n} {method} not unitary")
    # at the config's z the band limit passes the whole grid; at
    # PHYSICS_BL_Z it cuts the outer frequencies
    for zb in (z, PHYSICS_BL_Z):
        kept = _energies(df.propagate(u, grid, zb, wl, df.RS,
                                      band_limit=True)) / e0
        gain = kept.max().item() - 1.0
        print(f"[physics] n {n} band limit at z {zb} m: kept energy "
              f"{kept.min().item():.6f}..{kept.max().item():.6f}, max gain "
              f"{gain:.3e} (tol 1e-5)")
        if not gain <= 1e-5:
            raise AssertionError(f"physics/n {n}: the band limit added "
                                 "energy")
    z1, z2 = 0.4 * z, 0.6 * z
    for method in (df.RS, df.FRESNEL):
        two = df.propagate(df.propagate(u, grid, z1, wl, method, False),
                           grid, z2, wl, method, False)
        _hold_close(f"n {n} {method} two hops = one", two,
                    df.propagate(u, grid, z, wl, method, False), 2e-3)
    back = df.propagate(df.propagate(u, grid, z, wl, df.RS, False), grid,
                        -z, wl, df.RS, False)
    _hold_close(f"n {n} rs forward/backward", back, u, 2e-3)
    v = _cfield((PHYSICS_BATCH, n, n), gen, dev)
    for a, b in ((1.5, -0.25), (-2.0, 0.75)):
        p = lambda f: df.propagate(f, grid, z, wl)  # noqa: E731
        _hold_close(f"n {n} superposition a {a:+g} b {b:+g}",
                    p(a * u + b * v), a * p(u) + b * p(v), 1e-3)

    # a Gaussian of waist extent/16: w(z) at 1.5 Rayleigh ranges, and
    # Fresnel against RS at the config's distance
    c = torch.from_numpy(grid.coords())
    xx, yy = torch.meshgrid(c, c, indexing="ij")
    w0 = grid.extent / 16
    g0 = torch.exp(-(xx**2 + yy**2) / w0**2).to(torch.complex64).to(dev)
    zr = math.pi * w0**2 / wl
    inten = df.intensity(df.propagate(g0, grid, 1.5 * zr, wl, df.RS,
                                      band_limit=False)).double().cpu()
    w_meas = 2.0 * math.sqrt(((inten * xx**2).sum() / inten.sum()).item())
    w_theory = w0 * math.sqrt(1 + 1.5**2)
    off = abs(w_meas - w_theory) / w_theory
    print(f"[physics] n {n} Gaussian w0 {w0 * 1e6:.1f} um at z "
          f"{1.5 * zr:.3f} m: w {w_meas * 1e6:.2f} um vs theory "
          f"{w_theory * 1e6:.2f} um, {off:.3e} off (tol 0.05)")
    if not off < 0.05:
        raise AssertionError(f"physics/n {n}: Gaussian waist off theory")
    i_rs, i_fr = (df.intensity(df.propagate(g0, grid, z, wl, m)).cpu()
                  .double().ravel() for m in (df.RS, df.FRESNEL))
    corr = torch.corrcoef(torch.stack([i_rs, i_fr]))[0, 1].item()
    print(f"[physics] n {n} Fresnel vs RS at z {z} m: correlation "
          f"{corr:.6f} (> 0.999)")
    if not corr > 0.999:
        raise AssertionError(f"physics/n {n}: Fresnel far from RS")

    # a 20-pixel slit's far field: a sinc, its first zero on a sample
    slit = torch.zeros((n, n), dtype=torch.complex64)
    slit[:, n // 2 - 10:n // 2 + 10] = 1.0
    zf = 2.0
    row = df.intensity(df.propagate(slit.to(dev), grid, zf, wl,
                                    df.FRAUNHOFER)).cpu()[n // 2]
    x = np.fft.fftshift(np.fft.fftfreq(n, d=grid.pixel_size)) * wl * zf
    iz = int(np.argmin(np.abs(x - wl * zf / (20 * grid.pixel_size))))
    ratio = (row[iz] / row[n // 2]).item()
    print(f"[physics] n {n} slit sinc: peak at {int(row.argmax())} "
          f"(centre {n // 2}), first zero / peak {ratio:.3e} (< 0.01)")
    if int(row.argmax()) != n // 2 or not ratio < 0.01:
        raise AssertionError(f"physics/n {n}: slit far field is no sinc")


def phase_physics(dev) -> dict:
    """The paper's physics on the card: the one-shot propagate against
    its CPU copy and the physics identities at donn-mnist-5l's (n 200)
    and donn-xl-500's (n 500) grids, then donn-mnist-5l's plan through K1
    against chained propagate calls.  Returns that plan run's launches."""
    t0 = time.perf_counter()
    for arch in PHYSICS_ARCHS:
        cfg = get_config(arch)
        grid = df.Grid(cfg.n, cfg.pixel_size)
        _physics_card_vs_cpu(grid, cfg.distance, cfg.wavelength, dev)
        _physics_identities(grid, cfg.distance, cfg.wavelength, dev)

    # zero phases at gamma 1: every modulation is 1, so the stack is depth+1
    # free-space hops; the scan engine runs them through K1 (and K2 last)
    cfg = dataclasses.replace(get_config("donn-mnist-5l"), use_pallas=True)
    plan = plan_from_config(cfg, 1.0)
    grid = df.Grid(cfg.n, cfg.pixel_size)
    u = _cfield((PHYSICS_BATCH, cfg.n, cfg.n),
                torch.Generator().manual_seed(25), dev)
    phis = torch.zeros((cfg.depth, cfg.n, cfg.n), device=dev)
    with torch.no_grad():
        ops.reset_launch_counts()
        out = plan.propagate_final(plan.forward(phis, u))
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        want = u
        for z in cfg.gap_distances():
            want = df.propagate(want, grid, z, cfg.wavelength,
                                cfg.approximation, cfg.band_limit, cfg.pad)
    _hold_out(f"{cfg.name} plan through K1", out.cpu().numpy(),
              want.cpu().numpy(), False, tag="physics",
              against=f"{cfg.depth + 1} chained propagate calls")
    owed = {**dict.fromkeys(ops.KERNELS, 0),
            "conj_phase_scale": 2 * cfg.depth, "phase_tf_apply": 1}
    print(f"[physics] plan launches {launches} (owed {owed})")
    if launches != owed:
        raise AssertionError(f"physics: plan launches {launches} != {owed}")

    gen = torch.Generator().manual_seed(26)
    planes = [(torch.rand((cfg.n, cfg.n), generator=gen) * 4 - 2) * math.pi,
              torch.rand((cfg.n, cfg.n), generator=gen),
              (torch.rand((cfg.n, cfg.n), generator=gen) * 4 - 2) * math.pi,
              torch.rand((cfg.n, cfg.n), generator=gen)]
    planes = [p.to(dev) for p in planes]
    with torch.no_grad():
        _compare("fused_spectral_hop", f"{PHYSICS_BATCH}x{cfg.n}x{cfg.n} vs "
                 "fused_spectral_hop_ref", ops.fused_spectral_hop(u, *planes),
                 ops.fused_spectral_hop_ref(u, *planes))
    torch.cuda.synchronize()
    print(f"[physics] phase {time.perf_counter() - t0:.1f}s")
    return launches


def _hold_readout_batch_independence(dev, gen, masks) -> None:
    """K3 gives a field's readout to the bit whatever batch it is served
    in: one field at the serving buckets 1, 8 and 32 and at two positions,
    and an odd-H*W field alone (16-byte aligned) and at an odd position of
    a batch (8-byte aligned)."""
    u = _cfield((32, 200, 200), gen, dev)
    f = 5
    rows = {"bucket 32": ops.intensity_readout_rows(u, masks)[f],
            "bucket 8": ops.intensity_readout_rows(u[:8], masks)[f],
            "bucket 8 at position 2": ops.intensity_readout_rows(
                u[3:11], masks)[f - 3],
            "bucket 1": ops.intensity_readout_rows(u[f:f + 1], masks)[0]}
    odd = _cfield((9, 37, 53), gen, dev)
    omasks = torch.randn((10, 37, 53), generator=gen).to(dev)
    orows = {"in a batch of 9": ops.intensity_readout_rows(odd, omasks)[3],
             "alone, 8-byte aligned": ops.intensity_readout_rows(
                 odd[3:4], omasks)[0],
             "alone, 16-byte aligned": ops.intensity_readout_rows(
                 odd[3:4].clone(), omasks)[0]}
    for what, group in (("200x200 field 5", rows), ("37x53 field 3", orows)):
        first = next(iter(group.values()))
        same = {k: bool(torch.equal(v, first)) for k, v in group.items()}
        print(f"[kernels] intensity_readout {what}: bits equal {same}")
        if not all(same.values()):
            raise AssertionError(f"intensity_readout: {what} depends on its "
                                 "batch")


def kernels_k5(dev, gen) -> dict:
    """K5 complex_mul against its plain version; ``a * b`` timed beside."""
    B, n = 32, 200
    errs = []
    odd = _cfield((6, 37, 53), gen, dev)
    planes = _cfield((2, 37, 53), gen, dev)
    cases = [("32x200x200 shared plane", _cfield((B, n, n), gen, dev),
              _cfield((n, n), gen, dev)),
             ("odd 37x53, B 5 (a lone last element)", odd[:5], planes[0]),
             ("odd 37x53, a[1:] (8-byte-aligned start)", odd[1:], planes[0]),
             ("odd 37x53, a[1:3] (lone first and last elements), b "
              "8-byte aligned", odd[1:3], planes[1]),
             ("odd 37x53, B 1", odd[2:3].clone(), planes[1])]
    for case, a, b in cases:
        errs.append(_compare("complex_mul", case, ops.complex_mul_rows(a, b),
                             ref.complex_mul_ref(a, b)))
    as_ = [_cfield((B, n, n), gen, dev) for _ in range(8)]
    b = _cfield((n, n), gen, dev)
    lib_err = (as_[0] * b - ref.complex_mul_ref(as_[0], b)).abs().max().item()
    print(f"[kernels] complex_mul library a * b (timed only, not the port): "
          f"max_abs_err {lib_err:.3e} vs plain")
    it = iter(range(10 ** 9))
    return {"complex_mul": dict(
        max_abs_err=max(errs),
        ms=device_ms(lambda: ops.complex_mul_rows(as_[next(it) % 8], b)),
        plain_ms=device_ms(lambda: ref.complex_mul_ref(as_[next(it) % 8], b)),
        library_ms=device_ms(lambda: as_[next(it) % 8] * b),
        nbytes=B * n * n * 16 + n * n * 8, flops=B * n * n * 6)}


def _transfer(a, b, polar: bool) -> torch.Tensor:
    """H from a plane pair: amp e^{j theta} or hr + j hi, in f64."""
    a, b = a.double(), b.double()
    return b * torch.exp(1j * a) if polar else torch.complex(a, b)


def kernels_transfer_planes(dev) -> dict:
    """The design flow's plane build against its plain version (torch f64,
    on the card) at a DSE sweep's set: K=32 geometries drawn as the sweep
    draws them, L+1=6 gaps, 200x200, band limit on, both methods and both
    conventions.  H is held within TP_ATOL (theta alone is arbitrary where
    amp is 0 and wraps at +-pi).  Timed as the sweep builds it (rs,
    polar); the bound is the 61.4 MB the launch writes."""
    rng = np.random.default_rng(29)
    K, G, n = 32, 6, 200
    geo = torch.tensor(np.column_stack(
        [rng.uniform(8e-6, 56e-6, K), np.full(K, 532e-9)]
        + [rng.uniform(0.1, 0.5, K) for _ in range(G)]),
        dtype=torch.float64, device=dev)
    errs = []
    for method in ("rs", "fresnel"):
        for polar in (True, False):
            got = _transfer(*ops.transfer_planes_batched(
                geo, n, method, True, polar), polar)
            want = _transfer(*ref.transfer_planes_ref(
                geo, n, method, True, polar), polar)
            err = (got - want).abs().max().item()
            what = f"K {K}, {G} gaps, {n}x{n}, {method}, " + (
                "polar" if polar else "cartesian")
            print(f"[kernels] transfer_planes {what}: max|dH| {err:.3e} "
                  f"(tol {TP_ATOL:g})")
            if not err <= TP_ATOL:
                raise AssertionError(f"transfer_planes/{what}: {err:.3e} > "
                                     f"{TP_ATOL:g}")
            errs.append(err)
    return {"transfer_planes": dict(
        max_abs_err=max(errs),
        ms=device_ms(lambda: ops.transfer_planes_batched(
            geo, n, "rs", True, True)),
        plain_ms=device_ms(lambda: ref.transfer_planes_ref(
            geo, n, "rs", True, True), reps=10, warmup=2),
        # its writes bound it: the f64 work is not counted at the f32 rate
        nbytes=G * K * n * n * 4 * 2, flops=0, library_ms=None)}


def _hold_rope(what: str, got, want, x, cos, sin) -> float:
    """K6 against its plain version on x (..., S, D) with cos/sin (S, D//2):
    bf16 per element within ``ref.rope_rounding_bound``, f32 within
    ROPE_F32_RTOL of the max."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"rope/{what}: bad output {tuple(got.shape)}")
    err = (got - want).abs().max().item()
    if x.dtype == torch.bfloat16:
        bound = ref.rope_rounding_bound(x, cos, sin)
        ratio = ((got - want).abs() / bound.clamp_min(1e-30)).max().item()
        print(f"[kernels] rope {what}: max_abs_err {err:.3e}, worst "
              f"|diff| / (3 * 2^-8 (|x1 c| + |x2 s|)) {ratio:.3f} (tol 1)")
        if ratio > 1.0:
            raise AssertionError(f"rope/{what}: outside the rounding bound")
        return err
    rel = err / want.abs().max().item()
    print(f"[kernels] rope {what}: max_abs_err {err:.3e} rel {rel:.3e} "
          f"(tol {ROPE_F32_RTOL:g})")
    if rel > ROPE_F32_RTOL:
        raise AssertionError(f"rope/{what}: {rel:.3e} > {ROPE_F32_RTOL:g}")
    return err


def kernels_k6(dev, gen) -> dict:
    """K6 rope at the qwen1.5-4b prefill of 8 sequences: (8*20, 2048, 128)
    in bf16 (the row timed) and f32, and an odd shape."""
    BN, S, D = K6_SHAPE
    errs, rows = [], {}
    for dtype in (torch.bfloat16, torch.float32):
        for case, shape in (("odd (3, 37, 64)", (3, 37, 64)),
                            ("qwen1.5-4b prefill", (BN, S, D))):
            ang = torch.rand((shape[1], shape[2] // 2), generator=gen) * S
            cos, sin = (f(ang).to(dev, dtype) for f in (torch.cos, torch.sin))
            x = torch.randn(shape, generator=gen).to(dev, dtype)
            errs.append(_hold_rope(f"{case} {str(dtype)[6:]}",
                                   ops.rope_rows(x, cos, sin),
                                   ref.rope_ref(x, cos, sin), x, cos, sin))
        xs = [torch.randn((BN, S, D), generator=gen).to(dev, dtype)
              for _ in range(2)]
        it = iter(range(10 ** 9))
        esize = xs[0].element_size()
        row = dict(
            ms=device_ms(lambda: ops.rope_rows(xs[next(it) % 2], cos, sin)),
            plain_ms=device_ms(lambda: ref.rope_ref(xs[next(it) % 2], cos,
                                                    sin), reps=20),
            nbytes=2 * BN * S * D * esize + 2 * S * (D // 2) * esize,
            flops=BN * S * D * 3, library_ms=None)
        if dtype == torch.bfloat16:
            rows["rope"] = row
        else:
            t_bytes = row["nbytes"] / HBM_BYTES_PER_S * 1e3
            print(f"[kernels] rope f32 at the same shape: "
                  f"{row['ms'] * 1e3:.2f} us/launch, plain "
                  f"{row['plain_ms'] * 1e3:.2f} us, bound "
                  f"{t_bytes * 1e3:.2f} us (bytes: {row['nbytes'] / 1e6:.2f} "
                  f"MB)")
    rows["rope"]["max_abs_err"] = max(errs)
    return rows


def _scan_inputs(B, S, D, N, gen, dev, general=False):
    """K7 inputs.  A = -(n+1) is the s4d init the served mixer starts from;
    ``general`` takes A = -exp(randn(D, N)) and dt log-uniform over 1e-3..1,
    as a trained mixer has, which the structured A would hide."""
    if general:
        dt = torch.empty((B, S, D)).uniform_(math.log(1e-3), 0.0,
                                             generator=gen).exp()
    else:
        dt = 0.1 * torch.nn.functional.softplus(
            torch.randn((B, S, D), generator=gen))
    x = torch.randn((B, S, D), generator=gen)
    bs = torch.randn((B, S, N), generator=gen)
    cs = torch.randn((B, S, N), generator=gen)
    if general:
        a = -torch.exp(torch.randn((D, N), generator=gen))
    else:
        a = -torch.arange(1, N + 1, dtype=torch.float32).expand(D, N)
    return [t.to(dev).contiguous() for t in (dt, x, bs, cs, a)]


def scan_f64(dt, x, bs, cs, a):
    """The model's scan from h = 0 in float64: what the f32 kernel and the
    f32 plain version are both measured against, to tell how far each is
    from the exact result."""
    h0 = torch.zeros((x.shape[0], x.shape[2], a.shape[-1]),
                     dtype=torch.float64, device=x.device)
    y, _ = ssm._selective_scan(*(t.double() for t in (dt, bs, cs, x, a)),
                               h0, chunk=64)
    return y


def _scan_bytes(B, S, D, N) -> int:
    """dt and x read and y written once, B and C read once, A once."""
    return 3 * B * S * D * 4 + 2 * B * S * N * 4 + D * N * 4


def kernels_k7(dev, gen) -> dict:
    """K7 selective_scan against its plain version (the model's scan from
    h = 0): ragged D 203 (4-byte copies) with N 1, 4, 16 and 32 and S 37,
    not a multiple of the tile, at general A; D 260 (16-byte copies and a
    partial block) at S 35; the s4d A = -(n+1) at D 203 and D 64; the timed
    shape B 8, S 2048, D 8192, N 16 with both A.  Every case repeats to the
    bit, and a batch row computed alone equals it inside its batch."""
    errs = []
    cases = [(f"ragged D 203, S 37, N {N}, general A", (2, 37, 203, N), True)
             for N in (1, 4, 16, 32)]
    cases += [("D 260 (a partial block), S 35, N 16, general A",
               (3, 35, 260, 16), True),
              ("ragged D 203, S 37, N 16", (2, 37, 203, 16), False),
              ("D 64, S 37, N 4", (2, 37, 64, 4), False)]
    B, S, D, N = K7_SHAPE
    cases += [(f"B {B}, S {S}, D {D}, N {N}{', general A' * g}", K7_SHAPE, g)
              for g in (True, False)]
    for case, shape, general in cases:
        args = _scan_inputs(*shape, gen, dev, general)
        got = ops.selective_scan(*args)
        if not torch.equal(ops.selective_scan(*args), got):
            raise AssertionError(f"selective_scan/{case}: repeated runs "
                                 "differ")
        row = ops.selective_scan(*(t[1:2] if t.dim() == 3 else t
                                   for t in args))
        if not torch.equal(row, got[1:2]):
            raise AssertionError(f"selective_scan/{case}: batch row 1 alone "
                                 "differs from it inside the batch")
        want = ref.selective_scan_ref(*args)
        errs.append(_compare("selective_scan", case, got, want))
        if shape == K7_SHAPE and general:
            exact = scan_f64(*args)
            scale = exact.abs().max().item()
            print(f"[kernels] selective_scan {case} against float64: kernel "
                  f"{(got - exact).abs().max().item() / scale:.3e}, plain "
                  f"{(want - exact).abs().max().item() / scale:.3e} of the "
                  f"max")
            del exact
        del got, want
    # timed on the last case: the timed shape at the s4d A, the inputs the
    # earlier K7 times were taken on (the exps cost the same at any A)
    return {"selective_scan": dict(
        max_abs_err=max(errs),
        ms=device_ms(lambda: ops.selective_scan(*args), reps=10, warmup=2),
        plain_ms=device_ms(lambda: ref.selective_scan_ref(*args), reps=2,
                           warmup=1),
        nbytes=_scan_bytes(B, S, D, N), flops=B * S * D * N * 8,
        exps=B * S * D * N, library_ms=None)}


def _compare_grads(what: str, got, want, rtol: float) -> float:
    """max|got - want| / max|want| over a list of gradients; raises above
    ``rtol``."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().cpu(), w.detach().cpu()
        if g.shape != w.shape or not torch.isfinite(
                torch.view_as_real(g) if g.is_complex() else g).all():
            raise AssertionError(f"{what}: bad gradient {i} {tuple(g.shape)}")
        rel = ((g - w).abs().max() / w.abs().max()).item()
        worst = max(worst, rel)
    print(f"{what}: max rel err {worst:.3e} (tol {rtol:g})")
    if not worst <= rtol:
        raise AssertionError(f"{what}: {worst:.3e} > {rtol:g}")
    return worst


def phase_backward(dev) -> None:
    """Each autograd Function's backward on the card against autograd
    through its plain version on the card (32x200x200, shared planes)."""
    gen = torch.Generator().manual_seed(4321)
    B, n = 32, 200
    x = _cfield((B, n, n), gen, dev)
    w = _cfield((B, n, n), gen, dev)
    th_h = ((torch.rand((n, n), generator=gen) * 2 - 1) * math.pi).to(dev)
    amp_h = torch.rand((n, n), generator=gen).to(dev)
    th = (torch.rand((n, n), generator=gen) * 2 * math.pi).to(dev)
    amp = torch.full((n, n), GAMMA, device=dev)
    masks = torch.rand((10, n, n), generator=gen).to(dev)
    g = torch.rand((B, 10), generator=gen).to(dev)

    def project(out):
        return (w.real * out.real + w.imag * out.imag).sum()

    def plain_hop(a, t):
        s1 = ref.conj_phase_scale_ref(torch.fft.fft2(a), th_h[None],
                                      amp_h[None], B, -1.0, 1.0)
        return ref.conj_phase_scale_ref(torch.fft.fft2(s1), t[None],
                                        amp[None], B, 1.0, 1.0 / (n * n))

    cases = {
        "_PhaseTFApply": (
            lambda a, t: project(ops.phase_tf_apply(a, t, amp)),
            lambda a, t: project(ref.phase_tf_apply_ref(a, t[None],
                                                        amp[None], B))),
        "_FusedHop": (
            lambda a, t: project(ops.fused_spectral_hop(a, th_h, amp_h, t,
                                                        amp)),
            lambda a, t: project(plain_hop(a, t))),
        "_Readout": (
            lambda a, t: (ops.intensity_readout(a, masks) * g).sum(),
            lambda a, t: (ref.intensity_readout_ref(a, masks) * g).sum()),
        "_PhaseApply": (
            lambda a, t: project(ops.phase_apply(a, t, GAMMA)),
            lambda a, t: project(ref.phase_apply_ref(a, t, GAMMA))),
    }
    for name, (kern, plain) in cases.items():
        grads = []
        for fn in (kern, plain):
            a = x.clone().requires_grad_(True)
            t = th.clone().requires_grad_(True)
            wrt = [a] if name == "_Readout" else [a, t]
            what = "d field" if name == "_Readout" else "d field, d phase"
            grads.append(torch.autograd.grad(fn(a, t), wrt))
        torch.cuda.synchronize()
        _compare_grads(f"[kernels] {name} backward ({what}) vs "
                       f"autograd of the plain version", grads[0], grads[1],
                       KERNEL_RTOL)

    # K5 (d field, d plane) at 32x200x200; K6 (d x) at the qwen1.5-4b
    # prefill shape in f32, so the comparison is not one of bf16 roundings
    b = _cfield((n, n), gen, dev)
    BN, S, D = K6_SHAPE
    ang = torch.rand((S, D // 2), generator=gen) * 2048.0
    cos, sin = torch.cos(ang).to(dev), torch.sin(ang).to(dev)
    xr = torch.randn((BN, S, D), generator=gen).to(dev)
    wr = torch.randn((BN, S, D), generator=gen).to(dev)
    more = {
        "_ComplexMul": ((x, b),
                        lambda a, p: project(ops.complex_mul(a, p)),
                        lambda a, p: project(ref.complex_mul_ref(a, p)),
                        "d field, d plane"),
        "_Rope": ((xr,),
                  lambda a: (wr * ops.apply_rope(a, cos, sin)).sum(),
                  lambda a: (wr * ref.rope_ref(a, cos, sin)).sum(),
                  "d x"),
    }
    for name, (inputs, kern, plain, what) in more.items():
        grads = []
        for fn in (kern, plain):
            args = [t.clone().requires_grad_(True) for t in inputs]
            grads.append(torch.autograd.grad(fn(*args), args))
        torch.cuda.synchronize()
        _compare_grads(f"[kernels] {name} backward ({what}) vs autograd of "
                       f"the plain version", grads[0], grads[1], KERNEL_RTOL)


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
    if launches != expect or not all(launches[k] for k in SERVING_KERNELS):
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
        eng = engines[("float32", False)]
        _profile(lambda: eng.infer(x32), PROFILE_BATCHES, 1, "batch",
                 profile, p50 * 1e3)
    return launches


def _table_and_busy(prof, rows: int) -> tuple:
    """A profile's table (by device time) and the device's busy time in
    us: the self time of device-side events (kernels and copies), which
    the host-side ops' totals would count twice."""
    events = prof.key_averages()
    busy_us = sum(getattr(e, "self_device_time_total", None)
                  or getattr(e, "self_cuda_time_total", 0) for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    return events.table(sort_by="cuda_time_total", row_limit=rows), busy_us


def _profile(run, reps: int, units: int, unit: str, path: str,
             unprofiled_us: float) -> None:
    """torch.profiler table of ``reps`` calls of ``run`` (each doing
    ``units`` batches or steps) with the device's busy time and idle share
    per ``unit``, printed and written to ``path``."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(max(2, reps // 5)):
        run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            run()
        wall = time.perf_counter() - t0
    table, busy_us = _table_and_busy(prof, 25)
    n = reps * units
    per_us = busy_us / n
    wall_us = wall / n * 1e6
    table += (f"\n{n} {unit}s: device busy {per_us:.1f} us per {unit}; wall "
              f"{wall_us:.1f} us per {unit} under the profiler (idle share "
              f"{1 - per_us / wall_us:.1%}), unprofiled {unprofiled_us:.1f} "
              f"us per {unit} (idle share {1 - per_us / unprofiled_us:.1%})"
              f"\n")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(table)
    print(table)


def _hold_step(what: str, got, want, tag: str = "train") -> None:
    """Loss and every layer's d/dphase within SLICE_RTOL of the max."""
    (loss, _, grads), (wloss, _, wgrads) = got, want
    rel = abs(float(loss) - float(wloss)) / abs(float(wloss))
    print(f"[{tag}] {what}: loss {float(loss):.6f} vs {float(wloss):.6f} "
          f"(rel {rel:.3e}, tol {SLICE_RTOL:g})")
    if not (math.isfinite(float(loss)) and rel <= SLICE_RTOL):
        raise AssertionError(f"{what}: losses disagree")
    keys = sorted(wgrads["phase"])
    _compare_grads(f"[{tag}] {what}: d/dphase of {len(keys)} layers",
                   [grads["phase"][k] for k in keys],
                   [wgrads["phase"][k] for k in keys], SLICE_RTOL)


def phase_train(dev, smi: str, profile) -> dict:
    """donn-mnist-5l training on both engines; returns the counted
    launches and the per-step launches of each engine."""
    cfg = dataclasses.replace(get_config("donn-mnist-5l"), use_pallas=True)
    L = cfg.depth
    models = {
        "scan": build_model(cfg, device=dev),
        "eager": build_model(dataclasses.replace(cfg, engine="eager"),
                             device=dev),
    }
    params = models["scan"].init(torch.Generator().manual_seed(0))
    xs, ys = synth_digits(32, seed=0)
    C = cfg.num_classes

    # --- gradients: the card against a CPU copy, then eager against scan,
    # at the config's gamma and at the calibrated one.  At gamma 1.12 the
    # n=200 logits average ~190 and the softmax of the loss is saturated:
    # a logit's relative rounding error times its size reaches the
    # gradient, so two f32 paths on one CPU already differ by ~2e-5 there,
    # against ~1e-6 at the calibrated gamma (logits ~2).
    dx, dy = synth_digits(512, seed=0)
    gamma = calibrate_gamma(models["scan"], params, dx[:16])
    cpu_params = tree_map(lambda t: t.cpu(), params)
    for g in (cfg.gamma, gamma):
        gcfg = dataclasses.replace(cfg, gamma=g)
        scan = build_model(gcfg, device=dev)
        card = loss_and_grads(scan, params, xs, ys, C)
        _hold_step(f"gamma {g:.4f}: scan on the card vs the CPU copy "
                   f"(plain versions)", card,
                   loss_and_grads(build_model(gcfg, device="cpu"),
                                  cpu_params, xs, ys, C))
        eager = build_model(dataclasses.replace(gcfg, engine="eager"),
                            device=dev)
        _hold_step(f"gamma {g:.4f}: eager (K4) vs scan (K1/K2) on the card",
                   loss_and_grads(eager, params, xs, ys, C), card)

    # --- launches: TRAIN_STEPS counted optimizer steps per engine
    expect = train_launches_per_step(L)
    opt = AdamW(lr=1e-2)
    counted = dict.fromkeys(ops.KERNELS, 0)
    per_step = {}
    for eng, model in models.items():
        step = make_train_step(model, opt, C)
        p, st = params, opt.init(params)
        step(p, st, 0, xs, ys)  # cuFFT plans, first-use uploads
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        for i in range(TRAIN_STEPS):
            p, st, loss, _ = step(p, st, i, xs, ys)
        torch.cuda.synchronize()
        got = ops.launch_counts()
        want = {k: v * TRAIN_STEPS for k, v in expect[eng].items()}
        print(f"[train] {eng}: launches over {TRAIN_STEPS} steps {got} "
              f"(expected {want})")
        if got != want or not math.isfinite(float(loss)):
            raise AssertionError(f"{eng}: the training step did not run "
                                 "its kernels as counted")
        per_step[eng] = {k: v // TRAIN_STEPS for k, v in got.items()}
        for k, v in got.items():
            counted[k] += v

    # --- training works: a falling loss through the chunked driver.  At
    # the config's gamma the saturated softmax barely moves the loss in 40
    # steps; the reference's flow (examples/quickstart.py, paper §3.2)
    # calibrates gamma first.  The loss must fall at the calibrated gamma;
    # at the config's gamma the trajectory is reported, not asserted.
    for g, held in ((cfg.gamma, False), (gamma, True)):
        model = build_model(dataclasses.replace(cfg, gamma=g), device=dev)
        res = train_classifier(model, params,
                               batch_iterator(dx, dy, 32, seed=1), steps=40,
                               lr=0.3, steps_per_call=CHUNK)
        first = float(np.mean(res.losses[:8]))
        last = float(np.mean(res.losses[-8:]))
        print(f"[train] train_classifier 40 steps (gamma {g:.4f}, "
              f"{'calibrated, asserted' if held else 'config, reported'}, "
              f"lr 0.3, {CHUNK} per chunk) in {res.wall_time_s:.2f}s: "
              f"mean loss of the first 8 {first:.4f}, of the last 8 "
              f"{last:.4f}")
        print(f"[train]   losses of the first 8 steps "
              f"{[round(v, 5) for v in res.losses[:8]]}, of the last 8 "
              f"{[round(v, 5) for v in res.losses[-8:]]}")
        if held and not (np.all(np.isfinite(res.losses)) and last < first):
            raise AssertionError("train_classifier: the loss did not fall")

    # --- optimizer steps/s at batch 32: closed loops of CHUNK-step chunks
    # on device-resident batches (one sync per chunk), rows interleaved
    rows = [("scan + kernels (K1/K2/K3)", models["scan"]),
            ("eager + K4 (K4/K3)", models["eager"]),
            ("scan use_pallas=False (plain torch)",
             build_model(dataclasses.replace(cfg, use_pallas=False),
                         device=dev))]
    xs8 = torch.from_numpy(np.stack([xs] * CHUNK)).to(dev)
    ys8 = torch.from_numpy(np.stack([ys] * CHUNK)).to(dev)
    chunks = {label: make_train_chunk(m, opt, C) for label, m in rows}
    state = opt.init(params)
    perf = {label: [] for label, _ in rows}
    for rep in range(REPEATS):
        for label, _ in rows:
            fn = chunks[label]
            for _ in range(2):
                fn(params, state, 0, xs8, ys8)[2].cpu()
            n_steps = 0
            t0 = time.perf_counter()
            t_end = t0 + WINDOW_S
            while time.perf_counter() < t_end:
                fn(params, state, 0, xs8, ys8)[2].cpu()
                n_steps += CHUNK
            sps = n_steps / (time.perf_counter() - t0)
            perf[label].append(sps)
            print(f"[train] {label} (repeat {rep + 1}/{REPEATS}): "
                  f"{sps:.1f} optimizer steps/s at batch 32 over {n_steps} "
                  f"steps ({smi})")
    for label, v in perf.items():
        print(f"[train] {label}: steps/s {min(v):.1f}-{max(v):.1f} across "
              f"{REPEATS} repeats (spread {max(v) / min(v) - 1:.1%})")
    if profile:
        fn = chunks[rows[0][0]]
        _profile(lambda: fn(params, state, 0, xs8, ys8)[2].cpu(),
                 PROFILE_CHUNKS, CHUNK, "training step", profile + ".train",
                 1e6 / min(perf[rows[0][0]]))

    # --- train -> freeze -> serve through the CLI at the config's width
    rps = serve_donn.main(["--n", "200", "--depth", "5", "--distance",
                           "0.30", "--det-size", "20", "--use-pallas",
                           "--train-steps", "16", "--requests", "32",
                           "--device", "cuda"])
    if not rps > 0:
        raise AssertionError("serve_donn --train-steps served nothing")
    return {"counted": counted, "per_step": per_step}


def phase_cli() -> None:
    width = ["--n", "200", "--depth", "5", "--distance", "0.30",
             "--det-size", "20", "--use-pallas", "--device", "cuda"]
    rps = serve_donn.main(width + ["--requests", "64"])
    if not rps > 0:
        raise AssertionError("serve_donn served nothing")
    # the artifact flow at the same width: save, then cold-start a fleet
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cli_") as tmp:
        art = os.path.join(tmp, "artifact")
        rps = [serve_donn.main(width + ["--requests", "64",
                                        "--save-artifact", art])]
        rps.append(serve_donn.main(["--artifact", art, "--replicas", "2",
                                    "--requests", "256", "--device",
                                    "cuda"]))
    if not min(rps) > 0:
        raise AssertionError("serve_donn --artifact served nothing")


# --------------------------------------------------------------------------
# families: the paper's advanced DONNs (RGB, segmentation, heterogeneous)
# --------------------------------------------------------------------------
def family_launches(depth: int, channels: int = 1,
                    readout: bool = True) -> dict:
    """Kernel launches of one optimizer step on each engine and of one
    f32 serving batch, for an RGB (``channels`` > 1), segmentation
    (``readout=False``: it serves intensity maps, no K3) or classify
    DONN: the rule of ``train_launches_per_step``, K3 once over the B*C
    rows; the eager engine runs K4 once a channel and layer forward and
    once a channel and layer backward except layer 0's."""
    per = train_launches_per_step(depth)
    k3 = int(readout)
    return {
        "scan": {**per["scan"], "intensity_readout": k3},
        "eager": {**per["eager"], "phase_apply": channels * (2 * depth - 1),
                  "intensity_readout": k3},
        "serve": {**dict.fromkeys(ops.KERNELS, 0),
                  "conj_phase_scale": 2 * depth, "phase_tf_apply": 1,
                  "intensity_readout": k3},
    }


def _counted(run) -> dict:
    """Launches of ``run()`` alone: the counters are set to 0 just before
    it and read just after."""
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    run()
    torch.cuda.synchronize()
    return ops.launch_counts()


def _hold_launches(what: str, got: dict, per: dict, times: int,
                   tag: str = "families") -> None:
    want = {k: v * times for k, v in per.items()}
    print(f"[{tag}] {what}: launches {got} (expected {want})")
    if got != want:
        raise AssertionError(f"{what}: the kernels did not run as counted")


def _hold_out(what: str, got, want, argmax: bool, tag: str = "families",
              against: str = "the CPU copy") -> float:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{what}: bad output {got.shape}")
    rel = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
    same = (not argmax) or bool(np.array_equal(got.argmax(-1),
                                               want.argmax(-1)))
    print(f"[{tag}] {what}: rel err vs {against} {rel:.3e} (tol "
          f"{SLICE_RTOL:g}){', argmax equal' if argmax and same else ''}")
    if rel > SLICE_RTOL or not same:
        raise AssertionError(f"{what}: card and CPU disagree")
    return rel


def _serve_rows(family: str, runs, x, smi: str) -> dict:
    """req/s and per-batch p50/p99 at bucket 32 for each (label, engine),
    WINDOW_S seconds a row, REPEATS times, rows interleaved."""
    perf = {label: [] for label, _ in runs}
    for rep in range(REPEATS):
        for label, eng in runs:
            for _ in range(10):
                eng.infer(x)
            lat = []
            t_end = time.perf_counter() + WINDOW_S
            while time.perf_counter() < t_end:
                t0 = time.perf_counter()
                eng.infer(x)
                lat.append(time.perf_counter() - t0)
            lat_ms = np.asarray(lat) * 1e3
            r = dict(batches=len(lat),
                     req_s=len(x) * len(lat) / float(np.sum(lat)),
                     p50_ms=float(np.percentile(lat_ms, 50)),
                     p99_ms=float(np.percentile(lat_ms, 99)))
            perf[label].append(r)
            print(f"[families] {family} {label} (repeat {rep + 1}/"
                  f"{REPEATS}): {r['req_s']:.1f} req/s at bucket "
                  f"{len(x)} over {r['batches']} batches, per-batch p50 "
                  f"{r['p50_ms']:.4f} ms p99 {r['p99_ms']:.4f} ms ({smi})")
    for label, reps in perf.items():
        rps = [r["req_s"] for r in reps]
        print(f"[families] {family} {label}: req/s {min(rps):.1f}-"
              f"{max(rps):.1f} across {REPEATS} repeats")
    return perf


def _plane_major_costs(dev, B: int, C: int, n: int, L: int) -> None:
    """What K1's plane-stack contract costs one RGB serving batch at
    (B, C, n, n), beside its L fused hops (device times).  Between fused
    layers the transposes cancel: the field a hop hands back is a view of
    its plane-major slab, and the next hop's transpose of it is that slab
    again (checked here).  So a batch pays one copy into slabs before
    layer 0, one back before the final hop, and at every layer a C-fold
    copy of the shared TF pair."""
    gen = torch.Generator().manual_seed(77)
    u = _cfield((B, C, n, n), gen, dev)
    th = torch.rand((n, n), generator=gen).to(dev)
    phi = torch.rand((C, n, n), generator=gen).to(dev)
    gam = torch.full((C, n, n), GAMMA, device=dev)
    slab = ops._plane_major(u, (C,), n, n)[0]
    back = ops._from_plane_major(slab, C, B, (B,), (C,), n, n, False)
    views = ops._plane_major(back, (C,), n, n)[0].data_ptr() == \
        slab.data_ptr()
    t_in = device_ms(lambda: ops._plane_major(u, (C,), n, n))
    t_out = device_ms(lambda: back.reshape(-1, n, n))
    t_tf = device_ms(lambda: (th.expand((C, n, n)).contiguous(),
                              th.expand((C, n, n)).contiguous()))
    with torch.no_grad():
        t_hop = device_ms(lambda: ops.fused_spectral_hop(u, th, th, phi,
                                                         gam))
    copies = t_in + t_out + L * t_tf
    print(f"[families] rgb plane-major copies of a batch at {B}x{C}x{n}x{n}"
          f": slabs pass between layers as views {views}; into slabs "
          f"{t_in * 1e3:.2f} us, back {t_out * 1e3:.2f} us, the TF pair "
          f"C-fold {t_tf * 1e3:.2f} us a layer: {copies * 1e3:.2f} us beside "
          f"{L} fused hops of {t_hop * 1e3:.2f} us ({copies / (L * t_hop):.1%}"
          f")")


def _family_rgb(dev, smi: str, profile) -> dict:
    """donn-rgb at full width and depth: gamma calibrated, 3 training steps
    on each engine through make_train_chunk, frozen f32/bf16/int8 serving
    through InferenceEngine and MicroBatcher, each held against its CPU
    copy; timing rows kernel path vs plain torch."""
    cfg = dataclasses.replace(get_config("donn-rgb"), use_pallas=True)
    L, C, K = cfg.depth, cfg.channels, cfg.num_classes
    # scenes at the config's input size: what MicroBatcher admits
    S = cfg.input_size
    xs, ys = synth_rgb_scenes(4 * 32, seed=0, size=S)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    cpu_params = tree_map(lambda t: t.cpu(), params)
    gamma = calibrate_gamma(model, params, xs[:8])
    cfg = dataclasses.replace(cfg, gamma=gamma)
    print(f"[families] donn-rgb (n={cfg.n}, {C} channels, {K} classes, "
          f"depth {L}): gamma {get_config('donn-rgb').gamma} -> calibrated "
          f"{gamma:.4f}")
    per = family_launches(L, channels=C)
    launches = dict.fromkeys(ops.KERNELS, 0)
    xs3 = np.stack([xs[i * 32:(i + 1) * 32] for i in range(TRAIN_STEPS)])
    ys3 = np.stack([ys[i * 32:(i + 1) * 32] for i in range(TRAIN_STEPS)])
    opt = AdamW(lr=0.3)
    trained = None
    for engine in ("scan", "eager"):
        ecfg = dataclasses.replace(cfg, engine=engine)
        card_m = build_model(ecfg, device=dev)
        cpu_m = build_model(ecfg, device="cpu")
        _hold_step(f"donn-rgb {engine}: card vs the CPU copy",
                   loss_and_grads(card_m, params, xs[:32], ys[:32], K),
                   loss_and_grads(cpu_m, cpu_params, xs[:32], ys[:32], K))
        chunk = make_train_chunk(card_m, opt, K)
        chunk(params, opt.init(params), 0, xs3, ys3)  # plans, uploads
        out = {}
        got = _counted(lambda: out.update(
            r=chunk(params, opt.init(params), 0, xs3, ys3)))
        _hold_launches(f"donn-rgb {engine}, {TRAIN_STEPS} training steps "
                       f"(per step {per[engine]})", got, per[engine],
                       TRAIN_STEPS)
        for k, v in got.items():
            launches[k] += v
        losses = out["r"][2].cpu().numpy()
        want = make_train_chunk(cpu_m, opt, K)(
            cpu_params, opt.init(cpu_params), 0, xs3, ys3)[2].numpy()
        rel = float(np.max(np.abs(losses - want)) / np.max(np.abs(want)))
        print(f"[families] donn-rgb {engine}: losses of {TRAIN_STEPS} steps "
              f"{[round(float(v), 6) for v in losses]} vs the CPU copy's "
              f"(rel {rel:.3e}, tol {SLICE_RTOL:g})")
        if rel > SLICE_RTOL or not np.isfinite(losses).all():
            raise AssertionError(f"donn-rgb {engine}: losses disagree")
        if engine == "scan":
            trained = out["r"][0]

    # --- train -> freeze -> serve, f32/bf16/int8 planes, counted
    model = build_model(cfg, device=dev)
    cpu_model = build_model(cfg, device="cpu")
    cpu_trained = tree_map(lambda t: t.cpu(), trained)
    engines = {d: InferenceEngine(freeze(model, trained, plane_dtype=d,
                                         device=dev),
                                  buckets=(1, 8, 32), device=dev)
               for d in ("float32", "bfloat16", "int8")}
    for eng in engines.values():
        eng.warmup()
    x32 = synth_rgb_scenes(32, seed=7, size=S)[0]
    singles = synth_rgb_scenes(64, seed=8, size=S)[0]
    outs, mb_outs = {}, {}
    batches0 = sum(e.stats["batches"] for e in engines.values())

    def serve_all():
        for d, eng in engines.items():
            outs[d] = eng.infer(x32)
            mb = MicroBatcher(eng, max_wait_ms=2.0)
            futs = [mb.submit(x) for x in singles]
            mb_outs[d] = np.stack([f.result(timeout=120) for f in futs])
            if not mb.close() or mb.stats["served"] != len(singles):
                raise AssertionError(f"MicroBatcher {d}: {mb.stats}")

    got = _counted(serve_all)
    nb = sum(e.stats["batches"] for e in engines.values()) - batches0
    _hold_launches(f"donn-rgb serving, {nb} batches (per batch "
                   f"{per['serve']})", got, per["serve"], nb)
    for k, v in got.items():
        launches[k] += v
    for d in engines:
        dep_cpu = freeze(cpu_model, cpu_trained, plane_dtype=d, device="cpu")
        _hold_out(f"donn-rgb {d} planes, bucket 32", outs[d],
                  dep_cpu.forward(torch.from_numpy(x32)).numpy(), True)
        _hold_out(f"donn-rgb {d} planes, MicroBatcher", mb_outs[d],
                  dep_cpu.forward(torch.from_numpy(singles)).numpy(), True)

    plain = build_model(dataclasses.replace(cfg, use_pallas=False),
                        device=dev)
    plain_eng = InferenceEngine(freeze(plain, trained, device=dev),
                                buckets=(32,), device=dev)
    plain_eng.warmup()
    perf = _serve_rows("donn-rgb", [("float32 kernels", engines["float32"]),
                                    ("float32 use_pallas=False (plain "
                                     "torch)", plain_eng)], x32, smi)
    _plane_major_costs(dev, 32, C, cfg.n, L)
    if profile:
        p50 = min(r["p50_ms"] for r in perf["float32 kernels"])
        _profile(lambda: engines["float32"].infer(x32), PROFILE_BATCHES, 1,
                 "batch", profile + ".rgb", p50 * 1e3)
    return {"launches": launches, "per": per}


def _bce_grads(model, params, x, m):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = bce_segmentation_loss(
            model.apply(tree_unflatten(params, leaves), x, train=True), m)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), None, tree_unflatten(params, grads)


def _family_seg(dev, smi: str, profile) -> dict:
    """donn-seg at full width and depth: 3 AdamW steps of BCE on the
    layer-normed intensity (the step written by hand, as the reference's
    example does), held against the CPU copy; frozen f32 intensity maps
    at bucket 32 against the CPU copy; timing rows."""
    cfg = dataclasses.replace(get_config("donn-seg"), use_pallas=True)
    L = cfg.depth
    xs, ms = synth_seg(TRAIN_STEPS * 32, seed=0, size=cfg.n)
    model = build_model(cfg, device=dev)
    cpu_model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator(device=dev).manual_seed(1))
    per = family_launches(L, readout=False)
    opt = AdamW(lr=0.05)

    def steps(mdl, p, dev_):
        state, losses = opt.init(p), []
        for i in range(TRAIN_STEPS):
            xb = torch.from_numpy(xs[i * 32:(i + 1) * 32]).to(dev_)
            mb = torch.from_numpy(ms[i * 32:(i + 1) * 32]).to(dev_)
            loss, _, grads = _bce_grads(mdl, p, xb, mb)
            p, state = opt.update(grads, state, p, i)
            losses.append(loss)
        return p, torch.stack(losses)

    x0 = torch.from_numpy(xs[:32])
    m0 = torch.from_numpy(ms[:32])
    cpu_params = tree_map(lambda t: t.cpu(), params)
    _hold_step("donn-seg scan: BCE and d/dphase, card vs the CPU copy",
               _bce_grads(model, params, x0.to(dev), m0.to(dev)),
               _bce_grads(cpu_model, cpu_params, x0, m0))
    steps(model, params, dev)  # plans, uploads
    out = {}
    got = _counted(lambda: out.update(r=steps(model, params, dev)))
    _hold_launches(f"donn-seg scan, {TRAIN_STEPS} AdamW steps (per step "
                   f"{per['scan']})", got, per["scan"], TRAIN_STEPS)
    launches = dict(got)
    trained, losses = out["r"]
    want = steps(cpu_model, cpu_params, "cpu")[1].numpy()
    losses = losses.cpu().numpy()
    rel = float(np.max(np.abs(losses - want)) / np.max(np.abs(want)))
    print(f"[families] donn-seg: BCE of {TRAIN_STEPS} steps "
          f"{[round(float(v), 6) for v in losses]} vs the CPU copy's (rel "
          f"{rel:.3e}, tol {SLICE_RTOL:g})")
    if rel > SLICE_RTOL or not np.isfinite(losses).all():
        raise AssertionError("donn-seg: losses disagree")

    eng = InferenceEngine(freeze(model, trained, device=dev), buckets=(32,),
                          device=dev)
    eng.warmup()
    x32 = synth_seg(32, seed=7, size=cfg.n)[0]
    res = {}
    got = _counted(lambda: res.update(out=eng.infer(x32)))
    _hold_launches(f"donn-seg serving, 1 batch (per batch {per['serve']})",
                   got, per["serve"], 1)
    for k, v in got.items():
        launches[k] += v
    want = freeze(cpu_model, tree_map(lambda t: t.cpu(), trained),
                  device="cpu").forward(torch.from_numpy(x32)).numpy()
    if res["out"].shape != (32, cfg.n, cfg.n):
        raise AssertionError(f"donn-seg: bad maps {res['out'].shape}")
    _hold_out("donn-seg f32 intensity maps, bucket 32", res["out"], want,
              False)
    plain = build_model(dataclasses.replace(cfg, use_pallas=False),
                        device=dev)
    plain_eng = InferenceEngine(freeze(plain, trained, device=dev),
                                buckets=(32,), device=dev)
    plain_eng.warmup()
    perf = _serve_rows("donn-seg", [("float32 kernels", eng),
                                    ("float32 use_pallas=False (plain "
                                     "torch)", plain_eng)], x32, smi)
    if profile:
        p50 = min(r["p50_ms"] for r in perf["float32 kernels"])
        _profile(lambda: eng.infer(x32), PROFILE_BATCHES, 1, "batch",
                 profile + ".seg", p50 * 1e3)
    return {"launches": launches, "per": per}


def _family_hetero(dev) -> dict:
    """The repo's heterogeneous stack (hybrid-slm-printed: two fused
    segments and one resample stitch): forward, backward and frozen
    serving on the card, each held against its CPU copy."""
    cfg = dataclasses.replace(HYBRID_SLM_PRINTED, use_pallas=True)
    model = build_model(cfg, device=dev)
    cpu_model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator(device=dev).manual_seed(2))
    cpu_params = tree_map(lambda t: t.cpu(), params)
    print(f"[families] {cfg.name}: segments {model.plan.segment_slices}, "
          f"planes {[l.grid.n for l in model.layers]}")
    xs, ys = synth_digits(32, seed=3)
    x = torch.from_numpy(xs)
    out = {}
    launches = _counted(lambda: out.update(
        fwd=model.apply(params, x.to(dev)),
        grads=loss_and_grads(model, params, xs, ys, cfg.num_classes),
        served=InferenceEngine(freeze(model, params, device=dev),
                               buckets=(32,), device=dev).infer(xs)))
    per = family_launches(cfg.depth)
    want = {k: 2 * per["serve"][k] + per["scan"][k] for k in ops.KERNELS}
    print(f"[families] {cfg.name}: launches of a forward, a training step "
          f"and a frozen batch {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"{cfg.name}: the kernels did not run as "
                             "counted")
    _hold_out(f"{cfg.name} forward", out["fwd"].cpu().numpy(),
              cpu_model.apply(cpu_params, x).numpy(), True)
    _hold_step(f"{cfg.name}: card vs the CPU copy", out["grads"],
               loss_and_grads(cpu_model, cpu_params, xs, ys,
                              cfg.num_classes))
    _hold_out(f"{cfg.name} frozen f32 serving", out["served"],
              freeze(cpu_model, cpu_params, device="cpu").forward(x).numpy(),
              True)
    return {"launches": launches}


def phase_families(dev, smi: str, profile) -> dict:
    """The paper's advanced DONNs; returns each family's counted
    launches."""
    fams = {"rgb": _family_rgb(dev, smi, profile),
            "seg": _family_seg(dev, smi, profile),
            "hetero": _family_hetero(dev)}
    # the CLI a user serves them with, at the configs' widths and depth
    for fam, flag, width in (("rgb", "rgb", ["--n", "200", "--det-size",
                                               "20"]),
                             ("seg", "segmentation", ["--n", "350"])):
        rps = []
        got = _counted(lambda: rps.append(serve_donn.main(
            ["--family", flag, "--depth", "5", "--distance", "0.30",
             "--use-pallas", "--requests", "64", "--device", "cuda"]
            + width)))
        print(f"[families] serve_donn --family {flag}: launches {got}")
        if not (rps[0] > 0 and got["conj_phase_scale"]
                and got["phase_tf_apply"]
                and bool(got["intensity_readout"]) == (fam == "rgb")):
            raise AssertionError(f"serve_donn --family {flag}")
        for k, v in got.items():
            fams[fam]["launches"][k] += v
    for name in ("conj_phase_scale", "phase_tf_apply", "intensity_readout",
                 "phase_apply"):
        if not fams["rgb"]["launches"][name]:
            raise AssertionError(f"donn-rgb never launched {name}")
    return {f: r["launches"] for f, r in fams.items()}


# --------------------------------------------------------------------------
# design: the paper's design flow (Fig. 3, §4) — Gumbel codesign with
# noise, batched multi-candidate emulation, the DSE, remat, the flows
# --------------------------------------------------------------------------
DESIGN_K = 8  # candidates of the timed emulate_batch set
DESIGN_B = 32  # inputs a candidate
DESIGN_WINDOW_S = 0.75  # seconds a timed emulation row, repeat
REMAT_DEPTH = 16  # the depth whose peak memory each remat policy gets
_GUMBEL_NOISE = codesign.gumbel_noise


class _NoiseTape:
    """The card's Gumbel draws, recorded as CPU copies in call order and
    replayed in that order on the CPU copy: a CUDA generator and a CPU one
    draw different streams, so the CPU copy is handed the card's draws."""

    def __init__(self):
        self.draws, self.used = [], 0

    def record(self, generator, shape, dtype, device):
        g = _GUMBEL_NOISE(generator, shape, dtype, device)
        self.draws.append(g.cpu())
        return g

    def replay(self, generator, shape, dtype, device):
        g = self.draws[self.used]
        if tuple(g.shape) != tuple(shape):
            raise AssertionError(f"noise replay: {tuple(shape)} asked, "
                                 f"{tuple(g.shape)} recorded")
        self.used += 1
        return g.to(device, dtype)


@contextlib.contextmanager
def _noise(fn):
    """``codesign.gumbel_noise`` replaced by ``fn`` for the block."""
    codesign.gumbel_noise = fn
    try:
        yield
    finally:
        codesign.gumbel_noise = _GUMBEL_NOISE


def _add(total: dict, got: dict) -> None:
    for k, v in got.items():
        total[k] += v


def _peak_mb(run) -> float:
    """Peak device memory ``run()`` allocates above what was allocated
    before it (``torch.cuda.max_memory_allocated``), in MB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e6


def _design_gumbel(dev, smi: str) -> dict:
    """donn-mnist-5l with Gumbel codesign (256 levels) trained with noise
    on both engines through make_train_chunk; the card's draws replayed on
    the CPU copy; launches, peak memory and steps/s; a falling loss."""
    cfg = dataclasses.replace(get_config("donn-mnist-5l"), use_pallas=True,
                              codesign="gumbel")
    L, C = cfg.depth, cfg.num_classes
    params = build_model(cfg, device=dev).init(
        torch.Generator().manual_seed(0))
    cpu_params = tree_map(lambda t: t.cpu(), params)
    dx, dy = synth_digits(512, seed=0)
    # the saturated softmax at the config's gamma (PR 12) would starve
    # both the holds and the learning check: calibrate first
    gamma = calibrate_gamma(build_model(cfg, device=dev), params, dx[:16])
    cfg = dataclasses.replace(cfg, gamma=gamma)
    print(f"[design] gumbel donn-mnist-5l (n={cfg.n}, depth {L}, "
          f"{cfg.device_levels} levels): gamma calibrated {gamma:.4f}")
    xs, ys = dx[:32], dy[:32]
    xs3 = np.stack([dx[i * 32:(i + 1) * 32] for i in range(TRAIN_STEPS)])
    ys3 = np.stack([dy[i * 32:(i + 1) * 32] for i in range(TRAIN_STEPS)])
    per = train_launches_per_step(L)
    opt = AdamW(lr=0.3)
    launches = dict.fromkeys(ops.KERNELS, 0)
    models = {}
    for engine in ("scan", "eager"):
        ecfg = dataclasses.replace(cfg, engine=engine)
        card_m = models[engine] = build_model(ecfg, device=dev)
        cpu_m = build_model(ecfg, device="cpu")
        gen = torch.Generator(device=dev).manual_seed(1)
        tape = _NoiseTape()
        with _noise(tape.record):
            card = loss_and_grads(card_m, params, xs, ys, C, gen)
        with _noise(tape.replay):
            want = loss_and_grads(cpu_m, cpu_params, xs, ys, C,
                                  torch.Generator())
        _hold_step(f"gumbel {engine}, one step on the card's draws: card vs "
                   f"the CPU copy", card, want, tag="design")
        chunk = make_train_chunk(card_m, opt, C, needs_rng=True)
        chunk(params, opt.init(params), 0, xs3, ys3, gen)  # plans, uploads
        tape, out = _NoiseTape(), {}
        with _noise(tape.record):
            got = _counted(lambda: out.update(
                r=chunk(params, opt.init(params), 0, xs3, ys3, gen)))
        _hold_launches(f"gumbel {engine}, {TRAIN_STEPS} training steps with "
                       f"noise (per step {per[engine]})", got, per[engine],
                       TRAIN_STEPS, tag="design")
        if len(tape.draws) != TRAIN_STEPS * L:
            raise AssertionError(f"gumbel {engine}: {len(tape.draws)} draws "
                                 f"for {TRAIN_STEPS} steps of {L} layers")
        _add(launches, got)
        losses = out["r"][2].cpu().numpy()
        with _noise(tape.replay):
            want = make_train_chunk(cpu_m, opt, C, needs_rng=True)(
                cpu_params, opt.init(cpu_params), 0, xs3, ys3,
                torch.Generator())[2].numpy()
        rel = float(np.max(np.abs(losses - want)) / np.max(np.abs(want)))
        print(f"[design] gumbel {engine}: losses of {TRAIN_STEPS} steps "
              f"{[round(float(v), 6) for v in losses]} vs the CPU copy's on "
              f"the same draws (rel {rel:.3e}, tol {SLICE_RTOL:g})")
        if rel > SLICE_RTOL or not np.isfinite(losses).all():
            raise AssertionError(f"gumbel {engine}: losses disagree")

    # peak memory of one optimizer step and steps/s at batch 32, against
    # the qat step of the main path (rows interleaved)
    rows = [("gumbel scan + kernels", models["scan"], True),
            ("gumbel eager + K4", models["eager"], True),
            ("qat scan + kernels", build_model(
                dataclasses.replace(cfg, codesign="qat"), device=dev), False)]
    gen = torch.Generator(device=dev).manual_seed(2)
    xs8 = torch.from_numpy(np.stack([xs] * CHUNK)).to(dev)
    ys8 = torch.from_numpy(np.stack([ys] * CHUNK)).to(dev)
    state = opt.init(params)
    for label, m, noisy in rows:
        step = make_train_step(m, opt, C, needs_rng=noisy)
        step(params, state, 0, xs, ys, gen)
        mb = _peak_mb(lambda: step(params, state, 0, xs, ys, gen))
        print(f"[design] {label}: peak memory of one training step at batch "
              f"32 {mb:.1f} MB above the resident state ({smi})")
    chunks = {label: make_train_chunk(m, opt, C, needs_rng=noisy)
              for label, m, noisy in rows}
    perf = {label: [] for label, _, _ in rows}
    for rep in range(REPEATS):
        for label, _, _ in rows:
            fn = chunks[label]
            fn(params, state, 0, xs8, ys8, gen)[2].cpu()
            n_steps, t0 = 0, time.perf_counter()
            while time.perf_counter() < t0 + WINDOW_S:
                fn(params, state, 0, xs8, ys8, gen)[2].cpu()
                n_steps += CHUNK
            sps = n_steps / (time.perf_counter() - t0)
            perf[label].append(sps)
            print(f"[design] {label} (repeat {rep + 1}/{REPEATS}): {sps:.1f} "
                  f"optimizer steps/s at batch 32 over {n_steps} steps "
                  f"({smi})")
    for label, v in perf.items():
        print(f"[design] {label}: steps/s {min(v):.1f}-{max(v):.1f} across "
              f"{REPEATS} repeats")

    # training works with noise: the loss falls over 40 steps
    res = train_classifier(models["scan"], params,
                           batch_iterator(dx, dy, 32, seed=1), steps=40,
                           lr=0.3, steps_per_call=CHUNK, needs_rng=True,
                           rng=torch.Generator(device=dev).manual_seed(3))
    first, last = (float(np.mean(res.losses[:8])),
                   float(np.mean(res.losses[-8:])))
    print(f"[design] gumbel train_classifier 40 steps with noise (lr 0.3, "
          f"{CHUNK} per chunk) in {res.wall_time_s:.2f}s: mean loss of the "
          f"first 8 {first:.4f}, of the last 8 {last:.4f}")
    if not (np.all(np.isfinite(res.losses)) and last < first):
        raise AssertionError("gumbel training: the loss did not fall")
    return launches


def _geometries(base, points):
    return [dataclasses.replace(base, name=f"{base.name}-{i}",
                                wavelength=float(lam), pixel_size=float(d),
                                distance=float(D))
            for i, (lam, d, D) in enumerate(points)]


def _emulation_rows(what: str, cfgs, params, x, smi: str, **kw) -> dict:
    """One emulate_batch call over the candidates against K sequential
    ``build_model(c).apply`` calls (fresh models, as a sweep without the
    emulation runtime builds them) and against the cached models' apply:
    host clock around work that ends in a synchronize, DESIGN_WINDOW_S
    seconds a row, REPEATS times, rows interleaved."""
    plist = params if isinstance(params, (list, tuple)) else [params] * len(
        cfgs)
    xt = torch.from_numpy(x).to(_dev_of(plist[0]))

    def seq(build):
        return [build(c).apply(p, xt, **kw) for c, p in zip(cfgs, plist)]

    runs = [
        ("emulate_batch", lambda: emulate_batch(
            cfgs, params, x, device=xt.device, **kw)),
        ("K x build_model(c).apply", lambda: seq(
            lambda c: build_model(c, device=xt.device))),
        ("K x cached_model(c).apply", lambda: seq(
            lambda c: cached_model(c, device=xt.device))),
    ]
    perf = {label: [] for label, _ in runs}
    for rep in range(REPEATS):
        for label, fn in runs:
            fn()
            torch.cuda.synchronize()
            n, t0 = 0, time.perf_counter()
            while time.perf_counter() < t0 + DESIGN_WINDOW_S:
                fn()
                torch.cuda.synchronize()
                n += 1
            perf[label].append((time.perf_counter() - t0) / n * 1e3)
    for label, v in perf.items():
        print(f"[design] {what}: {label} {min(v):.3f}-{max(v):.3f} ms a call "
              f"over {REPEATS} repeats of {DESIGN_WINDOW_S:g} s ({smi})")
    ratio = min(perf["K x build_model(c).apply"]) / min(perf["emulate_batch"])
    print(f"[design] {what}: emulate_batch {ratio:.2f}x faster than K "
          f"sequential build_model(c).apply, "
          f"{min(perf['K x cached_model(c).apply']) / min(perf['emulate_batch']):.2f}x "
          f"than K applies of cached models")
    return perf


def _dev_of(params) -> torch.device:
    return tree_leaves(params)[0].device


def _design_set(what: str, cfgs, params, x, per_call: dict, smi: str,
                argmax: bool = True, timed: bool = False, **kw):
    """emulate_batch on the card, counted and held against K sequential
    ``build_model(c).apply`` calls on the card and against the same call
    on CPU copies; optionally timed against the sequential calls.
    Returns the launches and the timed rows (None when not timed)."""
    dev = _dev_of(params if not isinstance(params, (list, tuple))
                  else params[0])
    out = {}
    got = _counted(lambda: out.update(
        b=emulate_batch(cfgs, params, x, device=dev, **kw)))
    # a set's first call builds its planes: one launch for the set
    _hold_launches(f"{what}: one emulate_batch call of {len(cfgs)} "
                   f"candidates", got, {**per_call, "transfer_planes": 1}, 1,
                   tag="design")
    plist = params if isinstance(params, (list, tuple)) else [params] * len(
        cfgs)
    xt = torch.from_numpy(x).to(dev)
    seq = torch.stack([build_model(c, device=dev).apply(p, xt, **kw)
                       for c, p in zip(cfgs, plist)])
    got_b = out["b"].cpu().numpy()
    _hold_out(f"{what}: emulate_batch", got_b, seq.cpu().numpy(), argmax,
              tag="design", against=f"{len(cfgs)} sequential "
                                    "build_model(c).apply on the card")
    cpu_params = [tree_map(lambda t: t.cpu(), p) for p in plist]
    want = emulate_batch(cfgs, cpu_params if isinstance(
        params, (list, tuple)) else cpu_params[0], x, device="cpu", **kw)
    _hold_out(f"{what}: emulate_batch", got_b, want.numpy(), argmax,
              tag="design")
    perf = _emulation_rows(what, cfgs, params, x, smi, **kw) if timed \
        else None
    return got, perf


def _design_emulation(dev, smi: str, profile) -> dict:
    """emulate_batch at donn-mnist-5l's width: K=8 geometries, a mixed-
    depth set (2-5, masked) and sensitivity_analysis's 15 points, each
    held and timed against K sequential applies; one donn-rgb and one
    donn-seg set (skip, train=True) at K=4; then the DSE's explore and
    sensitivity_analysis through emulate_batch against the sequential
    emulate."""
    base = dataclasses.replace(get_config("donn-mnist-5l"), use_pallas=True)
    L = base.depth
    launches = dict.fromkeys(ops.KERNELS, 0)
    cls_call = {**dict.fromkeys(ops.KERNELS, 0), "conj_phase_scale": 2 * L,
                "phase_tf_apply": 1, "intensity_readout": 1}
    x = _digits(DESIGN_B, seed=11)
    points = [(lam, d, D) for lam, d, D in (
        (532e-9, 36e-6, 0.30), (480e-9, 36e-6, 0.30), (600e-9, 36e-6, 0.30),
        (532e-9, 32e-6, 0.26), (532e-9, 40e-6, 0.34), (480e-9, 40e-6, 0.26),
        (600e-9, 32e-6, 0.34), (633e-9, 42e-6, 0.33))][:DESIGN_K]
    cfgs = _geometries(base, points)
    plist = [build_model(c, device=dev).init(
        torch.Generator(device=dev).manual_seed(10 + k))
        for k, c in enumerate(cfgs)]
    print(f"[design] emulate_batch: donn-mnist-5l geometries (wavelength, "
          f"pitch, distance) {points}, batch {DESIGN_B}")
    got, perf = _design_set(f"K={DESIGN_K} geometries", cfgs, plist, x,
                            cls_call, smi, timed=True)
    _add(launches, got)
    if profile:
        _profile(lambda: emulate_batch(cfgs, plist, x, device=dev),
                 PROFILE_BATCHES, 1, "emulate_batch call", profile + ".design",
                 min(perf["emulate_batch"]) * 1e3)
    depths = (2, 3, 4, 5)
    mixed = [dataclasses.replace(c, depth=d) for c, d in zip(cfgs, depths)]
    mplist = [build_model(c, device=dev).init(
        torch.Generator(device=dev).manual_seed(20 + k))
        for k, c in enumerate(mixed)]
    _add(launches, _design_set(f"mixed depths {depths} (masked to depth "
                               f"{max(depths)})", mixed, mplist, x,
                               {**cls_call,
                                "conj_phase_scale": 2 * max(depths)}, smi,
                               timed=True)[0])
    best = (532e-9, 36e-6, 0.30)
    sens_pts = []
    for idx in range(3):
        for delta in (-0.10, -0.05, 0.0, 0.05, 0.10):
            p = list(best)
            p[idx] *= 1.0 + delta
            sens_pts.append(tuple(p))
    sens = _geometries(base, sens_pts)
    shared = plist[0]
    _add(launches, _design_set("sensitivity_analysis's 15 points (shared "
                               "params)", sens, shared, x, cls_call, smi,
                               timed=True)[0])

    rgb = dataclasses.replace(get_config("donn-rgb"), use_pallas=True)
    rgb_cfgs = _geometries(rgb, points[:4])
    rp = [build_model(c, device=dev).init(
        torch.Generator(device=dev).manual_seed(30 + k))
        for k, c in enumerate(rgb_cfgs)]
    xr = synth_rgb_scenes(16, seed=12, size=rgb.input_size)[0]
    _add(launches, _design_set("donn-rgb K=4 (K3 over K*C*B rows)", rgb_cfgs,
                               rp, xr, {**cls_call,
                                        "conj_phase_scale": 2 * rgb.depth},
                               smi)[0])
    seg = dataclasses.replace(get_config("donn-seg"), use_pallas=True)
    seg_cfgs = _geometries(seg, points[:4])
    sp = [build_model(c, device=dev).init(
        torch.Generator(device=dev).manual_seed(40 + k))
        for k, c in enumerate(seg_cfgs)]
    xsg = synth_seg(16, seed=13, size=seg.n)[0]
    _add(launches, _design_set(
        "donn-seg K=4 (skip from layer 0, train=True)", seg_cfgs, sp, xsg,
        {**dict.fromkeys(ops.KERNELS, 0), "conj_phase_scale": 2 * seg.depth,
         "phase_tf_apply": 2}, smi, argmax=False, train=True)[0])

    # the DSE on the card: explore's top-k verification and the
    # sensitivity analysis through emulate_batch against the sequential
    # emulate, on a continuous figure of merit in [0, 1] where the DSE
    # expects an accuracy (1 - half the MSE-softmax loss, which lies in
    # [0, 2], of the shared parameters' logits), so no tie decides a pick
    y = torch.from_numpy(synth_digits(DESIGN_B, seed=11)[1]).to(dev)
    xt = torch.from_numpy(x).to(dev)

    def score(logits):
        return 1.0 - 0.5 * float(mse_softmax_loss(logits, y,
                                                  base.num_classes))

    def emulate(point):
        c = _geometries(base, [point])[0]
        return score(build_model(c, device=dev).apply(shared, xt))

    def batch(points_):
        return [score(o) for o in emulate_batch(
            _geometries(base, points_), shared, x, device=dev)]

    pts, merit = [], []
    for lam in (432e-9, 632e-9):
        grid = [(lam, d, D) for d in (30e-6, 36e-6, 42e-6)
                for D in (0.26, 0.30, 0.34)]
        pts += grid
        merit += batch(grid)
    model = dse.LightRidgeDSE(n_estimators=200).fit(pts, merit)
    cand = [(d, D) for d in (30e-6, 33e-6, 36e-6, 39e-6, 42e-6)
            for D in (0.26, 0.30, 0.34)]
    res_b = model.explore(532e-9, cand, emulate_batch=batch, top_k=4)
    res_s = model.explore(532e-9, cand, emulate=emulate, top_k=4)
    rel = abs(res_b.verified_acc - res_s.verified_acc) / abs(
        res_s.verified_acc)
    print(f"[design] DSE explore at 532 nm over {len(cand)} candidates, top "
          f"4 verified: emulate_batch picks {res_b.best_point} "
          f"({res_b.verified_acc:.6f}), sequential emulate picks "
          f"{res_s.best_point} ({res_s.verified_acc:.6f}), rel {rel:.3e}")
    if res_b.best_point != res_s.best_point or rel > SLICE_RTOL:
        raise AssertionError("DSE explore: batched and sequential differ")
    out_b = dse.sensitivity_analysis(None, best, emulate_batch=batch)
    out_s = dse.sensitivity_analysis(emulate, best)
    worst = max(abs(a - b) / abs(b) for k in out_s
                for (_, a), (_, b) in zip(out_b[k], out_s[k]))
    print(f"[design] DSE sensitivity_analysis at {best}: batched vs "
          f"sequential scores rel {worst:.3e} (tol {SLICE_RTOL:g}); "
          f"{ {k: [round(v, 5) for _, v in r] for k, r in out_b.items()} }")
    if worst > SLICE_RTOL:
        raise AssertionError("sensitivity_analysis: batched and sequential "
                             "differ")
    return launches


def _design_remat(dev, smi: str) -> dict:
    """remat "layer"/"segment" against "none" at depth 5 (loss, d/dphase,
    launches of a step: K1 2L more, the recompute), and the peak memory
    of a training step at depth REMAT_DEPTH under each policy."""
    base = dataclasses.replace(get_config("donn-mnist-5l"), use_pallas=True)
    L, C = base.depth, base.num_classes
    xs, ys = synth_digits(32, seed=5)
    params = build_model(base, device=dev).init(
        torch.Generator().manual_seed(6))
    per = train_launches_per_step(L)["scan"]
    launches = dict.fromkeys(ops.KERNELS, 0)
    ref_step = None
    for remat in ("none", "layer", "segment"):
        model = build_model(dataclasses.replace(base, remat=remat),
                            device=dev)
        out = {}
        got = _counted(lambda: out.update(
            r=loss_and_grads(model, params, xs, ys, C)))
        extra = 0 if remat == "none" else 2 * L
        _hold_launches(f"remat={remat}, one training step", got,
                       {**per, "conj_phase_scale": per["conj_phase_scale"]
                        + extra}, 1, tag="design")
        _add(launches, got)
        if ref_step is None:
            ref_step = out["r"]
        else:
            _hold_step(f"remat={remat} vs none at depth {L}", out["r"],
                       ref_step, tag="design")
    # peak memory at depth 16: the kernel path (K1's Function keeps one
    # field a layer) and the plain path (each multiply keeps its operands)
    deep = dataclasses.replace(base, depth=REMAT_DEPTH)
    dparams = build_model(deep, device=dev).init(
        torch.Generator().manual_seed(7))
    for use_pallas in (True, False):
        for remat in ("none", "layer", "segment"):
            model = build_model(dataclasses.replace(
                deep, remat=remat, use_pallas=use_pallas), device=dev)
            loss_and_grads(model, dparams, xs, ys, C)
            mb = _peak_mb(lambda: loss_and_grads(model, dparams, xs, ys, C))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                loss_and_grads(model, dparams, xs, ys, C)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / 5 * 1e3
            print(f"[design] remat={remat} at depth {REMAT_DEPTH}, batch 32, "
                  f"use_pallas={use_pallas}: peak memory of a training step "
                  f"{mb:.1f} MB above the resident state, {ms:.3f} ms a step "
                  f"({smi})")
    return launches


def _design_flows(dev) -> dict:
    """The two example flows on the card: examples/quickstart.py (DSL ->
    calibrated gamma -> chunked training -> evaluation -> SLM export ->
    frozen serving; synthetic accuracy >= 0.95 asserted) and the four steps
    of examples/donn_codesign_flow.py, the DSE verified through
    emulate_batch against the sequential emulation."""
    launches = {}
    xs, ys = synth_digits(1024, seed=0)

    def quickstart():
        src = dsl.laser(wavelength=532e-9, profile="plane")
        layers = [dsl.layers.diffractlayer_raw(distance=0.05,
                                               pixel_size=36e-6, size=64)
                  for _ in range(3)]
        det = dsl.layers.detector(num_classes=10, det_size=8, distance=0.05)
        model, cfg = dsl.models.sequential(layers, det, laser=src,
                                           name="quickstart", use_pallas=True,
                                           device=dev)
        params = model.init(torch.Generator().manual_seed(0))
        g = calibrate_gamma(model, params, xs[:16])
        model = dsl.from_config(dataclasses.replace(cfg, gamma=g),
                                device=dev)
        res = train_classifier(model, params,
                               batch_iterator(xs, ys, 64, seed=1),
                               steps=150, lr=0.5, steps_per_call=10)
        acc = evaluate_classifier(model, res.params,
                                  batch_iterator(xs, ys, 128, seed=2), 4)
        levels = [len(np.unique(codesign.to_slm(
            phi, codesign.DeviceSpec(levels=256))))
            for phi in res.params["phase"].values()]
        eng = InferenceEngine(freeze(model, res.params, device=dev),
                              buckets=(1, 8, 32), device=dev)
        served = float(np.mean(eng.infer(xs[:32]).argmax(-1) == ys[:32]))
        print(f"[design] quickstart (DSL, n=64, depth 3, gamma {g:.4f}): "
              f"150 steps in {res.wall_time_s:.2f}s, loss "
              f"{np.mean(res.losses[:10]):.4f} -> "
              f"{np.mean(res.losses[-10:]):.4f}, eval accuracy {acc:.4f} "
              f"(gate 0.95), SLM levels used {levels}, served 32 frozen "
              f"requests at accuracy {served:.4f}")
        if not acc >= 0.95:
            raise AssertionError(f"quickstart: accuracy {acc:.4f} < 0.95")

    launches["quickstart"] = _counted(quickstart)
    print(f"[design] quickstart launches {launches['quickstart']}")

    N = 64

    def point_cfg(point, **kw):
        lam, d, D = point
        return DONNConfig(name="dse", n=N, pixel_size=float(d),
                          wavelength=float(lam), distance=float(D), depth=2,
                          det_size=8, use_pallas=True, **kw)

    ev_x, ev_y = [], []
    it = batch_iterator(xs, ys, 64, seed=2)
    for _ in range(2):
        bx, by = next(it)
        ev_x.append(bx)
        ev_y.append(by)
    ev_x, ev_y = np.concatenate(ev_x), np.concatenate(ev_y)

    def short_train(point):
        model = build_model(point_cfg(point), device=dev)
        params = model.init(torch.Generator().manual_seed(0))
        return model, train_classifier(
            model, params, batch_iterator(xs, ys, 64, seed=1), steps=12,
            lr=0.5).params

    def short_emulation(point) -> float:
        """The example's accuracy proxy: 12 steps, then 2 eval batches."""
        model, params = short_train(point)
        return evaluate_classifier(model, params,
                                   batch_iterator(xs, ys, 64, seed=2), 2)

    def verify_batch(points_):
        """The top-k verification in one emulate_batch call: each point
        trained as short_emulation trains it, then all scored at once."""
        plist = [short_train(p)[1] for p in points_]
        out = emulate_batch([point_cfg(p) for p in points_], plist, ev_x,
                            device=dev).cpu().numpy()
        return [float(np.mean(o.argmax(-1) == ev_y)) for o in out]

    def codesign_flow():
        grid_d = np.linspace(12e-6, 48e-6, 4)
        grid_D = np.linspace(0.02, 0.08, 4)
        pts, accs = [], []
        for lam in (432e-9, 632e-9):
            for d in grid_d:
                for D in grid_D:
                    pts.append((lam, float(d), float(D)))
                    accs.append(short_emulation(pts[-1]))
        model = dse.LightRidgeDSE(n_estimators=200).fit(pts, accs)
        cand = [(float(d), float(D)) for d in grid_d for D in grid_D]
        res_b = model.explore(532e-9, cand, emulate_batch=verify_batch,
                              top_k=2)
        res_s = model.explore(532e-9, cand, emulate=short_emulation, top_k=2)
        best = res_b.best_point
        print(f"[design] codesign flow step 1 (DSE over {len(pts)} emulated "
              f"points): emulate_batch picks unit {best['unit_size'] * 1e6:.0f}"
              f" um, distance {best['distance'] * 100:.0f} cm (verified "
              f"{res_b.verified_acc:.4f}); sequential emulate picks "
              f"{res_s.best_point} ({res_s.verified_acc:.4f}); "
              f"{res_b.speedup:.0f}x fewer emulations than the grid")
        # the scores are accuracies over len(ev_y) inputs: one prediction
        # whose two top logits tie to f32 rounding may flip between the
        # batched and the sequential pass, nothing more
        if (res_b.best_point != res_s.best_point
                or abs(res_b.verified_acc - res_s.verified_acc)
                > 1.0 / len(ev_y)):
            raise AssertionError("codesign flow: the DSE's batched and "
                                 "sequential verifications differ")
        cfg = DONNConfig(name="codesign", n=N, pixel_size=best["unit_size"],
                         wavelength=532e-9, distance=best["distance"],
                         depth=3, det_size=8, codesign="qat",
                         device_levels=256, use_pallas=True)
        model = build_model(cfg, device=dev)
        params = model.init(torch.Generator().manual_seed(1))
        cfg = dataclasses.replace(cfg, gamma=calibrate_gamma(model, params,
                                                             xs[:16]))
        model = build_model(cfg, device=dev)
        res_t = train_classifier(model, params,
                                 batch_iterator(xs, ys, 64, seed=3),
                                 steps=300, lr=0.5, steps_per_call=10)
        acc_train = evaluate_classifier(
            model, res_t.params, batch_iterator(xs, ys, 128, seed=4), 4)
        thick = [float(codesign.to_3d_render(phi, cfg.wavelength).max())
                 for phi in res_t.params["phase"].values()]
        slm = [codesign.to_slm(phi, codesign.DeviceSpec(levels=256)).shape
               for phi in res_t.params["phase"].values()]
        dep = build_model(dataclasses.replace(cfg, codesign="ptq"),
                          device=dev)
        acc_dep = evaluate_classifier(dep, res_t.params,
                                      batch_iterator(xs, ys, 128, seed=5), 4)
        print(f"[design] codesign flow steps 2-4: QAT-trained accuracy "
              f"{acc_train:.4f}; export SLM {slm}, print thickness max "
              f"{[round(t * 1e6, 3) for t in thick]} um; deployed (PTQ) "
              f"accuracy {acc_dep:.4f} (gap {acc_train - acc_dep:+.4f})")
        if not (np.isfinite(acc_train) and np.isfinite(acc_dep)):
            raise AssertionError("codesign flow: no accuracy")

    launches["codesign_flow"] = _counted(codesign_flow)
    print(f"[design] codesign flow launches {launches['codesign_flow']}")
    for what, got in launches.items():
        for name in ("conj_phase_scale", "phase_tf_apply",
                     "intensity_readout"):
            if not got[name]:
                raise AssertionError(f"{what} never launched {name}")
    total = dict.fromkeys(ops.KERNELS, 0)
    for got in launches.values():
        _add(total, got)
    return total


def phase_design(dev, smi: str, profile) -> dict:
    """The paper's design flow on the card; returns each part's counted
    launches."""
    t0 = time.perf_counter()
    out = {"gumbel": _design_gumbel(dev, smi),
           "emulate": _design_emulation(dev, smi, profile),
           "remat": _design_remat(dev, smi),
           "flows": _design_flows(dev)}
    print(f"[design] done in {time.perf_counter() - t0:.1f}s")
    return out


def _lm_serve(arch: str, smi: str, cfg=None, runs: int = 1) -> dict:
    """``serve.main`` on the card ``runs`` times (``cfg``, a depth-cut
    config, in place of the registered one if given), the launch counters
    reset just before each; returns the launches, each run's tokens/s (the
    launcher's own line, host clock) and the peak memory of the runs."""
    import io

    launches = dict.fromkeys(ops.KERNELS, 0)
    rates = []
    real = serve.get_config
    if cfg is not None:
        serve.get_config = lambda name, smoke=False: cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        for i in range(runs):
            buf = io.StringIO()
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            with contextlib.redirect_stdout(buf):
                served = serve.main(["--arch", arch] + LM_SERVE_FLAGS)
            torch.cuda.synchronize()
            for k, v in ops.launch_counts().items():
                launches[k] += v
            print(buf.getvalue(), end="")
            rates.append(float(re.search(r"\(([0-9.]+) tok/s",
                                         buf.getvalue()).group(1)))
            if served != 24 * 32:
                raise AssertionError(f"{arch}: served {served} tokens, not "
                                     "768")
    finally:
        serve.get_config = real
    peak = torch.cuda.max_memory_allocated() / 1e9
    cfg = cfg or lm_config(arch)
    print(f"[lm] {arch} served at {cfg.n_layers} layers (d_model "
          f"{cfg.d_model}, {_n_params(cfg) / 1e9:.3f}B f32 params, "
          f"{cfg.dtype} matmuls): "
          f"{' and '.join(f'{r:.1f}' for r in rates)} tok/s (8 slots, 24 "
          f"requests, prompt 16, 32 new tokens, cache 128); peak memory "
          f"{peak:.2f} GB; {time.perf_counter() - t0:.1f}s ({smi}); "
          f"launches over {runs} runs: {launches} (the reference's served "
          f"path reaches no Pallas kernel either)")
    torch.cuda.empty_cache()
    return {"launches": launches, "tok_s": rates, "peak_gb": peak}


def _n_params(cfg) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(lm.param_specs(cfg)))


def _hold_logits(what: str, got, want, rtol: float) -> None:
    got, want = got.float().cpu(), want.float().cpu()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: bad logits {tuple(got.shape)}")
    rel = ((got - want).abs().max() / want.abs().max()).item()
    same = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    print(f"[lm] {what}: rel err {rel:.3e} (tol {rtol:g}), argmax equal "
          f"{same}")
    if rel > rtol or not same:
        raise AssertionError(f"{what}: {rel:.3e} > {rtol:g} or argmax differs")


def _free(*trees) -> None:
    for t in trees:
        t.clear()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_lm(dev, smi: str, profile) -> dict:
    """LM serving on the card: qwen1.5-4b (dense, K6 held on its q/k) and
    falcon-mamba-7b (ssm, K7 held on its mixer tensors); returns the
    launches of each counted window."""
    print(f"[lm] torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32} (float32 matmuls in full "
          f"precision); {smi}")
    windows = {}
    rng = np.random.default_rng(5)

    # --- dense: serve at full width and depth
    cfg = lm_config("qwen1.5-4b")
    windows["lm_serve_dense"] = _lm_serve("qwen1.5-4b", smi)["launches"]

    # --- f32 at full width, depth 2: the card against a CPU copy, and
    # decode against prefill on the card
    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype=torch.float32)
    p2 = lm.init(cfg2, torch.Generator(device=dev).manual_seed(1))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 16)))
    with torch.no_grad():
        got = lm.logits_fn(p2, toks.to(dev), cfg2)
        cpu = tree_map(lambda t: t.cpu(), p2)
        _hold_logits("qwen1.5-4b f32 depth 2, 16-token prefill: card vs CPU",
                     got, lm.logits_fn(cpu, toks, cfg2), SLICE_RTOL)
        _free(cpu)
        cache = lm.init_cache(cfg2, 1, 16, device=dev)
        dec = [lm.decode_step(p2, cache, toks[:, t:t + 1].to(dev), t,
                              cfg2)[0][:, 0] for t in range(16)]
        _hold_logits("qwen1.5-4b f32 depth 2 on the card: 16 decode steps "
                     "vs the prefill", torch.stack(dec, 1), got, SLICE_RTOL)
    _free(p2, cache)

    # --- K6 on the served parameters: layer 0's q and k of a batch-8,
    # S=2048 prefill, through apply_rotary with the flag on and off
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab,
                                         (LM_HOLD_BATCH, LM_HOLD_SEQ)))
    with torch.no_grad():
        layer0 = lm._layer(params["blocks"], 0)
        h = apply_norm(layer0["ln1"],
                       embed_tokens(params["embed"], toks.to(dev), cfg), cfg)
        q, k, _ = lm_attn.qkv_proj(layer0["attn"], h, cfg)
        cos, sin = rope_angles(cfg, torch.arange(LM_HOLD_SEQ, device=dev))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        rotated = [apply_rotary(t, cos, sin, cfg, use_pallas=True)
                   for t in (q, k)]
        torch.cuda.synchronize()
        windows["lm_hold_rope"] = ops.launch_counts()
        for name, t, got in zip("qk", (q, k), rotated):
            # (B, S, H, Dh) -> (B, H, S, Dh): the kernel's (..., S, D) rows,
            # with cos/sin cast to the model's dtype as apply_rotary does
            _hold_rope(f"apply_rotary(use_pallas=True) vs False on layer 0's "
                       f"{name} {tuple(t.shape)}", got.transpose(1, 2),
                       apply_rotary(t, cos, sin, cfg).transpose(1, 2),
                       t.transpose(1, 2), cos.to(t.dtype), sin.to(t.dtype))
    del layer0, h, q, k, rotated
    if windows["lm_hold_rope"]["rope"] != 2:
        raise AssertionError(f"K6 launches {windows['lm_hold_rope']}")
    if profile:
        cache = lm.init_cache(cfg, 8, 128, device=dev)
        cur = torch.from_numpy(rng.integers(0, cfg.vocab, (8, 1))).to(dev)
        pos = iter(range(10 ** 9))

        def step():
            with torch.no_grad():
                lm.decode_step(params, cache, cur, next(pos) % 127,
                               cfg)[0].argmax(-1).cpu()
        for _ in range(3):
            step()
        t0 = time.perf_counter()
        for _ in range(10):
            step()
        per_us = (time.perf_counter() - t0) / 10 * 1e6
        _profile(step, 10, 1, "decode step", profile + ".lm", per_us)
        _free(cache)
    _free(params)

    # --- ssm: serve at full width and depth, then K7 on layer 0's mixer
    cfg = lm_config("falcon-mamba-7b")
    windows["lm_serve_ssm"] = _lm_serve("falcon-mamba-7b", smi)["launches"]
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(0))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab,
                                         (LM_HOLD_BATCH, LM_HOLD_SEQ)))
    with torch.no_grad():
        layer0 = lm._layer(params["blocks"], 0)
        h = apply_norm(layer0["ln1"],
                       embed_tokens(params["embed"], toks.to(dev), cfg), cfg)
        xc, dt, bs, cs, a, _, _ = ssm.mamba_scan_inputs(layer0["mamba"], h,
                                                        cfg)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        y = ops.selective_scan(dt, xc, bs, cs, a)
        torch.cuda.synchronize()
        windows["lm_hold_scan"] = ops.launch_counts()
        h0 = torch.zeros((LM_HOLD_BATCH, cfg.d_inner, cfg.ssm_state),
                         device=dev)
        want, _ = ssm._selective_scan(dt, bs, cs, xc, a, h0, cfg.scan_chunk)
        _compare("selective_scan", f"falcon-mamba-7b layer 0 mixer, batch "
                 f"{LM_HOLD_BATCH}, S {LM_HOLD_SEQ}, D {cfg.d_inner}, N "
                 f"{cfg.ssm_state}, vs ssm._selective_scan", y, want)
        del layer0, h, xc, dt, bs, cs, a, y, want
    if windows["lm_hold_scan"]["selective_scan"] != 1:
        raise AssertionError(f"K7 launches {windows['lm_hold_scan']}")
    _free(params)
    return windows


# --------------------------------------------------------------------------
# lm_train: LM training through the launcher at full width, the holds of
# its pieces against a CPU copy, its control flow, a full-width checkpoint
# --------------------------------------------------------------------------
LM_TRAIN_STEPS = 8  # launcher steps of each full-width run
LM_TRAIN_FLAGS = ["--batch", "8", "--seq", "128", "--lr", "1e-3",
                  "--warmup", "2", "--log-every", "1", "--device", "cuda"]
LM_TRAIN_TOKENS = 8 * 128  # tokens a step
LM_TRAIN_SSM_DEPTH = 16  # falcon-mamba-7b's 64 layers need 116 GB of f32
#                          state (16 B a parameter); 16 layers need 35 GB
LM_PEAK_STEP, LM_PROFILE_STEP = 3, 5  # launcher calls read / profiled
# the --profile file of one training step, by family (audio and vlm: none)
LM_PROFILE_TAGS = {"dense": "lmtrain", "ssm": "lmtrain_ssm",
                   "moe": "lmtrain_moe", "hybrid": "lmtrain_hybrid"}
LM_TRAIN_HOLD = (2, 2, 16)  # depth, batch, seq of the card-vs-CPU holds
# d/dbk is 0 in exact arithmetic (softmax ignores a shift shared by every
# key): its gradient is rounding noise, held against the largest gradient
ZERO_GRAD_LEAVES = ("['bk']",)
# one step's params: entries whose gradient is within STEP_NOISE of its
# leaf's largest may differ in sign between the card and the CPU (the
# grads agree to 3.4e-6 of the max at qwen1.5-4b, PR 20); below
# STEP_EPS_MARGIN * eps AdamW's update amplifies a gradient's rounding
STEP_NOISE, STEP_EPS_MARGIN = 1e-2, 100.0
LAUNCHER_BASE = ["--arch", "glm4-9b", "--smoke", "--batch", "4", "--seq",
                 "64", "--lr", "1e-2", "--warmup", "5", "--log-every", "5",
                 "--device", "cuda"]  # the reference's tests/test_launchers.py
SIGTERM_WAIT_S = 240.0  # for the signalled run's step-10 line


@contextlib.contextmanager
def _launcher_steps(on_step, cfg=None):
    """Inside, the launcher's step runs through ``on_step(k, run)`` (k the
    call number, ``run()`` the step) and ``get_config`` gives ``cfg``."""
    real, real_cfg = lm_steps.compile_train_step, lm_train.get_config

    def compile_train_step(*a, **kw):
        fn, s_place, b_place, sspecs = real(*a, **kw)
        calls = iter(range(10 ** 9))

        def step(state, batch):
            return on_step(next(calls), lambda: fn(state, batch))

        return step, s_place, b_place, sspecs

    lm_steps.compile_train_step = compile_train_step
    if cfg is not None:
        lm_train.get_config = lambda arch, smoke=False: cfg
    try:
        yield
    finally:
        lm_steps.compile_train_step = real
        lm_train.get_config = real_cfg


def _profile_once(run, path: str):
    """torch.profiler table of one ``run()`` with its device busy time and
    idle share, printed and written to ``path``; returns run's result."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    table, busy_us = _table_and_busy(prof, 30)
    table += (f"\none step: device busy {busy_us:.1f} us, wall {wall_us:.1f}"
              f" us under the profiler (idle share "
              f"{1 - busy_us / wall_us:.1%})\n")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(table)
    print(table)
    return out


def _lm_train_run(arch: str, cfg, smi: str, profile) -> dict:
    """``lm_train.main`` at full width on the card: LM_TRAIN_STEPS steps,
    the peak memory of step LM_PEAK_STEP, a profile of step
    LM_PROFILE_STEP under ``--profile``; asserts finite, falling losses."""
    peak = {}

    def on_step(k, run):
        if k == LM_PEAK_STEP:
            torch.cuda.synchronize()
            peak["before"] = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            out = run()
            end.record()
            torch.cuda.synchronize()
            peak["step"] = torch.cuda.max_memory_allocated()
            peak["ms"] = start.elapsed_time(end)
            return out
        tag = LM_PROFILE_TAGS.get(cfg.family)
        if k == LM_PROFILE_STEP and profile and tag:
            return _profile_once(run, f"{profile}.{tag}")
        return run()

    out = os.path.join(tempfile.mkdtemp(prefix="lm_train_"), "m.json")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _launcher_steps(on_step, cfg):
        losses = lm_train.main(["--arch", arch, "--steps",
                                str(LM_TRAIN_STEPS), "--metrics-out", out]
                               + LM_TRAIN_FLAGS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run_peak = torch.cuda.max_memory_allocated()
    m = json.load(open(out))
    shutil.rmtree(os.path.dirname(out))
    timed = [t for k, t in enumerate(m["step_seconds"])
             if k >= 2 and k != LM_PROFILE_STEP]
    sec = float(np.median(timed))
    n_params = _n_params(cfg)
    print(f"[lm_train] {arch} ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}, {n_params / 1e9:.3f}B params, "
          f"{cfg.dtype} matmuls, f32 masters and moments), batch 8 x seq "
          f"128, lr 1e-3 warmup 2: losses "
          f"{[round(v, 4) for v in losses]}; steps/s {1 / sec:.3f} "
          f"(median of steps {[round(t, 4) for t in timed]} s), tokens/s "
          f"{LM_TRAIN_TOKENS / sec:.1f}; peak memory of step {LM_PEAK_STEP} "
          f"{peak['step'] / 1e9:.2f} GB (allocated before it "
          f"{peak['before'] / 1e9:.2f} GB), of the run {run_peak / 1e9:.2f} "
          f"GB, of {torch.cuda.get_device_properties(0).total_memory / 1e9:.2f}"
          f" GB; run {wall:.1f}s ({smi})")
    if not (len(losses) == LM_TRAIN_STEPS and all(map(math.isfinite, losses))
            and np.mean(losses[-3:]) < np.mean(losses[:3])):
        raise AssertionError(f"{arch}: losses {losses} not finite and "
                             "falling")
    torch.cuda.empty_cache()
    return {"steps_per_s": 1 / sec, "tokens_per_s": LM_TRAIN_TOKENS / sec,
            "peak_gb": peak["step"] / 1e9, "peak_bytes": peak["step"],
            "step_ms": peak["ms"], "losses": losses}


def _hold_lm_grads(what: str, got, want) -> None:
    """Every leaf's gradient on the card within SLICE_RTOL of its max on
    the CPU copy (the zero-grad leaves within SLICE_RTOL of the largest
    gradient); compared on the card."""
    dev = tree_leaves(got)[0].device
    top = max(float(w.abs().max()) for w in tree_leaves(want))
    rels = {}
    for p, g, w in zip(tree_paths(want), tree_leaves(got), tree_leaves(want)):
        w = w.to(dev)
        scale = top if p.endswith(ZERO_GRAD_LEAVES) else float(w.abs().max())
        rels[p] = float((g - w).abs().max()) / (scale or 1.0)
    worst = max(rels, key=rels.get)
    print(f"[lm_train] {what}: {len(rels)} leaves' grads within "
          f"{rels[worst]:.3e} of their max (worst {worst}; "
          f"{', '.join(ZERO_GRAD_LEAVES)} against the largest gradient, "
          f"{top:.3e}), tol {SLICE_RTOL:g}")
    if rels[worst] > SLICE_RTOL:
        raise AssertionError(f"{what}: {worst} grad rel {rels[worst]:.3e}")


def _hold_lm_step_params(what: str, got, want, grads, gnorm: float,
                         lr0: float, eps: float) -> None:
    """Params after one AdamW step on the card against the CPU copy's.

    AdamW's first step moves an entry by lr0 * g / (|g| + eps) (g the
    clipped gradient).  Where the card's and the CPU's gradients differ in
    sign, the two runs part by up to 2 lr0; near |g| = eps the update
    amplifies a relative gradient difference.  So every entry is held
    within 2 lr0 + SLICE_RTOL of its leaf's max, and the entries clear of
    both (|g| above STEP_NOISE of its leaf's largest gradient, or of the
    largest for the zero-grad leaves, and above STEP_EPS_MARGIN * eps)
    within SLICE_RTOL of the leaf's max.  Compared on the card."""
    dev = tree_leaves(got)[0].device
    clip = min(1.0, 1.0 / (gnorm + 1e-12))
    top = max(float(g.abs().max()) for g in tree_leaves(grads))
    worst, held, parted, n = 0.0, 0, 0, 0
    for p, a, w, g in zip(tree_paths(want), tree_leaves(got),
                          tree_leaves(want), tree_leaves(grads)):
        w, g = w.to(dev), g.to(dev)
        d = (a - w).abs()
        scale = float(w.abs().max()) or 1.0
        gmax = top if p.endswith(ZERO_GRAD_LEAVES) else float(g.abs().max())
        clear = ((g.abs() > STEP_NOISE * gmax)
                 & (g.abs() * clip > STEP_EPS_MARGIN * eps))
        held += int(clear.sum())
        parted += int((d > SLICE_RTOL * scale).sum())
        n += d.numel()
        if float(d.max()) > 2 * lr0 * 1.01 + SLICE_RTOL * scale:
            raise AssertionError(f"{what}: {p} differs by {float(d.max()):.3e}"
                                 f" > 2 lr0 = {2 * lr0:.3e}")
        if bool(clear.any()):
            rel = float(d[clear].max()) / scale
            worst = max(worst, rel)
            if rel > SLICE_RTOL:
                raise AssertionError(f"{what}: {p}: rel {rel:.3e} where the "
                                     "gradient is clear of noise and eps")
        del w, g, d, clear
    print(f"[lm_train] {what}: every entry within 2 lr0 = {2 * lr0:.3e}; "
          f"the {held} of {n} entries whose gradient is clear of noise and "
          f"eps within {worst:.3e} of their leaf's max (tol {SLICE_RTOL:g}); "
          f"{parted} entries past {SLICE_RTOL:g} in all")


def _hold_loss_and_grads(tag: str, cfg, params, on_dev, cpu, batch):
    """lm_loss (moe: with aux), the grad norm and every leaf's grad on the
    card against the CPU copy, SLICE_RTOL; returns (card grads, CPU loss,
    CPU grads, CPU grad norm)."""
    def loss_fn(p, bb):
        return lm.lm_loss(p, bb, cfg)

    got_l, got_g = lm_steps.loss_and_grads(loss_fn, params, on_dev)
    want_l, want_g = lm_steps.loss_and_grads(loss_fn, cpu, batch)
    rel = abs(float(got_l) - float(want_l)) / abs(float(want_l))
    gn, wn = (float(lm_steps._global_norm(g)) for g in (got_g, want_g))
    print(f"[lm_train] {tag}: lm_loss {float(got_l):.6f} vs "
          f"{float(want_l):.6f} (rel {rel:.3e}); grad norm {gn:.6f} vs "
          f"{wn:.6f} (rel {abs(gn - wn) / wn:.3e}), tol {SLICE_RTOL:g}")
    if rel > SLICE_RTOL or abs(gn - wn) > SLICE_RTOL * wn:
        raise AssertionError(f"{tag}: loss or grad norm")
    _hold_lm_grads(tag, got_g, want_g)
    return got_g, want_l, want_g, wn


def _lm_train_holds(dev, arch: str, keep_state: bool):
    """Full width, depth 2, f32, batch 2, seq 16 on the card against a CPU
    copy: lm_loss, the grad norm and every leaf's grad; the blocked AdamW
    update bitwise the unblocked one on the card; one make_train_step step
    at accum 1 and 2.  Returns the card's train state after the accum-2
    step if ``keep_state``."""
    t0 = time.perf_counter()
    depth, b, s = LM_TRAIN_HOLD
    cfg = dataclasses.replace(lm_config(arch), n_layers=depth,
                              dtype=torch.float32)
    sched = warmup_cosine(3e-4, 20, 100)  # the launcher's defaults
    opt = AdamW(lr=sched, weight_decay=0.01, grad_clip_norm=1.0)
    lr0 = float(sched(0))
    state = lm_steps.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(2), opt)
    cpu = tree_map(lambda t: t.to("cpu", copy=True), state)
    rng = np.random.default_rng(7)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    on_dev = tree_map(lambda t: t.to(dev), batch)
    tag = f"{arch} f32 depth {depth}, batch {b}, seq {s}: card vs CPU"
    got_g, want_l, want_g, wn = _hold_loss_and_grads(
        tag, cfg, state["params"], on_dev, cpu["params"], batch)

    # the blocked update (leaves above scan_threshold) against one pass
    whole = dataclasses.replace(opt, scan_threshold=1 << 62)
    mom = lm_steps.AdamWState(state["mu"], state["nu"])
    a = opt.update(got_g, mom, state["params"], state["step"])
    w = whole.update(got_g, mom, state["params"], state["step"])
    blocked = [p for p, t in zip(tree_paths(state["params"]),
                                 tree_leaves(state["params"]))
               if t.numel() > opt.scan_threshold]
    same = all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(w)))
    print(f"[lm_train] {arch} depth {depth}: the blocked AdamW update "
          f"({len(blocked)} leaves above scan_threshold "
          f"{opt.scan_threshold}: {blocked}) bitwise the unblocked one on "
          f"the card: {same}")
    if not same or not blocked:
        raise AssertionError(f"{arch}: blocked AdamW differs from unblocked")
    del a, w, got_g, mom

    # one make_train_step step on the card; on the CPU copy, at accum 1,
    # the step's own pieces (loss_and_grads above, then AdamW), at accum 2
    # make_train_step itself; the accum-2 steps consume the states
    ref1, _ = opt.update(want_g, lm_steps.AdamWState(cpu["mu"], cpu["nu"]),
                         cpu["params"], cpu["step"])
    refs = {1: ({"loss": want_l, "grad_norm": wn}, ref1)}
    for accum in (1, 2):
        fn = lm_steps.make_train_step(cfg, opt, accum_steps=accum)
        dev_s, dev_m = fn(state if accum == 2 else tree_map(torch.clone,
                                                             state), on_dev)
        if accum == 2:
            cpu_s, cpu_m = fn(cpu, batch)
            refs[2] = (cpu_m, cpu_s["params"])
        want_m, want_p = refs.pop(accum)
        what = f"{tag}, one make_train_step step at accum {accum}"
        for k in ("loss", "grad_norm"):
            g, w_ = float(dev_m[k]), float(want_m[k])
            print(f"[lm_train] {what}: {k} {g:.6f} vs {w_:.6f} (rel "
                  f"{abs(g - w_) / w_:.3e}, tol {SLICE_RTOL:g})")
            if abs(g - w_) > SLICE_RTOL * w_:
                raise AssertionError(f"{what}: {k}")
        _hold_lm_step_params(what, dev_s["params"], want_p, want_g,
                             float(want_m["grad_norm"]), lr0, opt.eps)
        del want_p
    del cpu, cpu_s, want_g
    print(f"[lm_train] {arch} holds: {time.perf_counter() - t0:.1f}s")
    return dev_s if keep_state else None


def _lm_checkpoint(dev, state, smi: str) -> None:
    """The depth-2 train state through the launcher's AsyncCheckpointer
    into a temporary directory, restored bitwise, then deleted."""
    gb = sum(t.numel() * t.element_size() for t in tree_leaves(state)) / 1e9
    tmp = tempfile.mkdtemp(prefix="lm_ckpt_")
    try:
        saver = AsyncCheckpointer(tmp, keep=1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        saver.save(1, state)
        t_ret = time.perf_counter() - t0
        saver.wait()
        t_commit = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = ckpt_restore(tmp, 1, state, device=dev)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        same = all(torch.equal(x, y) for x, y in zip(tree_leaves(back),
                                                     tree_leaves(state)))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"[lm_train] checkpoint of the qwen1.5-4b depth-2 train state "
          f"(params, mu, nu, step): {gb:.2f} GB; save returned in "
          f"{t_ret:.2f}s, committed in {t_commit:.2f}s, restored in "
          f"{t_restore:.2f}s, bitwise {same} ({smi})")
    if not same:
        raise AssertionError("checkpoint restore is not bitwise")


def _launcher_main(args) -> tuple:
    """``lm_train.main(args)`` with its stdout echoed and returned."""
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        losses = lm_train.main(args)
    print(buf.getvalue(), end="")
    return losses, buf.getvalue()


def _lm_control_flow(smi: str) -> None:
    """The launcher's control flow on the card at glm4-9b --smoke: 10
    straight steps against 5 + resume 5, SIGTERM -> 143 -> resume, and the
    examples' train 200 / resume to 250 / serve flow."""
    tmp = tempfile.mkdtemp(prefix="lm_flow_")
    t0 = time.perf_counter()
    try:
        straight, _ = _launcher_main(LAUNCHER_BASE + ["--steps", "10"])
        ck = os.path.join(tmp, "ck")
        first, _ = _launcher_main(LAUNCHER_BASE + [
            "--steps", "5", "--ckpt-dir", ck, "--ckpt-every", "5"])
        second, out = _launcher_main(LAUNCHER_BASE + [
            "--steps", "10", "--ckpt-dir", ck, "--ckpt-every", "100"])
        rel = [abs(a - b) / abs(b) for a, b in zip(first + second, straight)]
        bitwise = first + second == straight
        print(f"[lm_train] glm4-9b smoke: 10 straight steps vs 5 + resume 5: "
              f"rel {max(rel[:5]):.3e} before the resume (tol 1e-5), "
              f"{max(rel[5:]):.3e} after (tol 1e-3); bitwise {bitwise}")
        if ("resuming from step 5" not in out or max(rel[:5]) > 1e-5
                or max(rel[5:]) > 1e-3):
            raise AssertionError("resume does not continue the run")

        ck = os.path.join(tmp, "ck_sig")
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train"]
            + LAUNCHER_BASE + ["--steps", "100000", "--ckpt-dir", ck,
                               "--ckpt-every", "3"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        lines: list = []
        reader = threading.Thread(
            target=lambda: lines.extend(iter(proc.stdout.readline, "")),
            daemon=True)
        reader.start()
        try:
            deadline = time.monotonic() + SIGTERM_WAIT_S
            while not any("step    10" in ln for ln in lines):
                if proc.poll() is not None or time.monotonic() > deadline:
                    raise AssertionError("the signalled run printed no step "
                                         "10:\n" + "".join(lines)[-2000:])
                time.sleep(0.05)
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        reader.join(timeout=10)
        last = ckpt_latest(ck)
        _, out = _launcher_main(LAUNCHER_BASE + [
            "--steps", str((last or 0) + 3), "--ckpt-dir", ck,
            "--ckpt-every", "100"])
        print(f"[lm_train] SIGTERM mid-run: rc {rc}, LATEST step {last}; "
              f"resume printed 'resuming from step {last}': "
              f"{f'resuming from step {last}' in out}; the resume and "
              f"SIGTERM checks {time.perf_counter() - t0:.1f}s")
        if rc != 143 or last is None or last < 3 or (
                f"resuming from step {last}" not in out):
            raise AssertionError("SIGTERM -> 143 -> resume failed")

        ck = os.path.join(tmp, "ck_example")
        flags = ["--arch", "granite-8b", "--smoke", "--batch", "8", "--seq",
                 "128", "--lr", "3e-3", "--warmup", "20", "--ckpt-dir", ck,
                 "--ckpt-every", "50", "--log-every", "25", "--device",
                 "cuda"]
        t0 = time.perf_counter()
        trained, _ = _launcher_main(flags + ["--steps", "200"])
        resumed, out = _launcher_main(flags + ["--steps", "250"])
        served = serve.main(["--arch", "granite-8b", "--smoke", "--slots",
                             "8", "--requests", "16", "--prompt-len", "8",
                             "--max-new", "16", "--cache-len", "128",
                             "--device", "cuda"])
        print(f"[lm_train] examples/lm_train_and_serve.py flow (granite-8b "
              f"smoke): 200 steps {trained[0]:.4f} -> {trained[-1]:.4f}, "
              f"resumed to 250 -> {resumed[-1]:.4f}, served {served} tokens; "
              f"{time.perf_counter() - t0:.1f}s ({smi})")
        if (len(trained) != 200 or len(resumed) != 50 or served != 16 * 16
                or "resuming from step 200" not in out
                or not resumed[-1] < trained[0]):
            raise AssertionError("the train -> resume -> serve flow failed")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_lm_train(dev, smi: str, profile) -> tuple:
    """LM training on the card: qwen1.5-4b at full width and depth and
    falcon-mamba-7b at full width, depth 16, through the launcher; the
    holds against CPU copies; the control flow; a full-width checkpoint.
    Returns the phase's kernel launches (the path launches none) and
    qwen1.5-4b's run (``_lm_train_run``: step LM_PEAK_STEP's peak bytes and
    its time on the stream)."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    runs = {"qwen1.5-4b": _lm_train_run("qwen1.5-4b",
                                        lm_config("qwen1.5-4b"), smi,
                                        profile)}
    ssm_cfg = dataclasses.replace(lm_config("falcon-mamba-7b"),
                                  n_layers=LM_TRAIN_SSM_DEPTH)
    runs["falcon-mamba-7b"] = _lm_train_run("falcon-mamba-7b", ssm_cfg, smi,
                                            profile)
    state = _lm_train_holds(dev, "qwen1.5-4b", keep_state=True)
    _lm_checkpoint(dev, state, smi)
    _free(state)
    torch.cuda.empty_cache()
    _lm_train_holds(dev, "falcon-mamba-7b", keep_state=False)
    torch.cuda.empty_cache()
    _lm_control_flow(smi)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    print(f"[lm_train] kernel launches across the phase: {launches} (the "
          f"reference's LM training path reaches no Pallas kernel either); "
          f"phase {time.perf_counter() - t_phase:.1f}s")
    if any(launches.values()):
        raise AssertionError(f"the LM training path launched {launches}")
    return launches, runs["qwen1.5-4b"]


# --------------------------------------------------------------------------
# dryrun: the dry-run's cost count held against the card's own step
# --------------------------------------------------------------------------
DRYRUN_PEAK_RTOL = 0.05  # traced peak vs the step's measured peak
DRYRUN_COUNT_RTOL = 1e-3  # a fake trace's count vs the same real step's
DRYRUN_HOLD_DEPTH = 2  # layers of the qwen1.5-4b step counted for real
# production cells traced by the CLI in subprocesses (fake CUDA tensors)
DRYRUN_CELLS = (("qwen1.5-4b", "train_4k", "single"),
                ("glm4-9b", "decode_32k", "single"),
                ("donn-xl-500", "train_b256", "both"))
DRYRUN_PERF_CELL = "donn"  # launch/perf.py's variants traced beside them
DRYRUN_TIMEOUT_S = 400.0


def _launcher_optimizer() -> AdamW:
    """``launch/train.py``'s optimizer at LM_TRAIN_FLAGS."""
    return AdamW(lr=warmup_cosine(1e-3, 2, LM_TRAIN_STEPS),
                 weight_decay=0.01, grad_clip_norm=1.0)


def _token_specs(batch: int, seq: int) -> dict:
    return {k: torch.empty((batch, seq), dtype=torch.int32, device="meta")
            for k in ("tokens", "labels")}


def _dryrun_start(tmp: str) -> list:
    """The production cells' CLI runs, started together (host work: the
    trace allocates nothing on the card)."""
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "OMP_NUM_THREADS": "1"}
    runs = [["launch.dryrun", "--arch", a, "--shape", shape, "--mesh", m,
             "--out", tmp] for a, shape, m in DRYRUN_CELLS]
    runs.append(["launch.perf", "--cell", DRYRUN_PERF_CELL, "--out",
                 os.path.join(tmp, "perf")])
    return [subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.{mod}", *argv], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for mod, *argv in runs]


def _dryrun_wait(p, what: str, bad: list) -> None:
    try:
        out, _ = p.communicate(timeout=DRYRUN_TIMEOUT_S)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    if p.returncode != 0:
        bad.append(f"{what}: rc {p.returncode}")
        print(out[-4000:])


def _dryrun_cells(procs: list, tmp: str, smi: str, bad: list) -> None:
    """Wait for the CLI runs; each record ``ok`` with positive per-device
    bytes; print its three terms, dominant term and roofline fraction.
    The perf cell's variants, one program in the port, count alike."""
    for (arch, shape, m), p in zip(DRYRUN_CELLS, procs):
        _dryrun_wait(p, f"dryrun {arch} {shape} {m}", bad)
        for pod in (("pod1", "pod2") if m == "both" else ("pod1",)):
            path = os.path.join(tmp, f"{arch}__{shape}__{pod}.json")
            rec = json.load(open(path)) if os.path.exists(path) else {}
            ok = (rec.get("status") == "ok"
                  and rec["memory"]["per_device_bytes"] > 0)
            if not ok:
                bad.append(f"dryrun {arch} {shape} {pod}: "
                           f"{rec.get('status')}")
                continue
            t = rec["terms"]
            print(f"[dryrun] {arch} {shape} {rec['mesh']} ({rec['chips']} "
                  f"ranks, rank 0 traced on fake {rec['device']} tensors): "
                  f"compute {t['compute_s'] * 1e3:.3f} ms, memory "
                  f"{t['memory_s'] * 1e3:.3f} ms, collective "
                  f"{t['collective_s'] * 1e3:.3f} ms a step, dominant "
                  f"{rec['dominant']}, roofline fraction "
                  f"{rec['roofline_fraction']:.4f}; per device "
                  f"{rec['hlo_flops_per_dev']:.4e} FLOP "
                  f"({rec['hlo_dot_flops_per_dev']:.4e} in dots), "
                  f"{rec['hlo_bytes_per_dev']:.4e} B, collectives "
                  f"{rec['collective_bytes_per_dev']:.4e} B "
                  f"{rec['collective_breakdown']}, peak "
                  f"{rec['memory']['per_device_bytes'] / 1e9:.2f} GB (fits "
                  f"{rec['memory']['fits_hbm']}); {rec['ops']} ops traced in "
                  f"{rec['compile_wall_s']:.1f} s ({smi} rates)")
    _dryrun_wait(procs[-1], f"perf {DRYRUN_PERF_CELL}", bad)
    recs, d = {}, os.path.join(tmp, "perf")
    for name in sorted(os.listdir(d)) if os.path.isdir(d) else []:
        rec = json.load(open(os.path.join(d, name)))
        recs[rec["variant"]] = rec
        print(f"[dryrun] perf {rec['cell']} {rec['variant']} "
              f"{rec.get('mesh')}: {rec['status']}, terms "
              f"{rec.get('terms')}, roofline fraction "
              f"{rec.get('roofline_fraction')}, "
              f"{rec.get('compile_wall_s', 0.0):.1f} s")
    terms = [r.get("terms") for r in recs.values()]
    if (len(recs) != 2 or any(r["status"] != "ok" for r in recs.values())
            or terms[0] != terms[1]):
        bad.append(f"perf {DRYRUN_PERF_CELL}: {sorted(recs)} {terms}")


def _dryrun_count_hold(dev, cfg, smi: str, bad: list) -> None:
    """One real qwen1.5-4b step (full width, DRYRUN_HOLD_DEPTH layers,
    LM_TRAIN_FLAGS' batch) counted on the card against the fake trace of
    the same step: FLOPs, dot FLOPs and bytes within DRYRUN_COUNT_RTOL, no
    collective bytes on one rank."""
    hcfg = dataclasses.replace(cfg, n_layers=DRYRUN_HOLD_DEPTH)
    specs = _token_specs(8, 128)
    opt = _launcher_optimizer()
    fn, _, _, _ = lm_steps.compile_train_step(hcfg, None, specs,
                                              optimizer=opt, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    state = lm_steps.init_train_state(hcfg, gen, opt)
    batch = {k: torch.randint(0, cfg.vocab, (8, 128), generator=gen,
                              device=dev, dtype=torch.int32)
             for k in specs}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    real = cost_count(fn, state, batch, device=dev)
    torch.cuda.synchronize()
    alloc_peak = torch.cuda.max_memory_allocated()
    _free(state, batch)
    torch.cuda.empty_cache()
    fake = dry.trace_train_step(hcfg, specs, None, dev,
                                optimizer=_launcher_optimizer())
    rels = {k: abs(getattr(fake, k) - getattr(real, k))
            / max(abs(getattr(real, k)), 1.0)
            for k in ("flops", "dot_flops", "bytes")}
    ok = (max(rels.values()) <= DRYRUN_COUNT_RTOL
          and real.collective_bytes == fake.collective_bytes == 0)
    print(f"[dryrun] qwen1.5-4b depth {DRYRUN_HOLD_DEPTH} train step, batch "
          f"8 x seq 128, counted on the card vs traced on fake tensors: "
          f"FLOPs {real.flops:.6e} vs {fake.flops:.6e}, dot FLOPs "
          f"{real.dot_flops:.6e} vs {fake.dot_flops:.6e}, bytes "
          f"{real.bytes:.6e} vs {fake.bytes:.6e} (largest gap "
          f"{max(rels.values()):.2e}, held at {DRYRUN_COUNT_RTOL}), "
          f"collective bytes {real.collective_bytes} and "
          f"{fake.collective_bytes}, ops {real.ops} and {fake.ops}; peak "
          f"{real.peak_bytes / 1e9:.3f} GB tracked on the card, "
          f"{fake.peak_bytes / 1e9:.3f} GB traced, allocator "
          f"{alloc_peak / 1e9:.3f} GB ({smi}){'' if ok else '  FAILED'}")
    if not ok:
        bad.append(f"count hold {rels}")


def phase_dryrun(dev, smi: str, qwen_run: dict) -> dict:
    """The dry-run tools on the card: ``HBM_PER_DEVICE``; the traced peak of
    the lm_train phase's qwen1.5-4b step against its measured step-3 peak;
    a real step's count against its trace; the full step's roofline terms
    beside its time on the stream; three production cells through the
    CLI.  Returns the phase's K1-K7 launches (none)."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    total = torch.cuda.get_device_properties(0).total_memory
    print(f"[dryrun] total_memory {total} B, launch.mesh.HBM_PER_DEVICE "
          f"{mesh_mod.HBM_PER_DEVICE} B")
    if total != mesh_mod.HBM_PER_DEVICE:
        raise AssertionError(f"HBM_PER_DEVICE {mesh_mod.HBM_PER_DEVICE} is "
                             f"not the card's {total}")
    bad = []
    tmp = tempfile.mkdtemp(prefix="dryrun_")
    procs = _dryrun_start(tmp)
    try:
        cfg = lm_config("qwen1.5-4b")
        t0 = time.perf_counter()
        full = dry.trace_train_step(cfg, _token_specs(8, 128), None, dev,
                                    optimizer=_launcher_optimizer())
        t_full = time.perf_counter() - t0
        gap = full.peak_bytes / qwen_run["peak_bytes"] - 1
        print(f"[dryrun] qwen1.5-4b full width and depth, LM_TRAIN_FLAGS "
              f"(batch 8 x seq 128), fake (1, 1) trace of the step, moments "
              f"present: peak {full.peak_bytes / 1e9:.3f} GB (arguments "
              f"{full.argument_bytes / 1e9:.3f} GB) against the lm_train "
              f"phase's step-{LM_PEAK_STEP} peak "
              f"{qwen_run['peak_bytes'] / 1e9:.3f} GB: {gap:+.2%} (held at "
              f"{DRYRUN_PEAK_RTOL:.0%}); {full.ops} ops traced in "
              f"{t_full:.1f} s ({smi})"
              f"{'' if abs(gap) <= DRYRUN_PEAK_RTOL else '  FAILED'}")
        if abs(gap) > DRYRUN_PEAK_RTOL:
            bad.append(f"peak {gap:+.2%}")
        model_flops = dry.lm_model_flops(
            cfg, "train", ShapeCell("lm_train", 128, 8, "train"))[2]
        roof = dry.roofline(full, model_flops, 1)
        t = roof["terms"]
        ms = qwen_run["step_ms"]
        print(f"[dryrun] qwen1.5-4b step {LM_PEAK_STEP} on the card: "
              f"{ms:.2f} ms on the stream (CUDA events); its count: "
              f"{full.flops:.4e} FLOP ({full.dot_flops:.4e} in dots), "
              f"{full.bytes:.4e} B; compute {t['compute_s'] * 1e3:.2f} ms "
              f"at {mesh_mod.PEAK_FLOPS_BF16 / 1e12:.0f} TFLOP/s, memory "
              f"{t['memory_s'] * 1e3:.2f} ms at "
              f"{mesh_mod.HBM_BW / 1e12:.2f} TB/s: the step at "
              f"{roof['bound_s'] * 1e3 / ms:.1%} of its "
              f"{roof['dominant'][:-2]} bound; model FLOPs (6ND) "
              f"{model_flops:.4e}, {model_flops / mesh_mod.PEAK_FLOPS_BF16 / ms * 1e3:.2%}"
              f" of the bf16 peak over the step ({smi}; printed, not held)")
        _dryrun_count_hold(dev, cfg, smi, bad)
        _dryrun_cells(procs, tmp, smi, bad)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    print(f"[dryrun] K1-K7 launches across the phase: {launches}; phase "
          f"{time.perf_counter() - t_phase:.1f}s")
    if any(launches.values()):
        bad.append(f"launches {launches}")
    if bad:
        raise AssertionError("dryrun holds failed: " + "; ".join(bad))
    return launches


# --------------------------------------------------------------------------
# lm_families: the audio, moe, hybrid and vlm LM families served and
# trained at full width, held against CPU copies, decode against prefill
# --------------------------------------------------------------------------
# depth served, trained and held, None for the config's own: cut only where
# one 80 GB card cannot hold the f32 parameters (serving) or their training
# state (16 B a parameter); arctic trains and is held at its smoke config
LM_FAMILY_DEPTHS = {
    "musicgen-medium": (None, None, 2),
    "mixtral-8x7b": (8, 2, 1),
    "arctic-480b": (1, "smoke", "smoke"),
    "recurrentgemma-9b": (None, 8, 4),  # hold: a period and a tail layer
    "llama-3.2-vision-11b": (None, 10, 5),
}
LM_FAMILY_HOLD = (2, 16)  # batch, seq of the card-vs-CPU holds (f32)
DECODE_RTOL = 1e-4  # decode vs prefill (tests/test_lm_decode.py's bound)
VLM_GATE = 0.5  # cross gates of the held vlm copy, away from their zero init
ARCTIC_FLAGS = ["--arch", "arctic-480b", "--smoke", "--batch", "8", "--seq",
                "128", "--lr", "1e-2", "--warmup", "4", "--log-every", "4",
                "--device", "cuda"]  # warmup 4: 4 + resume 4 = 8 straight


def _family_cfg(arch: str, depth):
    """``arch``'s full config cut to ``depth`` (None: its own depth;
    "smoke": its smoke config)."""
    if depth == "smoke":
        return lm_config(arch, smoke=True)
    cfg = lm_config(arch)
    return cfg if depth is None else dataclasses.replace(cfg, n_layers=depth)


def _route_report(what: str, cfg, params, cpu, batch, cpu_batch) -> None:
    """The top-k expert sets of every moe layer's tokens on the card and
    on the CPU copy; the router margins (p_k - p_k+1) of the tokens whose
    sets differ, printed (a near tie can route a token differently)."""
    real, seen = moe.route, []

    def recording(p, xg, c):
        out = real(p, xg, c)
        seen.append(out)
        return out

    moe.route = recording
    try:
        with torch.no_grad():
            lm.forward(params, batch["tokens"], cfg)
            lm.forward(cpu, cpu_batch["tokens"], cfg)
    finally:
        moe.route = real
    k, n = cfg.top_k, len(seen) // 2
    parted, margins = 0, []
    for (probs, _, idx), (_, _, cidx) in zip(seen[:n], seen[n:]):
        differ = (idx.sort(-1).values.cpu() != cidx.sort(-1).values).any(-1)
        top = probs.sort(-1, descending=True).values.cpu()
        parted += int(differ.sum())
        margins += (top[..., k - 1] - top[..., k])[differ].tolist()
    tokens = n * idx.shape[0] * idx.shape[1]
    print(f"[lm_families] {what}: tokens routed to another expert set on "
          f"the card than on the CPU: {parted} of {tokens} over {n} "
          f"layers; their top-{k} margins {margins}")


def _family_decode(what: str, cfg, params, batch) -> None:
    """Decode against prefill on the card (the reference test's recipe:
    the moe capacity lifted to n_experts, vlm's xk/xv filled from the
    vision states), within DECODE_RTOL of the prefill's max."""
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    toks = batch["tokens"]
    B, S = toks.shape
    with torch.no_grad():
        full = lm.logits_fn(params, toks, cfg, batch.get("vision"))
        cache = lm.init_cache(cfg, B, S, device=toks.device)
        if cfg.family == "vlm":
            cross = params["cross_blocks"]["xattn"]
            vis = batch["vision"].to(cfg.dtype)
            for name, w in (("xk", "wk"), ("xv", "wv")):
                kv = torch.einsum("bsd,ldk->lbsk", vis, cross[w].to(cfg.dtype))
                cache[name].copy_(kv.reshape(cache[name].shape))
        dec = [lm.decode_step(params, cache, toks[:, t:t + 1], t, cfg)[0][:, 0]
               for t in range(S)]
        rel = float((torch.stack(dec, 1) - full).abs().max()
                    / full.abs().max())
    print(f"[lm_families] {what}: {S} decode steps vs the prefill on the "
          f"card: rel {rel:.3e} (tol {DECODE_RTOL:g})")
    if not rel < DECODE_RTOL:
        raise AssertionError(f"{what}: decode vs prefill {rel:.3e}")
    _free(cache)


def _family_holds(dev, arch: str, cfg) -> None:
    """f32, batch 2, seq 16, at the hold depth: decode vs prefill on the
    card; logits, lm_loss (moe: with aux), the grad norm and every leaf's
    grad on the card against a CPU copy; one make_train_step step against
    AdamW's update of the CPU copy by its own grads (held as the lm_train
    phase holds its step)."""
    t0 = time.perf_counter()
    laps, last = {}, [t0]

    def lap(name):
        now = time.perf_counter()
        laps[name] = now - last[0]
        last[0] = now

    b, s = LM_FAMILY_HOLD
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    sched = warmup_cosine(3e-4, 20, 100)  # the launcher's defaults
    opt = AdamW(lr=sched, weight_decay=0.01, grad_clip_norm=1.0)
    state = lm_steps.init_train_state(
        cfg, torch.Generator(device=dev).manual_seed(2), opt)
    if cfg.family == "vlm":  # open the gates: tanh(0) cuts the cross path
        cross = state["params"]["cross_blocks"]
        cross["gate_ffn"].fill_(VLM_GATE)
        cross["xattn"]["gate"].fill_(-VLM_GATE)
    rng = np.random.default_rng(11)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    if cfg.family == "vlm":
        batch["vision"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.vision_seq, cfg.d_model)).astype(np.float32))
    on_dev = tree_map(lambda t: t.to(dev), batch)
    what = (f"{arch} f32 {cfg.n_layers} layers ({_n_params(cfg) / 1e9:.3f}B "
            f"params), batch {b}, seq {s}")
    lap("init")
    _family_decode(what, cfg, state["params"], on_dev)
    lap("decode")
    cpu = tree_map(lambda t: t.to("cpu", copy=True), state["params"])
    lap("copy to the CPU")
    tag = f"{what}: card vs CPU"
    if cfg.family == "moe":
        _route_report(tag, cfg, state["params"], cpu, on_dev, batch)
    with torch.no_grad():
        _hold_logits(f"{tag}, logits", lm.logits_fn(
            state["params"], on_dev["tokens"], cfg, on_dev.get("vision")),
            lm.logits_fn(cpu, batch["tokens"], cfg, batch.get("vision")),
            SLICE_RTOL)
    lap("logits")
    got_g, want_l, want_g, wn = _hold_loss_and_grads(
        tag, cfg, state["params"], on_dev, cpu, batch)
    del got_g
    lap("grads")

    # one make_train_step step on the card (the state donated), against
    # the CPU copy's grads through AdamW (want_g is clipped in place: its
    # norm is then min(wn, 1), the clip _hold_lm_step_params reckons with)
    want_p = _first_adamw_step(opt, cpu, want_g, state["step"].cpu(), dev)
    lap("reference AdamW")
    new, m = lm_steps.make_train_step(cfg, opt)(state, on_dev)
    step_what = f"{tag}, one make_train_step step"
    for k, want in (("loss", float(want_l)), ("grad_norm", wn)):
        g = float(m[k])
        print(f"[lm_families] {step_what}: {k} {g:.6f} vs {want:.6f} (rel "
              f"{abs(g - want) / want:.3e}, tol {SLICE_RTOL:g})")
        if abs(g - want) > SLICE_RTOL * want:
            raise AssertionError(f"{step_what}: {k}")
    _hold_lm_step_params(step_what, new["params"], want_p, want_g,
                         min(wn, 1.0), float(sched(0)), opt.eps)
    del want_p, want_g, cpu
    _free(new, state)
    lap("card step and its hold")
    print(f"[lm_families] {arch} holds: {time.perf_counter() - t0:.1f}s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in laps.items()) + ")")


def _first_adamw_step(opt, params, grads, step, dev):
    """AdamW's first step from zero moments of the CPU copy's ``params``
    and ``grads`` (clipped by their global norm on the CPU, in place), one
    leaf at a time on the card, in place; the new params on the CPU.  The
    update is elementwise, the port's own code on either device; the CPU
    takes a minute for the 3.1B entries of recurrentgemma's hold, the card
    a second."""
    from repro_torch.optim.adamw import clip_by_global_norm

    clip_by_global_norm(grads, opt.grad_clip_norm, inplace=True)
    leafwise = dataclasses.replace(opt, grad_clip_norm=None)
    out = []
    for p, g in zip(tree_leaves(params), tree_leaves(grads)):
        p = p.to(dev)
        new, _ = leafwise.update(
            [g.to(dev)], lm_steps.AdamWState([torch.zeros_like(p)],
                                             [torch.zeros_like(p)]),
            [p], step, donate=True)
        out.append(new[0].cpu())
    return tree_unflatten(params, out)


def _arctic_control_flow(smi: str) -> None:
    """arctic-480b --smoke through the launcher on the card: 8 steps with
    a falling loss, and 4 + resume 4 bitwise the straight run."""
    flags = ARCTIC_FLAGS
    tmp = tempfile.mkdtemp(prefix="lm_arctic_")
    t0 = time.perf_counter()
    try:
        straight, _ = _launcher_main(flags + ["--steps", "8"])
        ck = os.path.join(tmp, "ck")
        first, _ = _launcher_main(flags + ["--steps", "4", "--ckpt-dir", ck,
                                           "--ckpt-every", "4"])
        second, out = _launcher_main(flags + ["--steps", "8", "--ckpt-dir",
                                              ck, "--ckpt-every", "100"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bitwise = first + second == straight
    print(f"[lm_families] arctic-480b --smoke through the launcher: losses "
          f"{[round(v, 4) for v in straight]}; 4 + resume 4 bitwise the "
          f"straight 8: {bitwise}; {time.perf_counter() - t0:.1f}s ({smi})")
    if (not bitwise or "resuming from step 4" not in out
            or not np.mean(straight[-3:]) < np.mean(straight[:3])):
        raise AssertionError("arctic-480b smoke: the launcher's control "
                             "flow failed")


def phase_lm_families(dev, smi: str, profile) -> dict:
    """The audio, moe, hybrid and vlm LM families on the card at full
    width: served (depths of LM_FAMILY_DEPTHS), trained through the
    launcher, held against CPU copies, decode against prefill.  Returns
    the phase's kernel launches, summed over every window (its path
    launches none, as in the reference).  ``_lm_serve`` counts its own
    runs from zero, so each family's training and holds are a window of
    their own."""
    t_phase = time.perf_counter()
    launches = dict.fromkeys(ops.KERNELS, 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    for arch, (d_serve, d_train, d_hold) in LM_FAMILY_DEPTHS.items():
        cfg = _family_cfg(arch, d_serve)
        if cfg.n_layers != lm_config(arch).n_layers:
            print(f"[lm_families] {arch}: served at depth {cfg.n_layers} of "
                  f"{lm_config(arch).n_layers} ({_n_params(cfg) / 1e9:.2f}B "
                  f"f32 params; the full depth does not fit 80 GB)")
        add(_lm_serve(arch, smi, cfg)["launches"])
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        if d_train == "smoke":
            _arctic_control_flow(smi)
        else:
            cfg = _family_cfg(arch, d_train)
            if cfg.n_layers != lm_config(arch).n_layers:
                print(f"[lm_families] {arch}: trained at depth "
                      f"{cfg.n_layers} of {lm_config(arch).n_layers} "
                      f"({_n_params(cfg) * 16 / 1e9:.1f} GB of params, "
                      f"grads, mu and nu)")
            _lm_train_run(arch, cfg, smi, profile)
        _family_holds(dev, arch, _family_cfg(arch, d_hold))
        torch.cuda.synchronize()
        add(ops.launch_counts())
        torch.cuda.empty_cache()
    print(f"[lm_families] kernel launches across the phase (every family's "
          f"serving, training and holds): {launches} (the reference's moe, "
          f"rglru and cross-attention paths reach no Pallas kernel either); "
          f"phase {time.perf_counter() - t_phase:.1f}s")
    if any(launches.values()):
        raise AssertionError(f"the LM families' path launched {launches}")
    return launches


# --------------------------------------------------------------------------
# persistence: artifacts, the JAX-written fixture, corruption, supervision,
# the fleet, training rollback, frozen-plane faults
# --------------------------------------------------------------------------
JAX_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "jax_artifact_n64")
FIXTURE_RTOL = 1e-4  # the card vs the JAX outputs committed with the fixture
FLEET_CONCURRENCY = 128  # requests in flight in each closed-loop row
FLEET_REPLICAS = (1, 2, 4)
ROBUST_SIGMAS = (0.1, 0.5, 1.0)
ROBUST_N = 128  # eval inputs a phase sigma
_EXPECTED = dict.fromkeys(ops.KERNELS, 0)  # launches the engines below owe
_EXPECTED_LOCK = threading.Lock()


def serve_launches(dep) -> dict:
    """Kernel launches of one frozen forward of ``dep`` on the card:
    ``family_launches``'s serving batch (K1 2L, K2 once, K3 once but none
    for segmentation), with ``rfft_first``'s layer 0 moved from two K1 to
    one more K2."""
    per = dict(family_launches(dep.cfg.depth,
                               readout=dep.family != "seg")["serve"])
    if dep.rfft_first:
        per["conj_phase_scale"] -= 2
        per["phase_tf_apply"] += 1
    return per


class _CountedEngine(InferenceEngine):
    """An ``InferenceEngine`` on its deployment's device that adds what each
    forward on the card owes the launch counters to ``_EXPECTED`` (warmups
    included); nothing else refers to it, so a dropped engine is freed."""

    def __init__(self, deployed, buckets):
        super().__init__(deployed, buckets=buckets, device=deployed.device)

    def _run(self, xp):
        if self.device.type == "cuda":
            with _EXPECTED_LOCK:
                for k, v in serve_launches(self.deployed).items():
                    _EXPECTED[k] += v
        return super()._run(xp)


def _counted_factory(buckets, wrap=None):
    def make(dep):
        eng = _CountedEngine(dep, buckets)
        return eng if wrap is None else wrap(eng)
    return make


def _dep_bytes(dep) -> int:
    """Bytes of one deployment's own tensors (planes, source, masks)."""
    ts = list(tree_leaves(dep.frozen)) + [dep.source]
    if dep.detector is not None:
        ts.append(dep.detector.masks_t)
    return sum(t.numel() * t.element_size() for t in ts)


def _request_batch(dep, b: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).random(
        (b,) + expected_request_shape(dep), np.float32)


def _persist_round_trip(dev, smi: str, tmp: str, deps: dict) -> None:
    """Each deployment saved, cold-started on the card (no device given)
    and on the CPU: bitwise equal to the in-memory deployment at buckets 1,
    8 and 32, within SLICE_RTOL of the CPU copy."""
    for name, dep in deps.items():
        path = os.path.join(tmp, f"rt-{name}")
        t0 = time.perf_counter()
        save_deployed(dep, path)
        save_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loaded = load_deployed(path)
        torch.cuda.synchronize()
        load_ms = (time.perf_counter() - t0) * 1e3
        if loaded.device != dev or loaded.plane_dtype != dep.plane_dtype:
            raise AssertionError(f"{name}: loaded on {loaded.device} as "
                                 f"{loaded.plane_dtype}")
        t0 = time.perf_counter()
        eng = _CountedEngine(loaded, buckets=(1, 8, 32))
        eng.warmup()
        warm_ms = (time.perf_counter() - t0) * 1e3
        x1 = _request_batch(dep, 1, 11)
        t0 = time.perf_counter()
        first = eng.infer(x1)
        first_ms = (time.perf_counter() - t0) * 1e3
        mem = _CountedEngine(dep, buckets=(1, 8, 32))
        for b in (1, 8, 32):
            xb = x1 if b == 1 else _request_batch(dep, b, 11 + b)
            got = first if b == 1 else eng.infer(xb)
            want = mem.infer(xb)
            if not np.array_equal(got, want):
                raise AssertionError(f"{name}: loaded output differs from "
                                     f"the in-memory deployment at bucket {b}")
        x8 = _request_batch(dep, 8, 19)
        cpu = load_deployed(path, device="cpu").forward(
            torch.from_numpy(x8)).numpy()
        _hold_out(f"{name}: loaded on the card", eng.infer(x8), cpu,
                  dep.family != "seg", tag="persistence")
        print(f"[persistence] {name}: bitwise equal to the in-memory "
              f"deployment at buckets 1, 8, 32; save {save_ms:.2f} ms, "
              f"load_deployed {load_ms:.2f} ms, warmup of 3 buckets "
              f"{warm_ms:.2f} ms, first request {first_ms:.3f} ms ({smi})")


def _persist_jax_fixture(dev) -> None:
    """The committed JAX-written artifacts served on the card."""
    x = np.load(os.path.join(JAX_FIXTURE, "x.npy"))
    for variant in ("f32", "bf16", "int8"):
        path = os.path.join(JAX_FIXTURE, variant)
        meta = validate_artifact(path)
        dep = load_deployed(path)
        if dep.device != dev or not dep.cfg.use_pallas:
            raise AssertionError(f"fixture {variant}: {dep.device}")
        got = _CountedEngine(dep, buckets=(8,)).infer(x)
        want = np.load(os.path.join(JAX_FIXTURE, f"jax_out_{variant}.npy"))
        rel = float(np.max(np.abs(got - want)) / np.max(np.abs(want)))
        same = bool(np.array_equal(got.argmax(-1), want.argmax(-1)))
        print(f"[persistence] JAX-written fixture {variant} (format "
              f"{meta['format']}, {dep.plane_dtype} planes, n={dep.cfg.n}, "
              f"depth {dep.cfg.depth}) on the card: rel err vs the JAX "
              f"outputs {rel:.3e} (tol {FIXTURE_RTOL:g}), argmax equal {same}")
        if rel > FIXTURE_RTOL or not same or got.shape != want.shape:
            raise AssertionError(f"fixture {variant}: card and JAX disagree")


def _persist_corruption(tmp: str, good: str) -> None:
    """A flipped payload byte and a falsified crc are refused at load with
    IOError; an unknown format is refused by validate_artifact."""
    for fault, inject in (("corrupt_chunk", corrupt_chunk),
                          ("flip_crc", flip_crc)):
        bad = os.path.join(tmp, f"bad-{fault}")
        shutil.copytree(good, bad)
        inject(os.path.join(bad, PLANES_DIR), 0)
        try:
            load_deployed(bad)
        except IOError as e:
            print(f"[persistence] {fault}: refused at load ({e})")
        else:
            raise AssertionError(f"{fault}: a damaged artifact loaded")
    bad = os.path.join(tmp, "bad-format")
    shutil.copytree(good, bad)
    meta_path = os.path.join(bad, ARTIFACT_FILE)
    with open(meta_path) as f:
        meta = json.load(f)
    meta["format"] = 99
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    try:
        validate_artifact(bad)
    except ValueError as e:
        print(f"[persistence] unknown format: refused by validate_artifact "
              f"({e})")
    else:
        raise AssertionError("validate_artifact took format 99")


def _persist_supervisor(dev, smi: str, art: str, dep) -> None:
    """EngineSupervisor over a CrashingEngine: 5 kill/restart cycles, each
    restart's output bitwise equal to the one before it, and the memory
    after the 5th restart within one deployment's bytes of the 1st's."""
    x = _request_batch(dep, 32, 23)
    sup = EngineSupervisor(
        art, engine_factory=_counted_factory(
            (32,), lambda e: CrashingEngine(e, crash_after=1 << 30)),
        max_restarts=5, backoff_base_ms=0.0).start()
    before = sup.infer(x)
    restart_ms, mems = [], []
    for cycle in range(5):
        sup.engine.kill()
        t0 = time.perf_counter()
        out = sup.infer(x)
        restart_ms.append((time.perf_counter() - t0) * 1e3)
        if not np.array_equal(out, before):
            raise AssertionError(f"restart {cycle + 1}: output changed")
        torch.cuda.synchronize()
        mems.append(torch.cuda.memory_allocated(dev))
    s = sup.stats()
    if s["restarts"] != 5 or not s["ready"]:
        raise AssertionError(f"supervisor: {s}")
    grew = mems[-1] - mems[0]
    budget = _dep_bytes(dep)
    print(f"[persistence] supervisor: 5 kill/restart cycles, failed request "
          f"served again in {', '.join(f'{v:.2f}' for v in restart_ms)} ms "
          f"(rebuild {', '.join(str(h['rebuild_s']) for h in s['restart_history'])}"
          f" s), outputs bitwise equal across restarts; "
          f"memory_allocated after restart 1 {mems[0]} B, after restart 5 "
          f"{mems[-1]} B (grew {grew} B; one deployment {budget} B) ({smi})")
    if grew > budget:
        raise AssertionError("device memory grew across restarts")


def _closed_loop(submit, xs, window_s: float) -> dict:
    """FLEET_CONCURRENCY requests kept in flight for ``window_s`` by one
    submitting thread; req/s and per-request p50/p99 (submit to
    result)."""
    sem = threading.Semaphore(FLEET_CONCURRENCY)
    lat, errors = [], []

    def done(fut, t0):
        t = time.perf_counter() - t0
        exc = fut.exception()
        if exc is None:
            lat.append(t)
        else:
            errors.append(exc)
        sem.release()

    n = 0
    t_start = time.perf_counter()
    t_end = t_start + window_s
    while time.perf_counter() < t_end:
        sem.acquire()
        t0 = time.perf_counter()
        submit(xs[n % len(xs)]).add_done_callback(
            lambda f, t0=t0: done(f, t0))
        n += 1
    for _ in range(FLEET_CONCURRENCY):
        sem.acquire()
    elapsed = time.perf_counter() - t_start
    if errors or len(lat) != n:
        raise AssertionError(f"closed loop: {len(errors)} failed, "
                             f"{n - len(lat)} not served: {errors[:1]}")
    lat_ms = np.asarray(lat) * 1e3
    return dict(requests=n, req_s=n / elapsed,
                p50_ms=float(np.percentile(lat_ms, 50)),
                p99_ms=float(np.percentile(lat_ms, 99)))


def _served_batches(srv) -> tuple:
    """(requests, batches) the engines behind a MicroBatcher or a fleet
    have served so far."""
    engines = ([srv.engine] if isinstance(srv, MicroBatcher) else
               [rep.engine.engine for rep in srv.replicas])
    return (sum(e.stats["requests"] for e in engines),
            sum(e.stats["batches"] for e in engines))


def _persist_fleet(dev, smi: str, art0: str, art1: str, dep0, dep1) -> dict:
    """Replicas on one card: closed-loop req/s and p50/p99 at 1, 2 and 4
    replicas beside MicroBatcher on one engine, with each row's mean batch
    fill (``scripts/fleet_threads.py`` takes the router away: engines in
    threads against engines in processes); a replica killed mid-run and a
    rolling swap under load, each with zero drops and bitwise outputs."""
    xs = _request_batch(dep0, 256, 29)
    ref_eng = _CountedEngine(dep0, buckets=(32,))
    ref0 = ref_eng.infer(xs)
    one = _CountedEngine(dep0, buckets=(32,))
    one.warmup()
    servers = [("MicroBatcher, 1 engine", MicroBatcher(one, max_wait_ms=2.0,
                                                       max_queue=None))]
    for r in FLEET_REPLICAS:
        servers.append((f"FleetRouter, {r} replica{'s' if r > 1 else ''}",
                        FleetRouter.from_artifact(
                            art0, replicas=r, buckets=(32,), max_queue=None,
                            engine_factory=_counted_factory((32,)))))

    perf = {label: [] for label, _ in servers}
    try:
        for rep in range(REPEATS):
            for label, srv in servers:
                _closed_loop(srv.submit, xs, 0.3)  # warm the loop
                n0, b0 = _served_batches(srv)
                r = _closed_loop(srv.submit, xs, WINDOW_S)
                n1, b1 = _served_batches(srv)
                r["fill"] = (n1 - n0) / max(b1 - b0, 1)
                perf[label].append(r)
                print(f"[persistence] {label} (repeat {rep + 1}/{REPEATS}):"
                      f" {r['req_s']:.1f} req/s, bucket 32, mean batch fill "
                      f"{r['fill']:.1f}, {r['requests']} requests, p50 "
                      f"{r['p50_ms']:.3f} ms p99 {r['p99_ms']:.3f} ms ({smi})")
    finally:
        for _, srv in servers:
            if not srv.close():
                raise AssertionError("a fleet row did not close cleanly")
    for label, reps in perf.items():
        rps = [r["req_s"] for r in reps]
        print(f"[persistence] {label}: req/s {min(rps):.1f}-{max(rps):.1f} "
              f"across {REPEATS} repeats")

    # a replica killed mid-run: zero drops, outputs bitwise the reference's
    engines = [_CountedEngine(dep0, buckets=(32,)) for _ in range(2)]
    for e in engines:
        e.warmup()
    router = FleetRouter([CrashingEngine(e, crash_after=1 << 30)
                          for e in engines], seed=0, backoff_base_ms=1.0)
    try:
        futs = [router.submit(x) for x in xs[:128]]
        kill_replica(router)
        futs += [router.submit(x) for x in xs[128:]]
        outs = np.stack([f.result(timeout=120) for f in futs])
    finally:
        clean = router.close()
    s = router.stats()
    print(f"[persistence] kill_replica mid-run: served {s['served']}/"
          f"{len(xs)}, failed {s['failed']}, replica failures "
          f"{s['replica_failures']}, retried {s['retried']}, "
          f"clean close {clean}")
    if not clean or s["failed"] or s["served"] != len(xs):
        raise AssertionError("kill_replica: requests dropped")
    if not np.array_equal(outs, ref0):
        raise AssertionError("kill_replica: outputs differ from the "
                             "reference engine's")

    # a rolling swap under load: zero drops, no DrainingError, every output
    # one of the two models'
    ref1 = _CountedEngine(dep1, buckets=(32,)).infer(xs[:1])[0]
    router = FleetRouter.from_artifact(
        art0, replicas=2, buckets=(32,), max_queue=None,
        engine_factory=_counted_factory((32,)))
    stop = threading.Event()
    live, errs = [], []

    def pump():
        while not stop.is_set():
            try:
                live.append(router.submit(xs[0]))
            except DrainingError:
                errs.append("draining")
            time.sleep(0.0005)

    try:
        t = threading.Thread(target=pump, daemon=True)
        t.start()
        time.sleep(0.2)
        t0 = time.perf_counter()
        meta = router.swap_artifact(art1, rolling=True)
        swap_ms = (time.perf_counter() - t0) * 1e3
        time.sleep(0.2)
        stop.set()
        t.join(timeout=30)
        outs = [f.result(timeout=120) for f in live]
        after = router.submit(xs[0]).result(timeout=120)
    finally:
        clean = router.close()
    n0 = sum(np.array_equal(o, ref0[0]) for o in outs)
    n1 = sum(np.array_equal(o, ref1) for o in outs)
    s = router.stats()
    print(f"[persistence] rolling swap_artifact under load: {len(outs)} "
          f"requests ({n0} old model, {n1} new), DrainingError "
          f"{len(errs)}, failed {s['failed']}, swap {swap_ms:.1f} ms, "
          f"format {meta['format']}, clean close {clean} ({smi})")
    if (errs or s["failed"] or n0 + n1 != len(outs) or not n0 or not n1
            or not np.array_equal(after, ref1) or not clean):
        raise AssertionError("rolling swap dropped or tore a request")
    return perf


def _persist_rollback(dev, smi: str, tmp: str, cfg, params) -> dict:
    """train_classifier with ckpt_dir and guard over a fully poisoned
    chunk: one rollback, and every loss after it bitwise a clean run's;
    then an AsyncCheckpointer save of params and AdamW state, timed."""
    model = build_model(cfg, device=dev)
    xs, ys = synth_digits(512, seed=5)
    poison = range(CHUNK, 2 * CHUNK)

    def stream(skip=()):
        it = batch_iterator(xs, ys, 32, seed=1)
        return (b for i, b in enumerate(it) if i not in set(skip))

    steps = 3 * CHUNK
    res = train_classifier(model, params, poison_batches(stream(), poison),
                           steps=steps, lr=0.3, steps_per_call=CHUNK,
                           guard=True, ckpt_dir=os.path.join(tmp, "train"),
                           ckpt_every=CHUNK)
    clean = train_classifier(model, params, stream(skip=poison),
                             steps=2 * CHUNK, lr=0.3, steps_per_call=CHUNK)
    print(f"[persistence] rollback: {res.rollbacks} rollback(s), "
          f"{len(res.losses)} losses kept; clean run's losses "
          f"{clean.losses[0]:.6f} .. {clean.losses[-1]:.6f}")
    if res.rollbacks != 1 or res.losses != clean.losses:
        raise AssertionError("rollback: losses differ from the clean run's")
    for a, b in zip(tree_leaves(res.params), tree_leaves(clean.params)):
        if not torch.equal(a, b):
            raise AssertionError("rollback: params differ from the clean "
                                 "run's")
    opt = AdamW(lr=0.3)
    state = {"params": res.params, "opt": opt.init(res.params)}
    saver = AsyncCheckpointer(os.path.join(tmp, "async"), keep=2)
    snap_ms, commit_ms = [], []
    for i in range(5):
        t0 = time.perf_counter()
        saver.save(i, state)
        snap_ms.append((time.perf_counter() - t0) * 1e3)
        saver.wait()
        commit_ms.append((time.perf_counter() - t0) * 1e3)
    back = ckpt_restore(os.path.join(tmp, "async"), 4, state)
    for a, b in zip(tree_leaves(back), tree_leaves(state)):
        if a.device != b.device or not torch.equal(a, b):
            raise AssertionError("AsyncCheckpointer: restore differs")
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    print(f"[persistence] AsyncCheckpointer.save of params + AdamW state "
          f"({nbytes} B): returns in {float(np.median(snap_ms)):.3f} ms "
          f"(median of 5; host snapshot), committed in "
          f"{float(np.median(commit_ms)):.3f} ms ({smi})")
    per = train_launches_per_step(cfg.depth)["scan"]
    with _EXPECTED_LOCK:
        for k, v in per.items():
            _EXPECTED[k] += v * (steps + 2 * CHUNK)
    return clean.params


def _persist_robustness(dev, tmp: str, cfg, params) -> None:
    """perturb_frozen: all faults zero is the identity; accuracy at phase
    sigma 0.1, 0.5, 1.0 on the card and on a CPU copy of the same
    artifact (equal correct counts)."""
    model = build_model(cfg, device=dev)
    path = os.path.join(tmp, "robust")
    save_deployed(freeze(model, params, device=dev), path)
    dep, cpu = load_deployed(path), load_deployed(path, device="cpu")
    same = perturb_frozen(dep)
    if any(a is not b for a, b in zip(same.frozen, dep.frozen)):
        raise AssertionError("perturb_frozen with no fault copied a plane")
    xs, ys = synth_digits(ROBUST_N, seed=9)
    base = _CountedEngine(dep, buckets=(32,)).infer(xs)
    if not np.array_equal(_CountedEngine(same, buckets=(32,)).infer(xs),
                          base):
        raise AssertionError("perturb_frozen with no fault changed outputs")
    row = [f"clean {int(np.sum(base.argmax(-1) == ys))}/{ROBUST_N}"]
    for sigma in ROBUST_SIGMAS:
        got = _CountedEngine(perturb_frozen(dep, phase_sigma=sigma, seed=0),
                             buckets=(32,)).infer(xs)
        want = perturb_frozen(cpu, phase_sigma=sigma, seed=0).forward(
            torch.from_numpy(xs)).numpy()
        c_card = int(np.sum(got.argmax(-1) == ys))
        c_cpu = int(np.sum(want.argmax(-1) == ys))
        row.append(f"sigma {sigma}: card {c_card}/{ROBUST_N}, CPU "
                   f"{c_cpu}/{ROBUST_N}")
        if c_card != c_cpu:
            raise AssertionError(f"sigma {sigma}: card and CPU accuracies "
                                 "differ")
    print(f"[persistence] perturb_frozen: no fault is the identity; "
          f"donn-mnist-5l accuracy {'; '.join(row)}")


def phase_persistence(dev, smi: str) -> dict:
    """Artifacts, supervision, the fleet and rollback on the card; returns
    the phase's launches, held against what its engines and training steps
    owe."""
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config("donn-mnist-5l"), use_pallas=True)
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator().manual_seed(0))
    cfg = dataclasses.replace(cfg, gamma=calibrate_gamma(
        model, params, synth_digits(8, seed=3)[0]))
    model = build_model(cfg, device=dev)
    rgb_cfg = dataclasses.replace(get_config("donn-rgb"), use_pallas=True)
    seg_cfg = dataclasses.replace(get_config("donn-seg"), use_pallas=True)
    het_cfg = dataclasses.replace(HYBRID_SLM_PRINTED, use_pallas=True)
    deps = {f"donn-mnist-5l {v}{'+rfft' if r else ''}": freeze(
        model, params, plane_dtype=v, rfft_first=r, device=dev)
        for v, r in (("float32", False), ("bfloat16", False),
                     ("int8", False), ("float32", True))}
    for name, c, seed in (("donn-rgb", rgb_cfg, 4), ("donn-seg", seg_cfg, 5),
                          ("hybrid-slm-printed", het_cfg, 6)):
        m = build_model(c, device=dev)
        deps[name] = freeze(m, m.init(torch.Generator().manual_seed(seed)),
                            device=dev)
    params1 = model.init(torch.Generator().manual_seed(1))
    dep0, dep1 = deps["donn-mnist-5l float32"], freeze(model, params1,
                                                       device=dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_persist_") as tmp:
        art0, art1 = os.path.join(tmp, "art0"), os.path.join(tmp, "art1")
        save_deployed(dep0, art0)
        save_deployed(dep1, art1)
        for k in _EXPECTED:
            _EXPECTED[k] = 0
        out = {}

        def run():
            _persist_round_trip(dev, smi, tmp, deps)
            _persist_jax_fixture(dev)
            _persist_corruption(tmp, art0)
            _persist_supervisor(dev, smi, art0, dep0)
            _persist_fleet(dev, smi, art0, art1, dep0, dep1)
            out["trained"] = _persist_rollback(dev, smi, tmp, cfg, params)
            _persist_robustness(dev, tmp, cfg, out["trained"])

        launches = _counted(run)
    want = dict(_EXPECTED)
    print(f"[persistence] launches {launches} (expected {want}); phase "
          f"{time.perf_counter() - t_phase:.1f}s")
    if launches != want or not all(launches[k] for k in SERVING_KERNELS):
        raise AssertionError("persistence: the kernels did not run as "
                             "counted")
    return launches


# --------------------------------------------------------------------------
# mesh: multi-device DONN training and serving over ranks
# --------------------------------------------------------------------------
MESH_BUCKET = 32  # requests a served batch, and the global training batch
MESH_STEPS = 3  # optimizer steps of each held training run
MESH_RTOL = 1e-5  # sharded vs single-rank loss, d/dphase, logits (SUITE2)
MESH_STEP_RTOL = 2e-3  # params after MESH_STEPS AdamW steps (SUITE2 §2)
MESH_TIMEOUT_S = 900.0  # join timeout of a spawn of ranks
MESH_REPS = 3  # host-clock calls of each timed mesh row


def _mesh_label(world: int, backend: str) -> str:
    """What a mesh row ran on, printed beside each of its lines."""
    if backend == "nccl":
        return "NCCL ranks, one card each"
    if torch.cuda.device_count() < world:
        return "gloo ranks sharing one card, host-staged collectives"
    return "gloo ranks, one card each, host-staged collectives"


def _rel_np(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        return math.inf
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                  1e-30))


def _mesh_grads(loss_fn, params, batch):
    """(loss as a float, grads) of ``loss_fn`` at ``params`` on this rank."""
    loss, grads = ds.value_and_grad(loss_fn, params, batch)
    return float(loss), grads


def _grad_err(got, want) -> float:
    return max(_rel_np(got["phase"][k].cpu(), want["phase"][k].cpu())
               for k in want["phase"])


def _mesh_steps(fn, s_ps, b_ps, mesh, state0, batch) -> tuple:
    """MESH_STEPS steps of a compiled step on this rank's blocks; the
    losses, the gathered phases and the host-clock ms of each step."""
    st = ds.shard_state(state0, s_ps, mesh)
    losses, ms = [], []
    for _ in range(MESH_STEPS):
        t0 = time.perf_counter()
        st, m = fn(st, ds.shard_state(batch, b_ps, mesh))
        losses.append(float(m["loss"]))  # waits for the step
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ds.gather_state(st, s_ps, mesh)["params"], ms


def _ref_steps(cfg, dev, state0, batch) -> tuple:
    step = ds.make_donn_train_step(cfg, AdamW(lr=0.05), device=dev)
    st = tree_map(lambda t: t.to(dev), state0)
    losses = []
    for _ in range(MESH_STEPS):
        st, m = step(st, batch)
        losses.append(float(m["loss"]))
    return losses, st["params"]


def _step_errs(got, want) -> dict:
    (losses, params), (wlosses, wparams) = got, want
    scale = max(float(p.abs().max()) for p in tree_leaves(wparams))
    perr = max(float((params["phase"][k].cpu() - wparams["phase"][k].cpu())
                     .abs().max()) for k in wparams["phase"]) / scale
    lerr = max(abs(a - b) / abs(b) for a, b in zip(losses, wlosses))
    return {"losses": losses, "ref_losses": wlosses, "loss_rel": lerr,
            "param_rel": perr}


def _state0(cfg, seed: int):
    """A global train state drawn on the CPU: every rank draws the same."""
    return init_params(ds.donn_state_specs(cfg),
                       torch.Generator().manual_seed(seed))


def _cls_batch(seed: int, b: int = MESH_BUCKET) -> dict:
    return {"images": _digits(b, seed),
            "labels": (np.arange(b) % 10).astype(np.int64)}


def _mesh_dp(world: int, dev) -> dict:
    """donn-mnist-5l with the kernels, data parallel over every rank:
    serving at bucket 32 (each rank B/world rows) and MESH_STEPS training
    steps, each rank's launches counted; rank 0 then runs the single-rank
    engine and step (not counted)."""
    cfg = dataclasses.replace(get_config("donn-mnist-5l"), use_pallas=True)
    model = build_model(cfg, device=dev)
    dep = freeze(model, model.init(torch.Generator().manual_seed(0)),
                 device=dev)
    x = _digits(MESH_BUCKET, seed=21)
    batch = _cls_batch(22)
    eng = InferenceEngine(dep, buckets=(MESH_BUCKET,), mesh_devices=world,
                          device=dev)
    mesh = shd.make_mesh_2d(world, 1, device=dev)
    fn, s_ps, b_ps, _ = ds.compile_donn_train_step(
        cfg, mesh, optimizer=AdamW(lr=0.05), global_batch=MESH_BUCKET,
        device=dev)
    state0 = _state0(cfg, 1)
    out = {}

    def serve():
        out["logits"] = eng.infer(x)
        out["repeat"] = bool(np.array_equal(out["logits"], eng.infer(x)))

    def train():
        out["train"] = _mesh_steps(fn, s_ps, b_ps, mesh, state0, batch)[:2]

    out["serve_launches"] = _counted(serve)
    out["train_launches"] = _counted(train)
    out["want_serve"] = {k: 2 * v for k, v in serve_launches(dep).items()}
    out["want_train"] = {k: MESH_STEPS * v for k, v in
                         train_launches_per_step(cfg.depth)["scan"].items()}
    if torch.distributed.get_rank() == 0:
        ref = InferenceEngine(dep, buckets=(MESH_BUCKET,),
                              device=dev).infer(x)
        out["serve_rel"] = _rel_np(out["logits"], ref)
        out["argmax_equal"] = bool(np.array_equal(out["logits"].argmax(-1),
                                                  ref.argmax(-1)))
        out["step"] = _step_errs(out["train"],
                                 _ref_steps(cfg, dev, state0, batch))
    del out["train"]
    return out


class _OneRank:
    """A 1x1 mesh seen through its shape: the sharded loss on one rank."""

    shape = {"data": 1, "model": 1}


def _single_grads(cfg, model, params, batch, dev, plain: bool = False):
    """(loss, d/dphase) on this rank alone: the model's own loss (cuFFT's
    fft2 hops), or with ``plain`` the sharded loss on a one-rank mesh (the
    pencil FFT's passes, W then H, with no exchange)."""
    b = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}

    def loss_fn(p, bb):
        if cfg.segmentation:
            return bce_segmentation_loss(model.apply(p, bb["images"],
                                                     train=True), bb["masks"])
        return mse_softmax_loss(model.apply(p, bb["images"]), bb["labels"],
                                cfg.num_classes)

    if plain:
        loss_fn = ds.make_donn_sharded_loss(cfg, _OneRank(), device=dev)
    return _mesh_grads(loss_fn, params, b)


def _sharded_case(cfg, params, batch, d: int, m: int, dev,
                  calibrate: bool) -> dict:
    """The sharded loss and d/dphase at a (d, m) mesh against the
    single-rank ones (rank 0 returns them).

    The loss is held against both single-rank losses (the pencil FFT's
    passes and fft2), d/dphase against the same passes on one rank: cuFFT's
    fft2 and the two 1-D passes round apart, and at depth 30 that alone
    moves d/dphase by about 1e-5 of its max (printed beside).  A classify
    loss (``calibrate``) is held at the gamma ``calibrate_gamma`` picks: at
    a config's own gamma its logits reach thousands and the saturated
    softmax turns any f32 reordering into d/dphase gaps far above 1e-5;
    rank 0 prints that floor, one rank's passes against fft2 at the
    config's gamma."""
    rank0 = torch.distributed.get_rank() == 0
    model = build_model(cfg, device=dev)
    out = {}
    if calibrate:
        if rank0:
            out["floor"] = _grad_err(
                _single_grads(cfg, model, params, batch, dev, plain=True)[1],
                _single_grads(cfg, model, params, batch, dev)[1])
        gamma = [calibrate_gamma(model, params, batch["images"])
                 if rank0 else None]
        torch.distributed.broadcast_object_list(gamma, src=0)
        cfg = dataclasses.replace(cfg, gamma=gamma[0])
        model = build_model(cfg, device=dev)
        out["gamma"] = gamma[0]
    mesh = shd.make_mesh_2d(d, m, device=dev)
    rules = shd.donn_rules()
    pps = shd.tree_pspecs(ds.donn_state_specs(cfg)["params"], mesh, rules)
    bps = {k: shd.batch_pspec(mesh, np.ndim(v), rules)
           for k, v in batch.items()}
    loss_fn = ds.make_donn_sharded_loss(cfg, mesh, device=dev)
    t0 = time.perf_counter()
    loss, grads = _mesh_grads(loss_fn, ds.shard_state(params, pps, mesh),
                              ds.shard_state(batch, bps, mesh))
    out["ms"] = (time.perf_counter() - t0) * 1e3
    grads = ds.gather_state(grads, pps, mesh)
    if not rank0:
        return None
    plain = _single_grads(cfg, model, params, batch, dev, plain=True)
    fft2 = _single_grads(cfg, model, params, batch, dev)
    return {**out, "loss": loss, "ref_loss": fft2[0],
            "loss_rel": max(abs(loss - r[0]) / abs(r[0])
                            for r in (plain, fft2)),
            "grad_rel": _grad_err(grads, plain[1]),
            "fft2_grad_rel": _grad_err(grads, fft2[1]),
            "fft2_floor": _grad_err(plain[1], fft2[1])}


def _mesh_xl(world: int, dev, meshes: dict) -> dict:
    """donn-xl-500 at full width, row-sharded: the loss and d/dphase at each
    mesh of ``meshes["loss"]``, MESH_STEPS sharded steps at
    ``meshes["step"]``, the row-sharded engines of ``meshes["serve"]``, and
    the times of the pencil fft2 and of the engine (rank 0 reports)."""
    cfg = get_config("donn-xl-500")
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator().manual_seed(0))
    batch = _cls_batch(31)
    rank0 = torch.distributed.get_rank() == 0
    out = {"loss": {}, "serve": {}}
    for d, m in meshes["loss"]:
        out["loss"][f"{d}x{m}"] = _sharded_case(cfg, params, batch, d, m,
                                                dev, calibrate=True)
    for d, m in meshes["step"]:
        mesh = shd.make_mesh_2d(d, m, device=dev)
        fn, s_ps, b_ps, _ = ds.compile_donn_train_step_sharded(
            cfg, mesh, optimizer=AdamW(lr=0.05), global_batch=MESH_BUCKET,
            device=dev)
        state0 = _state0(cfg, 1)
        losses, phases, ms = _mesh_steps(fn, s_ps, b_ps, mesh, state0, batch)
        if rank0:
            out[f"step {d}x{m}"] = {**_step_errs(
                (losses, phases), _ref_steps(cfg, dev, state0, batch)),
                "ms": ms}
    dep = freeze(model, params, device=dev)
    x = _digits(MESH_BUCKET, seed=32)
    want = (InferenceEngine(dep, buckets=(MESH_BUCKET,), device=dev).infer(x)
            if rank0 else None)
    for d, m in meshes["serve"]:
        eng = InferenceEngine(dep, buckets=(MESH_BUCKET,), mesh_devices=d,
                              model_devices=m, device=dev)
        got = eng.infer(x)
        same = bool(np.array_equal(got, eng.infer(x)))
        ms = []
        for _ in range(MESH_REPS):
            t0 = time.perf_counter()
            eng.infer(x)
            ms.append((time.perf_counter() - t0) * 1e3)
        if want is not None:
            out["serve"][f"{d}x{m}"] = {
                "rel": _rel_np(got, want), "repeat": same,
                "argmax_equal": bool(np.array_equal(got.argmax(-1),
                                                    want.argmax(-1))),
                "req_s": [MESH_BUCKET / (t / 1e3) for t in ms]}
    # one pencil fft2 of this rank's rows of a (32, 500, 500) field
    mesh = shd.make_mesh_2d(1, world, device=dev)
    fft2, _ = pencil_fft.local_spectral_pair(mesh.get_group("model"), world)
    u = _cfield((MESH_BUCKET, cfg.n // world, cfg.n),
                torch.Generator().manual_seed(5), dev)
    fft2(u)
    ms = []
    for _ in range(MESH_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fft2(u)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    out["pencil_ms"] = ms
    out["pencil_shape"] = (MESH_BUCKET, cfg.n, cfg.n)
    return out


def _mesh_families(world: int, dev, shape) -> dict:
    """donn-rgb and donn-seg (full width, no kernels) at the (2, 2) mesh,
    or hybrid-slm-printed at (1, 2): the sharded loss and d/dphase against
    the single-rank ones."""
    out = {}
    cases = ((("donn-rgb", get_config("donn-rgb")),
              ("donn-seg", get_config("donn-seg")))
             if shape == (2, 2) else
             (("hybrid-slm-printed", HYBRID_SLM_PRINTED),))
    for name, cfg in cases:
        params = build_model(cfg, device=dev).init(
            torch.Generator().manual_seed(7))
        rng = np.random.default_rng(8)
        if cfg.channels > 1:
            batch = {"images": rng.random((MESH_BUCKET, cfg.channels, 28, 28),
                                          np.float32),
                     "labels": np.arange(MESH_BUCKET) % cfg.num_classes}
        elif cfg.segmentation:
            batch = {"images": rng.random((MESH_BUCKET, 28, 28), np.float32),
                     "masks": (rng.random((MESH_BUCKET, cfg.n, cfg.n)) > 0.5)
                     .astype(np.float32)}
        else:
            batch = _cls_batch(9)
        out[name] = _sharded_case(cfg, params, batch, *shape, dev,
                                  calibrate=not cfg.segmentation)
    return out


def _mesh_rank(rank: int, world: int) -> dict:
    """Every mesh hold of a world of ``world`` gloo ranks on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"dp": _mesh_dp(world, dev)}
    if world == 2:
        out["xl"] = _mesh_xl(world, dev, {"loss": [(1, 2)], "step": [],
                                          "serve": [(1, 2)]})
        out["families"] = _mesh_families(world, dev, (1, 2))
    else:
        out["xl"] = _mesh_xl(world, dev, {"loss": [(2, 2), (1, 4)],
                                          "step": [(2, 2)],
                                          "serve": [(1, 4), (2, 2)]})
        out["families"] = _mesh_families(world, dev, (2, 2))
    return out


def _mesh_holds(world: int, backend: str, ranks: list, smi: str,
                bad: list) -> dict:
    """Print and check one spawn's results; returns its launches summed
    over the ranks.  Failed holds are appended to ``bad``."""
    tag = f"[mesh] {world} {_mesh_label(world, backend)}"

    def hold(what, ok, line):
        print(f"{tag}: {what}: {line}{'' if ok else '  FAILED'}")
        if not ok:
            bad.append(f"{world} ranks: {what}")

    total = dict.fromkeys(ops.KERNELS, 0)
    for r, res in enumerate(ranks):
        dp = res["dp"]
        for part in ("serve", "train"):
            got, want = dp[f"{part}_launches"], dp[f"want_{part}"]
            hold(f"rank {r} data-parallel {part} launches", got == want,
                 f"{got} (expected {want})")
            _add(total, got)
    dp = ranks[0]["dp"]
    hold("data-parallel serving vs the single-rank engine",
         dp["serve_rel"] <= MESH_RTOL and dp["argmax_equal"]
         and all(r["dp"]["repeat"] for r in ranks)
         and all(np.array_equal(r["dp"]["logits"], dp["logits"])
                 for r in ranks),
         f"rel {dp['serve_rel']:.3e} (tol {MESH_RTOL:g}), argmax equal "
         f"{dp['argmax_equal']}, repeats bitwise, every rank the whole "
         "logits")
    s = dp["step"]
    hold(f"data-parallel step ({MESH_STEPS} steps) vs the single-device "
         "step", s["loss_rel"] <= MESH_RTOL and s["param_rel"] <= MESH_STEP_RTOL,
         f"losses {s['losses']} vs {s['ref_losses']} (rel "
         f"{s['loss_rel']:.3e}), params rel {s['param_rel']:.3e} (tol "
         f"{MESH_STEP_RTOL:g})")
    xl = ranks[0]["xl"]
    def loss_line(c):
        line = (f"loss {c['loss']:.6f} vs {c['ref_loss']:.6f} (rel "
                f"{c['loss_rel']:.3e} of both single-rank losses), d/dphase "
                f"rel {c['grad_rel']:.3e} against the same passes on one "
                f"rank (tol {MESH_RTOL:g}), {c['fft2_grad_rel']:.3e} against "
                f"fft2 (one rank's passes against fft2: "
                f"{c['fft2_floor']:.3e}); {c['ms']:.1f} ms value+grad")
        if "gamma" in c:
            line += (f"; at calibrated gamma {c['gamma']:.6f} (at the "
                     f"config's gamma one rank's pencil passes and fft2 "
                     f"differ by {c['floor']:.3e} in d/dphase)")
        return line

    for shape, c in xl["loss"].items():
        hold(f"donn-xl-500 sharded loss at {shape}",
             c["loss_rel"] <= MESH_RTOL and c["grad_rel"] <= MESH_RTOL,
             loss_line(c))
    for key in [k for k in xl if k.startswith("step")]:
        s = xl[key]
        hold(f"donn-xl-500 {key} ({MESH_STEPS} sharded steps)",
             s["loss_rel"] <= MESH_RTOL and s["param_rel"] <= MESH_STEP_RTOL,
             f"losses {s['losses']} vs {s['ref_losses']} (rel "
             f"{s['loss_rel']:.3e}), params rel {s['param_rel']:.3e}; ms a "
             f"step {[round(t, 2) for t in s['ms']]} ({smi})")
    for shape, c in xl["serve"].items():
        hold(f"donn-xl-500 row-sharded engine at {shape}",
             c["rel"] <= MESH_RTOL and c["repeat"] and c["argmax_equal"],
             f"rel {c['rel']:.3e}, repeat bitwise {c['repeat']}; req/s "
             f"{[round(v, 2) for v in c['req_s']]} at bucket {MESH_BUCKET} "
             f"({smi})")
    print(f"{tag}: pencil fft2 of {xl['pencil_shape']} over {world} "
          f"ranks: ms {[round(t, 3) for t in xl['pencil_ms']]} ({smi})")
    for name, c in ranks[0]["families"].items():
        hold(f"{name} sharded loss",
             c["loss_rel"] <= MESH_RTOL and c["grad_rel"] <= MESH_RTOL,
             loss_line(c))
    return total


def _mesh_nccl(dev, smi: str, bad: list):
    """NCCL at world size = the cards there are: a (1, 1) mesh in this
    process (the data-parallel step over it and the engine bitwise the same
    calls with no process group), then with 2+ cards every mesh hold again
    on one NCCL rank a card (up to 4), whose launches it returns."""
    cfg = dataclasses.replace(get_config("donn-mnist-5l"), use_pallas=True)
    model = build_model(cfg, device=dev)
    dep = freeze(model, model.init(torch.Generator().manual_seed(0)),
                 device=dev)
    x = _digits(MESH_BUCKET, seed=21)
    batch = _cls_batch(22)
    state0 = _state0(cfg, 1)
    want_logits = InferenceEngine(dep, buckets=(MESH_BUCKET,),
                                  device=dev).infer(x)
    want = _ref_steps(cfg, dev, state0, batch)
    mesh = shd.make_mesh_2d(1, 1, device=dev)  # NCCL, one rank
    try:
        backend = torch.distributed.get_backend()
        got_logits = InferenceEngine(dep, buckets=(MESH_BUCKET,),
                                     mesh_devices=1, device=dev).infer(x)
        fn, s_ps, b_ps, _ = ds.compile_donn_train_step(
            cfg, mesh, optimizer=AdamW(lr=0.05), global_batch=MESH_BUCKET,
            device=dev)
        losses, phases, _ = _mesh_steps(fn, s_ps, b_ps, mesh, state0, batch)
    finally:
        torch.distributed.destroy_process_group()
    same = (np.array_equal(got_logits, want_logits) and losses == want[0]
            and all(torch.equal(phases["phase"][k], want[1]["phase"][k])
                    for k in want[1]["phase"]))
    print(f"[mesh] {backend} at world size 1 on a (1, 1) mesh: engine and "
          f"data-parallel step bitwise the calls without a process group: "
          f"{same}")
    if not same:
        bad.append("NCCL (1, 1) mesh")
    n = torch.cuda.device_count()
    if n < 2:
        print(f"[mesh] {n} card: NCCL ran at 1 rank only; the data-parallel "
              "and row-sharded holds ran on gloo ranks sharing the card")
        return None
    world = min(n, 4)
    ranks = spawn_ranks(_mesh_rank, world, (world,), device_type="cuda",
                        backend="nccl", timeout=MESH_TIMEOUT_S)
    return _mesh_holds(world, "nccl", ranks, smi, bad)


def phase_mesh(dev, smi: str) -> dict:
    """The multi-device slice on the card: gloo ranks sharing it (2, then
    4), NCCL at the cards' count; returns the mesh launches summed over
    every rank."""
    t_phase = time.perf_counter()
    cfg = get_config("donn-xl-500")
    u = _cfield((MESH_BUCKET, cfg.n, cfg.n), torch.Generator().manual_seed(5),
                dev)
    print(f"[mesh] torch.fft.fft2 of {tuple(u.shape)}, one process: "
          f"{device_ms(lambda: torch.fft.fft2(u), reps=20):.3f} ms ({smi})")
    del u
    xl = build_model(cfg, device=dev)
    eng = InferenceEngine(freeze(xl, xl.init(torch.Generator().manual_seed(0)),
                                 device=dev), buckets=(MESH_BUCKET,),
                          device=dev)
    x = _digits(MESH_BUCKET, seed=32)
    eng.infer(x)
    ms = []
    for _ in range(MESH_REPS):
        t0 = time.perf_counter()
        eng.infer(x)
        ms.append((time.perf_counter() - t0) * 1e3)
    print(f"[mesh] donn-xl-500 engine, one process (k=1): req/s "
          f"{[round(MESH_BUCKET / (t / 1e3), 2) for t in ms]} at bucket "
          f"{MESH_BUCKET} ({smi})")
    del eng, xl
    torch.cuda.empty_cache()
    bad, total = [], dict.fromkeys(ops.KERNELS, 0)
    for world in (2, 4):
        t0 = time.perf_counter()
        ranks = spawn_ranks(_mesh_rank, world, (world,), device_type="cuda",
                            backend="gloo", timeout=MESH_TIMEOUT_S)
        _add(total, _mesh_holds(world, "gloo", ranks, smi, bad))
        print(f"[mesh] {world} ranks: {time.perf_counter() - t0:.1f}s")
    nccl = _mesh_nccl(dev, smi, bad)
    if nccl is not None:
        _add(total, nccl)
    print(f"[mesh] launches summed over the ranks {total}; phase "
          f"{time.perf_counter() - t_phase:.1f}s")
    if bad:
        raise AssertionError("mesh holds failed: " + "; ".join(bad))
    return total


# --------------------------------------------------------------------------
# lm_mesh: LM tensor, data, sequence and expert parallelism over a
# (data, model) mesh of ranks (gloo ranks sharing the one card)
# --------------------------------------------------------------------------
LM_MESH_TRAIN = (8, 4)  # depth, launcher steps of qwen1.5-4b at 2x2
LM_MESH_HOLDS = {4: (("qwen1.5-4b", (2, 2), 2),),
                 3: (("qwen1.5-4b", (1, 3), 2),),  # heads, vocab whole
                 2: (("falcon-mamba-7b", (1, 2), 2),
                     ("mixtral-8x7b", (1, 2), 1))}  # arch, mesh, depth
LM_MESH_HOLD = (2, 16, 8)  # batch, seq, decode steps of the f32 holds
LM_MESH_ELASTIC = ("musicgen-medium", 2)  # arch, depth of the elastic state
LM_MESH_TIMEOUT_S = 900.0


def _rank0() -> bool:
    return torch.distributed.get_rank() == 0


def _on(flags: list, dev) -> list:
    """Launcher flags with ``--device`` set to ``dev``'s type."""
    i = flags.index("--device")
    return flags[:i + 1] + [dev.type] + flags[i + 2:]


def _mesh_peak(run) -> tuple:
    """(run's result, this rank's peak allocated GB during it)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = run()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() / 1e9


def _mesh_serve(mesh: str, dev) -> dict:
    """``serve.main --mesh`` at qwen1.5-4b's full width and depth on this
    rank; rank 0's tokens/s (host clock of the slot loop)."""
    real, seen = serve.serve_requests, {}

    def recording(*a, **kw):
        seen.update(real(*a, **kw))
        return seen

    serve.serve_requests = recording
    try:
        served, peak = _mesh_peak(lambda: serve.main(
            ["--arch", "qwen1.5-4b", "--mesh", mesh]
            + _on(LM_SERVE_FLAGS, dev)))
    finally:
        serve.serve_requests = real
    torch.cuda.empty_cache()
    return {"served": served, "tok_s": served / seen["seconds"],
            "peak_gb": peak, "outputs": seen["outputs"]}


@contextlib.contextmanager
def _collective_clock(dev, spent: list):
    """Inside, every ``torch.distributed`` all-reduce, all-gather and
    reduce-scatter appends its host seconds to ``spent`` (the device
    synchronised before and after: gloo stages CUDA tensors through the
    host, so nothing overlaps it)."""
    dist = torch.distributed
    names = ("all_reduce", "all_gather", "reduce_scatter_tensor")
    real = {n: getattr(dist, n) for n in names}

    def timed(fn):
        def run(*a, **kw):
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            spent.append(time.perf_counter() - t0)
            return out
        return run

    for n in names:
        setattr(dist, n, timed(real[n]))
    try:
        yield
    finally:
        for n in names:
            setattr(dist, n, real[n])


def _mesh_train(tmp: str, dev) -> dict:
    """``lm_train.main --mesh 2x2`` on qwen1.5-4b at full width, depth
    LM_MESH_TRAIN[0]; each step's seconds, the seconds its collectives
    took on this rank, and this rank's peak memory."""
    depth, n = LM_MESH_TRAIN
    cfg = dataclasses.replace(lm_config("qwen1.5-4b"), n_layers=depth)
    real_cfg, real_compile = lm_train.get_config, lm_steps.compile_train_step
    lm_train.get_config = lambda arch, smoke=False: cfg
    path = os.path.join(tmp, "train_metrics.json")
    gloo = []

    def compile_train_step(*a, **kw):
        fn, s_place, b_place, sspecs = real_compile(*a, **kw)

        def step(state, batch):
            spent = []
            with _collective_clock(dev, spent):
                out = fn(state, batch)
                float(out[1]["loss"])
            gloo.append(sum(spent))
            return out

        return step, s_place, b_place, sspecs

    lm_steps.compile_train_step = compile_train_step
    try:
        losses, peak = _mesh_peak(lambda: lm_train.main(
            ["--arch", "qwen1.5-4b", "--mesh", "2x2", "--steps", str(n),
             "--metrics-out", path] + _on(LM_TRAIN_FLAGS, dev)))
    finally:
        lm_train.get_config = real_cfg
        lm_steps.compile_train_step = real_compile
    torch.cuda.empty_cache()
    out = {"peak_gb": peak, "losses": losses, "params": _n_params(cfg),
           "gloo_s": gloo}
    if _rank0():
        out["step_seconds"] = json.load(open(path))["step_seconds"]
    return out


def _elastic_cfg():
    arch, depth = LM_MESH_ELASTIC
    return dataclasses.replace(lm_config(arch), n_layers=depth)


def _mesh_elastic_save(dev, tmp: str) -> dict:
    """A train state drawn at 2x2 (random moments too) and saved under
    the mesh; rank 0 returns each leaf's digest as saved."""
    cfg = _elastic_cfg()
    mesh = shd.make_mesh_2d(2, 2, device=dev)
    sspecs = lm_steps.train_state_specs(cfg)
    place = shd.tree_shardings(sspecs, mesh)
    gen = torch.Generator(device=dev).manual_seed(4)
    drawn = {k: v if k in ("params", "step") else tree_map(
        lambda p: dataclasses.replace(p, init="normal", scale=1e-3), v)
        for k, v in sspecs.items()}  # moments drawn too, not zeros
    state = init_params(drawn, gen, mesh)
    t0 = time.perf_counter()
    ckpt_save(os.path.join(tmp, "elastic"), 1, state, mesh=mesh,
              pspecs=place)
    sec = time.perf_counter() - t0
    whole = shd.gather_tree(state, place, mesh)
    return {"digests": [_digest(t) for t in tree_leaves(whole)],
            "save_s": sec, "bytes": sum(t.numel() * t.element_size()
                                        for t in tree_leaves(whole))}


def _digest(t) -> str:
    import hashlib

    return hashlib.sha1(t.detach().reshape(-1).contiguous()
                        .view(torch.uint8).cpu().numpy().tobytes()
                        ).hexdigest()


def _mesh_elastic_restore(dev, tmp: str) -> dict:
    """The 2x2 state restored at 1x2: this rank's leaf shapes against its
    resolve_pspec blocks, and the gathered leaves' digests."""
    cfg = _elastic_cfg()
    mesh = shd.make_mesh_2d(1, 2, device=dev)
    sspecs = lm_steps.train_state_specs(cfg)
    place = shd.tree_shardings(sspecs, mesh)
    t0 = time.perf_counter()
    state = ckpt_restore(os.path.join(tmp, "elastic"), 1,
                         shd.abstract_like(sspecs), device=dev, mesh=mesh,
                         pspecs=place)
    sec = time.perf_counter() - t0
    want = [tuple(t.shape) for t in tree_leaves(
        shd.sharded_zeros(sspecs, mesh, device="meta"))]
    whole = shd.gather_tree(state, place, mesh)
    return {"digests": [_digest(t) for t in tree_leaves(whole)],
            "restore_s": sec,
            "shapes_ok": [tuple(t.shape) for t in tree_leaves(state)] == want}


def _block_errs(got, want, spec, mesh, top=None) -> float:
    """max|this rank's block - its block of ``want``| over max|want| (or
    ``top``)."""
    ref = shd.local_block(want, spec, mesh)
    return float((got - ref).abs().max()) / (
        top if top is not None else max(float(want.abs().max()), 1e-30))


def _mesh_hold(dev, arch: str, shape, depth: int) -> dict:
    """f32 at full width, ``depth`` layers, batch 2 x seq 16: the sharded
    prefill logits, lm_loss, every gradient and LM_MESH_HOLD[2] decode
    steps at ``shape`` against one rank on the card.  Every rank runs the
    one-rank reference too and compares its own blocks (no gather of the
    sharded results); the report takes the worst rank."""
    b, s, n_dec = LM_MESH_HOLD
    cfg = dataclasses.replace(lm_config(arch), n_layers=depth,
                              dtype=torch.float32)
    dcfg = (dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
            if cfg.family == "moe" else cfg)
    mesh = shd.make_mesh_2d(*shape, device=dev)
    rng = np.random.default_rng(13)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))
             .to(dev) for k in ("tokens", "labels")}
    specs = {k: type("Spec", (), {"shape": tuple(v.shape)})
             for k, v in batch.items()}
    p_place = shd.tree_shardings(lm.param_specs(cfg), mesh)
    params = lm.init(cfg, torch.Generator(device=dev).manual_seed(7),
                     mesh=mesh)
    fn, _, b_place, _ = lm_steps.compile_prefill_step(cfg, mesh, specs,
                                                      device=dev)
    local_b = shd.local_tree(batch, b_place, mesh)
    lg_spec = lm_steps.logits_sharding(cfg, mesh, b)
    real, routes = moe.route, []

    def recording(p, xg, c):
        out = real(p, xg, c)
        routes.append(out)
        return out

    moe.route = recording
    try:
        t0 = time.perf_counter()
        with torch.no_grad():
            logits = fn(params, local_b)
        with shd.activation_sharding(mesh):
            loss, grads = lm_steps.loss_and_grads(
                lambda p, bb: lm.lm_loss(p, bb, cfg), params, local_b,
                pspecs=p_place, mesh=mesh)
        sharded_routes = list(routes)
        dfn, _, _, cspecs = lm_steps.compile_decode_step(dcfg, mesh, b, s,
                                                         device=dev)
        cache = shd.sharded_zeros(cspecs, mesh, device=dev)
        tok_place = shd.batch_sharding(mesh, 2, batch_size=b)
        dec = []
        with torch.no_grad():
            for t in range(n_dec):
                lg, cache = dfn(params, cache, shd.local_block(
                    batch["tokens"][:, t:t + 1], tok_place, mesh), t)
                dec.append(lg[:, 0])
        dec = torch.stack(dec, 1)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        del params, cache
        routes.clear()
        # one rank: the same draws whole, on the card (every rank)
        one = lm.init(cfg, torch.Generator(device=dev).manual_seed(7))
        with torch.no_grad():
            want_logits = lm.logits_fn(one, batch["tokens"], cfg)
        want_loss, want_grads = lm_steps.loss_and_grads(
            lambda p, bb: lm.lm_loss(p, bb, cfg), one, batch)
        one_routes = list(routes)
        cache = lm.init_cache(dcfg, b, s, device=dev)
        want_dec = []
        with torch.no_grad():
            for t in range(n_dec):
                want_dec.append(lm.decode_step(
                    one, cache, batch["tokens"][:, t:t + 1], t, dcfg)[0][:, 0])
            prefill = (want_logits if cfg.family != "moe" else
                       lm.logits_fn(one, batch["tokens"], dcfg))[:, :n_dec]
        want_dec = torch.stack(want_dec, 1)
    finally:
        moe.route = real
    top = max(float(w.abs().max()) for w in tree_leaves(want_grads))
    grad_rel = {}
    for path, g, w, spec in zip(tree_paths(want_grads), tree_leaves(grads),
                                tree_leaves(want_grads),
                                _spec_leaves(p_place)):
        # a leaf whose gradient is zero in exact arithmetic (bk) against
        # the largest gradient, as the lm_train phase holds it
        zero = any(z in path for z in ZERO_GRAD_LEAVES)
        grad_rel[path] = _block_errs(g, w, spec, mesh, top if zero else None)
    parted, margins = 0, []
    if cfg.family == "moe":
        k = cfg.top_k
        for (probs, _, idx), (_, _, oidx) in zip(sharded_routes, one_routes):
            differ = (idx.sort(-1).values != oidx.sort(-1).values).any(-1)
            tops = probs.sort(-1, descending=True).values
            parted += int(differ.sum())
            margins += (tops[..., k - 1] - tops[..., k])[differ].tolist()
    dec_spec = lg_spec[:1] + (None,) + lg_spec[2:]
    return {"arch": arch, "depth": depth, "mesh": shape,
            "params": _n_params(cfg),
            "logits": _block_errs(logits, want_logits, lg_spec, mesh),
            "loss": abs(float(loss) - float(want_loss)) / float(want_loss),
            "grads": max(grad_rel.values()),
            "worst_grad": max(grad_rel, key=grad_rel.get),
            "decode": _block_errs(dec, want_dec, dec_spec, mesh),
            "decode_prefill": _block_errs(dec, prefill, dec_spec, mesh),
            "parted": parted, "margins": margins, "ms": ms}


def _spec_leaves(place) -> list:
    """The spec tuples of a placement tree, in ``tree_leaves`` order."""
    if isinstance(place, dict):
        return [s for k in sorted(place) for s in _spec_leaves(place[k])]
    return [place]


def _lm_mesh_rank(rank: int, world: int, tmp: str,
                  device_type: str = "cuda") -> dict:
    """Every lm_mesh case of a world of ``world`` gloo ranks on the card
    (``device_type`` "cpu" rehearses it); each rank's K1-K7 launches over
    all of them."""
    torch.backends.cuda.matmul.allow_tf32 = False
    # the ranks share the host's cores: one intra-op thread each, so no
    # rank's idle pool spins on the cores another rank's gloo needs
    torch.set_num_threads(1)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device(device_type))
    ops.reset_launch_counts()
    out = {}
    if world == 4:
        out["train"] = _mesh_train(tmp, dev)
        out["serve"] = _mesh_serve("1x4", dev)
        out["elastic"] = _mesh_elastic_save(dev, tmp)
    elif world == 2:
        out["serve"] = _mesh_serve("1x2", dev)
        out["elastic"] = _mesh_elastic_restore(dev, tmp)
    out["holds"] = [_mesh_hold(dev, arch, shape, depth)
                    for arch, shape, depth in LM_MESH_HOLDS[world]]
    torch.cuda.synchronize()
    out["launches"] = ops.launch_counts()
    out["rank"] = rank
    return out


def _lm_mesh_report(world: int, ranks: list, smi: str, bad: list,
                    label: str) -> None:
    tag = f"[lm_mesh] {world} {label}"

    def hold(what, ok, line):
        print(f"{tag}: {what}: {line}{'' if ok else '  FAILED'}")
        if not ok:
            bad.append(f"{world} ranks: {what}")

    r0 = ranks[0]
    if "serve" in r0:
        peaks = [round(r["serve"]["peak_gb"], 2) for r in ranks]
        sv = r0["serve"]
        hold(f"qwen1.5-4b serving at 1x{world} (full width and depth, "
             f"{lm_config('qwen1.5-4b').dtype} matmuls)",
             sv["served"] == 24 * 32,
             f"{sv['served']} tokens, {sv['tok_s']:.1f} tok/s (8 slots, 24 "
             f"requests, prompt 16, 32 new tokens, cache 128); each rank's "
             f"peak memory {peaks} GB ({smi})")
    if "train" in r0:
        tr = r0["train"]
        secs = tr["step_seconds"]
        timed = secs[1:]
        sec = float(np.median(timed))
        losses = tr["losses"]
        ok = len(losses) == LM_MESH_TRAIN[1] and all(map(math.isfinite,
                                                         losses))
        share = [round(g / t, 3) for g, t in zip(tr["gloo_s"][1:], timed)]
        hold(f"qwen1.5-4b training at 2x2 (full width, depth "
             f"{LM_MESH_TRAIN[0]}, {tr['params'] / 1e9:.3f}B params, batch 8 "
             f"x seq 128)", ok,
             f"losses {[round(v, 4) for v in losses]}; steps/s {1 / sec:.3f} "
             f"(median of steps {[round(t, 3) for t in timed]} s; the first, "
             f"{secs[0]:.3f} s, apart), tokens/s {LM_TRAIN_TOKENS / sec:.1f}; "
             f"rank 0's collectives (host clock, device synchronised) "
             f"{[round(g, 3) for g in tr['gloo_s'][1:]]} s, a share "
             f"{share} of those steps; each rank's peak memory "
             f"{[round(r['train']['peak_gb'], 2) for r in ranks]} GB ({smi})")
    el = r0.get("elastic", {})
    if "save_s" in el:
        print(f"{tag}: elastic state ({LM_MESH_ELASTIC[0]} full width, depth "
              f"{LM_MESH_ELASTIC[1]}, params and random moments, "
              f"{el['bytes'] / 1e9:.3f} GB) saved at 2x2 in "
              f"{el['save_s']:.2f} s ({smi})")
    for i, h in enumerate(r0["holds"]):
        every = [r["holds"][i] for r in ranks]
        worst = max(every, key=lambda x: x["grads"])
        h = {**h, **{k: max(x[k] for x in every) for k in (
            "logits", "loss", "grads", "decode", "decode_prefill")},
             "worst_grad": worst["worst_grad"]}
        what = (f"{h['arch']} f32 {h['depth']} layers "
                f"({h['params'] / 1e9:.3f}B params) at {h['mesh']} vs one "
                f"rank on the card")
        line = (f"worst rank: logits {h['logits']:.3e}, loss "
                f"{h['loss']:.3e}, grads {h['grads']:.3e} (worst "
                f"{h['worst_grad']}), {LM_MESH_HOLD[2]} decode steps "
                f"{h['decode']:.3e} (tol {MESH_RTOL:g}); decode vs the "
                f"one-rank prefill {h['decode_prefill']:.3e} (tol "
                f"{MESH_RTOL:g}); sharded ms {h['ms']:.1f}")
        if h["arch"].startswith("mixtral"):
            line += (f"; tokens routed to another expert set than on one "
                     f"rank: {h['parted']}, their top-2 margins "
                     f"{h['margins']}")
        hold(what, max(h["logits"], h["loss"], h["grads"], h["decode"],
                       h["decode_prefill"]) <= MESH_RTOL, line)


def _lm_mesh_nccl(smi: str) -> None:
    """With 2+ cards: the launchers at one NCCL rank a card (they pick
    NCCL themselves when the cards suffice)."""
    n = torch.cuda.device_count()
    if n < 2:
        print(f"[lm_mesh] {n} card: the NCCL path (one rank a card) did not "
              "run; every mesh above ran as gloo ranks sharing the card")
        return
    m = min(n, 4)
    t0 = time.perf_counter()
    served = serve.main(["--arch", "qwen1.5-4b", "--mesh", f"1x{m}"]
                        + LM_SERVE_FLAGS)
    print(f"[lm_mesh] NCCL 1x{m}: qwen1.5-4b served {served} tokens in "
          f"{time.perf_counter() - t0:.1f}s ({smi})")


def phase_lm_mesh(dev, smi: str) -> dict:
    """LM training and serving over (data, model) meshes of gloo ranks
    sharing the card: qwen1.5-4b served at 1x2 and 1x4 and trained at 2x2,
    an elastic checkpoint 2x2 -> 1x2, f32 holds against one rank (at 1x3
    with its heads and vocabulary whole on every rank); returns the K1-K7
    launches summed over every rank (zero: the path reaches no kernel, as
    in the reference)."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    print(f"[lm_mesh] at the start: host load average "
          f"{[round(v, 2) for v in os.getloadavg()]} on {os.cpu_count()} "
          f"cores, {len(threading.enumerate())} threads and "
          f"{len(multiprocessing.active_children())} child processes in "
          f"this process, {torch.cuda.memory_reserved() / 1e9:.2f} GB "
          f"reserved on the card by it")
    bad, total = [], dict.fromkeys(ops.KERNELS, 0)
    tmp = tempfile.mkdtemp(prefix="lm_mesh_")
    try:
        for world in (4, 3, 2):
            t0 = time.perf_counter()
            label = _mesh_label(world, "gloo")
            ranks = spawn_ranks(_lm_mesh_rank, world, (world, tmp),
                                device_type="cuda", backend="gloo",
                                timeout=LM_MESH_TIMEOUT_S)
            for r in ranks:
                _add(total, r["launches"])
            _lm_mesh_report(world, ranks, smi, bad, label)
            if world == 2:
                el = ranks[0]["elastic"]
                same = el["digests"] == saved
                ok = same and el["shapes_ok"]
                print(f"[lm_mesh] elastic restore of the 2x2 state at 1x2: "
                      f"every leaf bit for bit the saved one {same}, each "
                      f"rank's leaves its resolve_pspec block "
                      f"{el['shapes_ok']}; restore {el['restore_s']:.2f} s "
                      f"({smi}){'' if ok else '  FAILED'}")
                if not ok:
                    bad.append("elastic restore")
                same = (ranks[0]["serve"]["outputs"]
                        == outputs_1x4)
                print(f"[lm_mesh] greedy tokens at 1x2 equal those at 1x4: "
                      f"{same} (bf16 matmuls; printed, not held)")
            elif world == 4:
                saved = ranks[0]["elastic"]["digests"]
                outputs_1x4 = ranks[0]["serve"]["outputs"]
            print(f"[lm_mesh] {world} ranks: "
                  f"{time.perf_counter() - t0:.1f}s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    _lm_mesh_nccl(smi)
    print(f"[lm_mesh] K1-K7 launches summed over every rank of the phase: "
          f"{total} (the reference's sharded LM path reaches no Pallas "
          f"kernel either); phase {time.perf_counter() - t_phase:.1f}s")
    if any(total.values()):
        bad.append(f"launches {total}")
    if bad:
        raise AssertionError("lm_mesh holds failed: " + "; ".join(bad))
    return total


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", metavar="FILE", default=None,
                    help="write torch.profiler tables of the serving path "
                         "(FILE), a training chunk (FILE.train), RGB and "
                         "segmentation serving (FILE.rgb, FILE.seg), an "
                         "emulate_batch call of 8 candidates (FILE.design), "
                         "a qwen1.5-4b decode step at 8 slots (FILE.lm) and "
                         "one LM training step of qwen1.5-4b, "
                         "falcon-mamba-7b, mixtral-8x7b and "
                         "recurrentgemma-9b (FILE.lmtrain, "
                         "FILE.lmtrain_ssm, FILE.lmtrain_moe, "
                         "FILE.lmtrain_hybrid)")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    phase_facts(dev)
    rows = phase_kernels(dev)
    physics = phase_physics(dev)
    phase_backward(dev)
    launches = phase_slice(dev, smi, args.profile)
    train = phase_train(dev, smi, args.profile)
    phase_cli()
    families = phase_families(dev, smi, args.profile)
    design = phase_design(dev, smi, args.profile)
    lm_windows = phase_lm(dev, smi, args.profile)
    lm_training, qwen_run = phase_lm_train(dev, smi, args.profile)
    dryrun_launches = phase_dryrun(dev, smi, qwen_run)
    lm_families = phase_lm_families(dev, smi, args.profile)
    persistence = phase_persistence(dev, smi)
    mesh = phase_mesh(dev, smi)
    lm_meshes = phase_lm_mesh(dev, smi)
    kernels = []
    for name in ops.KERNELS:
        r = rows[name]
        source, replaces = KERNEL_META[name]
        lm_launches = {w: c[name] for w, c in lm_windows.items()}
        row = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            # the main path: the physics phase's plan, DONN serving and
            # training, the advanced families, the design flow, LM
            # serving, persistence and the fleet, the mesh's ranks, LM
            # training, the dry-run, the LM families and the LM mesh's
            # ranks (none); the LM holds
            # (K6 on q/k, K7 on the mixer tensors) apart
            "launches": (physics[name] + launches[name]
                         + train["counted"][name]
                         + sum(f[name] for f in families.values())
                         + sum(d[name] for d in design.values())
                         + sum(v for w, v in lm_launches.items()
                               if w.startswith("lm_serve"))
                         + persistence[name] + mesh[name]
                         + lm_training[name] + dryrun_launches[name]
                         + lm_families[name]
                         + lm_meshes[name]),
            "hold_launches": sum(v for w, v in lm_launches.items()
                                 if w.startswith("lm_hold")),
            "physics_launches": physics[name],
            "serve_launches": launches[name],
            "train_launches": {eng: c[name]
                               for eng, c in train["per_step"].items()},
            "family_launches": {f: c[name] for f, c in families.items()},
            "design_launches": {d: c[name] for d, c in design.items()},
            "lm_launches": lm_launches,
            "persistence_launches": persistence[name],
            "mesh_launches": mesh[name],
            "lm_train_launches": lm_training[name],
            "dryrun_launches": dryrun_launches[name],
            "lm_families_launches": lm_families[name],
            "lm_mesh_launches": lm_meshes[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        }
        if "sfu_bound_ms" in r:
            row["sfu_bound_ms"] = r["sfu_bound_ms"]
        kernels.append(row)
    print(f"[done] {time.perf_counter() - t0:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
