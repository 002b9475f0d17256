"""The port's vlm family (llama-3.2-vision-11b) against the JAX package.

Parameters come from the JAX package (``repro.models.lm.init``, numpy on
the way over) through ``repro_torch.convert.lm_params_from_jax``; inputs
(tokens and float32 vision states) from seeded numpy generators; both
sides in float32 on the CPU unless a test says bf16.  The reference's
results of the smoke config (4 layers: two periods of one self block and
one gated cross block) are computed once (``_torch_lm_family.Reference``,
a module-scoped fixture) with every cross gate set away from its zero
init, so the cross blocks reach the outputs and gradients.

Tolerances (max|port - jax| / max|jax| of each leaf), measured with the
CPU builds of torch 2.13 and jax 0.9:
- ``cross_attention`` within 2.0e-7 in f32, held at 1e-5; in bf16 with
  f32 vision states (the launcher's mix: the K/V projections compute in
  f32 there) equal to the bit, held at 1e-3 (K/V computed in bf16 would
  be 6.6e-3 off).
- logits within 9.8e-7, ``lm_loss`` and every gradient within 5.8e-6; 18
  decode steps and the final cache (``xk``/``xv`` filled from the vision
  states, the reference test's recipe) within 1.3e-6 of the reference's
  and of the port's prefill (the reference's own bound there is 1e-4):
  held at 1e-5.
- three ``make_train_step`` steps at accum 1 and 2 (the vision states
  split with the batch): params within 8.4e-7 (losses and grad norms
  held at 1e-5 too).
- bf16 (the configs' own dtype) with f32 vision states: loss within
  1.4e-4, gradients within 7.8e-2 of their max; held at the dense
  families' 1e-2 and 0.15.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_cores import share_cores  # noqa: E402

share_cores(torch)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_lm_family as fam  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402

ARCH = "llama-3.2-vision-11b"
# the mixed-dtype cross-attention: measured equal to the bit; computing
# the K/V projections in bf16 instead (torch's way out of the mixed
# matmul) gives 6.6e-3, so the bound sits below that
BF16_XATTN_RTOL = 1e-3


def _open_gates(params):
    """Every cross gate away from its zero init (tanh(0) = 0 would cut
    the cross blocks off the outputs and their weights' gradients)."""
    cross = dict(params["cross_blocks"])
    n = cross["gate_ffn"].shape[0]
    cross["gate_ffn"] = jnp.linspace(0.4, 0.7, n)[:, None]
    cross["xattn"] = dict(cross["xattn"], gate=jnp.linspace(-0.6, 0.5,
                                                            n)[:, None])
    return dict(params, cross_blocks=cross)


@pytest.fixture(scope="module")
def ref():
    return fam.Reference(ARCH, prepare=_open_gates)


def _xattn_params(dtype):
    jc, tc = fam.cfgs(ARCH, dtype=dtype)
    spec = jattn.attention_spec(jc, cross=True)
    r = np.random.default_rng(5)
    p = {k: (0.2 * r.standard_normal(s.shape)).astype(np.float32)
         for k, s in spec.items()}
    x = r.standard_normal((2, 9, jc.d_model)).astype(np.float32)
    vis = r.standard_normal((2, jc.vision_seq, jc.d_model)).astype(
        np.float32)
    return jc, tc, p, x, vis


# ------------------------------------------------------------ the block
def test_cross_attention_matches_jax():
    jc, tc, p, x, vis = _xattn_params("float32")
    want = jattn.cross_attention({k: jnp.asarray(v) for k, v in p.items()},
                                 jnp.asarray(x), jnp.asarray(vis), jc)
    got = tattn.cross_attention({k: torch.from_numpy(v) for k, v in
                                 p.items()}, torch.from_numpy(x),
                                torch.from_numpy(vis), tc)
    assert fam.rel(got, want) <= fam.RTOL


def test_cross_attention_mixes_f32_vision_into_bf16_like_jax():
    """bf16 queries over f32 vision states: JAX promotes ``f32 @ bf16``
    to f32, and the port computes K/V in the promoted type too (torch
    would refuse the mixed matmul); the output is bf16."""
    jc, tc, p, x, vis = _xattn_params("bfloat16")
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = jattn.cross_attention({k: jnp.asarray(v) for k, v in p.items()},
                                 xb, jnp.asarray(vis), jc)
    got = tattn.cross_attention(
        {k: torch.from_numpy(v) for k, v in p.items()},
        torch.from_numpy(np.asarray(xb.astype(jnp.float32))).to(
            torch.bfloat16), torch.from_numpy(vis), tc)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    gap = fam.rel(got, np.asarray(want.astype(jnp.float32)))
    print(f"cross_attention bf16 with f32 vision: rel {gap:.3e}")
    assert gap <= BF16_XATTN_RTOL


# ------------------------------------------------------------ the model
def test_vlm_layout_and_refusals(ref):
    """Two periods of one self block and one cross block; the self stack
    two axes deep; the cache's vision K/V one a period; no forward
    without vision states."""
    assert tlm._vlm_counts(ref.tc) == (2, 1)
    assert tlm.stack_depths(ref.tp) == {"blocks": 2, "cross_blocks": 1}
    assert ref.tp["blocks"]["attn"]["wq"].shape[:2] == (2, 1)
    cache = tlm.init_cache(ref.tc, 3, 10)
    assert cache["k"].shape[:3] == (2, 3, 10)
    assert cache["xk"].shape == cache["xv"].shape == (
        2, 3, ref.tc.vision_seq, ref.tc.n_kv_heads, ref.tc.head_dim)
    with pytest.raises(ValueError, match="vision"):
        tlm.forward(ref.tp, ref.tb["tokens"], ref.tc)


def test_logits_match_jax(ref):
    fam.check_logits(ref)


def test_lm_loss_and_grads_match_jax(ref):
    fam.check_loss_and_grads(ref)


def test_train_step_grads_split_every_stacked_group(ref):
    fam.check_split_grads(ref)


def test_decode_matches_prefill_and_jax(ref):
    fam.check_decode(ref)


@pytest.mark.parametrize("accum", fam.ACCUMS)
def test_three_train_steps_match_jax(ref, accum):
    fam.check_train_steps(ref, accum)


def test_bf16_loss_and_grads_stay_near_jax(ref):
    """The configs' own dtype, the vision states f32 as the launcher
    feeds them."""
    assert ref.tb["vision"].dtype == torch.float32
    fam.check_bf16(ref)
