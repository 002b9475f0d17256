"""The port's hybrid family (recurrentgemma-9b) against the JAX package.

Parameters come from the JAX package (``repro.models.lm.init``, numpy on
the way over) through ``repro_torch.convert.lm_params_from_jax``; inputs
from seeded numpy generators; both sides in float32 on the CPU unless a
test says bf16.  The reference's results of the smoke config (5 layers:
one (rec, rec, attn) period and two tail rec layers, window 16, MQA with
one KV head, geglu, logit softcap 30) are computed once
(``_torch_lm_family.Reference``, a module-scoped fixture).

Tolerances (max|port - jax| / max|jax| of each leaf), measured with the
CPU builds of torch 2.13 and jax 0.9:
- ``apply_rglru_block`` with and without carried states: outputs and
  states within 2.4e-7; ``_lru_scan`` within 1.9e-7 of the reference's;
  ``_blockdiag`` equal; the port's chunked scan equals its step loop bit
  for bit, values and gradients; held at 1e-5.
- logits within 2.9e-6, ``lm_loss`` and every gradient within 3.9e-6; 18
  decode steps and the final cache within 2.0e-6 of the reference's and
  of the port's prefill (the reference's own bound there is 1e-4); 40
  steps through the rolling window within 2.5e-6; softcapped logits
  within 3.8e-6: all held at 1e-5.
- three ``make_train_step`` steps at accum 1 and 2: params within 1.1e-6
  (losses and grad norms held at 1e-5 too), the zero-initialised leaves
  (``conv_b``, ``b_a``, ``b_x``) within 4.0e-5, held at 1e-2
  (``test_torch_lm_train.py`` says why).
- bf16 (the configs' own dtype): loss within 2.0e-4, gradients within
  6.5e-2 of their max; held at the dense
  families' 1e-2 and 0.15.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _torch_cores import share_cores  # noqa: E402

share_cores(torch)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_lm_family as fam  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import rglru as jrg  # noqa: E402
from repro.nn import init_params as jinit_params  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import rglru as trg  # noqa: E402
from repro_torch.nn import init_params  # noqa: E402

ARCH = "recurrentgemma-9b"


@pytest.fixture(scope="module")
def ref():
    return fam.Reference(ARCH)


def _rec_params(seed=0):
    """(jax cfg, port cfg, jax, port) parameters of one RG-LRU block."""
    jc, tc = fam.cfgs(ARCH)
    jp = jinit_params(jrg.rglru_spec(jc), jax.random.PRNGKey(seed))
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jc, tc, jp, tp


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ the block
def test_rglru_lambda_draw_and_specs():
    """``rglru_lambda``: a = sigmoid(lam) uniform inside (0.9, 0.999), as
    the reference draws it; the block's specs equal the reference's."""
    _, tc = fam.cfgs(ARCH)
    p = init_params(trg.rglru_spec(tc), torch.Generator().manual_seed(0))
    a = torch.sigmoid(p["lam"])
    assert p["lam"].dtype == torch.float32
    assert float(a.min()) > 0.9 and float(a.max()) < 0.999
    assert abs(float(a.mean()) - 0.9495) < 0.01  # uniform's mean
    jc, _ = fam.cfgs(ARCH)
    for k, s in trg.rglru_spec(tc).items():
        js = jrg.rglru_spec(jc)[k]
        assert (tuple(s.shape), tuple(s.logical_axes), s.init, s.scale) == (
            tuple(js.shape), tuple(js.logical_axes), js.init, js.scale), k


def test_blockdiag_matches_jax():
    jc, tc, jp, tp = _rec_params()
    x = np.random.default_rng(0).standard_normal(
        (2, 7, jc.lru_width)).astype(np.float32)
    want = jrg._blockdiag(jnp.asarray(x), jp["w_a"], jp["b_a"], jc.n_heads)
    got = trg._blockdiag(_t(x), tp["w_a"], tp["b_a"], tc.n_heads)
    assert fam.rel(got, want) <= fam.RTOL


def _plain_lru(a, g, h):
    ys = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + g[:, t]
        ys.append(h)
    return torch.stack(ys, 1), h


@pytest.mark.parametrize("S,chunk", [(13, 4), (16, 8), (5, 8)])
def test_lru_scan_chunked_equals_stepwise_and_jax(S, chunk):
    """The chunked scan (padded with a = 1, chunk-checkpointed under
    autograd) against the plain step loop, bit for bit with gradients,
    and against the reference's ``_lru_scan``."""
    r = np.random.default_rng(S)
    a = r.uniform(0.5, 1.0, (2, S, 6)).astype(np.float32)
    g = r.standard_normal((2, S, 6)).astype(np.float32)
    h0 = r.standard_normal((2, 6)).astype(np.float32)
    wy, wh = jrg._lru_scan(jnp.asarray(a), jnp.asarray(g), jnp.asarray(h0),
                           chunk)
    ins = [_t(v).requires_grad_(True) for v in (a, g, h0)]
    y, h = trg._lru_scan(*ins, chunk)
    assert fam.rel(y, wy) <= fam.RTOL and fam.rel(h, wh) <= fam.RTOL
    y0, h0_ = _plain_lru(*ins)
    assert torch.equal(y, y0) and torch.equal(h, h0_)
    w = torch.randn(y.shape, generator=torch.Generator().manual_seed(1))
    got = torch.autograd.grad((y * w).sum() + h.sum(), ins)
    want = torch.autograd.grad((y0 * w).sum() + h0_.sum(), ins)
    assert all(torch.equal(u, v) for u, v in zip(got, want))


def test_apply_rglru_block_with_and_without_states_matches_jax():
    """Prefill of 11 tokens from zero states, then 3 single-token steps
    carrying (conv, lru) states: outputs and states against the
    reference's; and the steps against the prefill of all 14 tokens."""
    jc, tc, jp, tp = _rec_params(seed=1)
    x = np.random.default_rng(3).standard_normal(
        (2, 14, jc.d_model)).astype(np.float32)
    want, (wc, wh) = jrg.apply_rglru_block(jp, jnp.asarray(x[:, :11]), jc)
    got, (gc, gh) = trg.apply_rglru_block(tp, _t(x[:, :11]), tc)
    assert fam.rel(got, want) <= fam.RTOL
    assert fam.rel(gc, wc) <= fam.RTOL and fam.rel(gh, wh) <= fam.RTOL
    outs = [got]
    for t in range(11, 14):
        want, (wc, wh) = jrg.apply_rglru_block(
            jp, jnp.asarray(x[:, t:t + 1]), jc, conv_state=wc, lru_state=wh)
        got, (gc, gh) = trg.apply_rglru_block(
            tp, _t(x[:, t:t + 1]), tc, conv_state=gc, lru_state=gh)
        assert fam.rel(got, want) <= fam.RTOL, t
        assert fam.rel(gc, wc) <= fam.RTOL and fam.rel(gh, wh) <= fam.RTOL
        outs.append(got)
    full, _ = trg.apply_rglru_block(tp, _t(x), tc)
    assert fam.rel(torch.cat(outs, 1), full.numpy()) <= fam.RTOL


# ------------------------------------------------------------ the model
def test_hybrid_layout_and_counts(ref):
    """One (rec, rec, attn) period and two tail rec layers; the features
    this family brings (MQA with one KV head, geglu, softcap 30) are the
    smoke config's, so the model tests below reach them."""
    tc = ref.tc
    assert tlm._hybrid_counts(tc) == (1, 2, 2)
    assert sorted(ref.tp) == ["attn_blocks", "embed", "final_norm",
                              "rec_blocks", "tail_rec"]
    assert tlm.stack_depths(ref.tp) == {"rec_blocks": 2, "attn_blocks": 1,
                                        "tail_rec": 1}
    assert (tc.n_kv_heads, tc.mlp, tc.logit_softcap) == (1, "geglu", 30.0)
    with pytest.raises(ValueError, match="block_pattern"):
        tlm.param_specs(dataclasses.replace(tc, block_pattern=("rec",
                                                               "rec")))


def test_logits_match_jax(ref):
    fam.check_logits(ref)


def test_softcapped_logits_match_jax(ref):
    """The unembedding scaled up 10-fold: raw logits reach past half the
    cap, where 30 tanh(z / 30) bends them by over a tenth.  (The capped
    logits are held against their own max: past the cap the comparison
    grows ill-conditioned, the raw logits' rounding measured against a
    max that the cap holds at 30.)"""
    np_params = dict(ref.np_params)
    np_params["embed"] = dict(np_params["embed"])
    np_params["embed"]["unembed"] = 10 * np_params["embed"]["unembed"]
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = lm_params_from_jax(np_params, device="cpu")
    want = np.asarray(jlm.logits_fn(jp, ref.jb["tokens"], ref.jc))
    got = tlm.logits_fn(tp, ref.tb["tokens"], ref.tc)
    assert fam.rel(got, want) <= fam.RTOL
    raw = np.asarray(jlm.forward(jp, ref.jb["tokens"], ref.jc)[0]) @ (
        np_params["embed"]["unembed"])
    print(f"raw logits up to {np.abs(raw).max():.1f}, capped "
          f"{float(got.abs().max()):.2f}")
    top = float(np.abs(raw).max())
    assert top > 15.0 and float(got.abs().max()) < 0.9 * top


def test_lm_loss_and_grads_match_jax(ref):
    fam.check_loss_and_grads(ref)


def test_train_step_grads_split_every_stacked_group(ref):
    fam.check_split_grads(ref)


def test_decode_matches_prefill_and_jax(ref):
    fam.check_decode(ref)


def test_rolling_window_decode_matches_prefill(ref):
    """40 decode steps (more than twice the window of 16) through the
    rolling KV cache and the rec states, against the prefill on both
    sides (the reference's test_hybrid_rolling_window)."""
    toks = np.random.default_rng(3).integers(0, ref.jc.vocab, (2, 40))
    want = np.asarray(jlm.logits_fn(ref.jp, jnp.asarray(toks, jnp.int32),
                                    ref.jc))
    cache = tlm.init_cache(ref.tc, 2, 64)
    assert cache["k"].shape[2] == ref.tc.window == 16
    assert cache["rec_conv"].shape[:2] == cache["rec_h"].shape[:2] == (1, 2)
    assert cache["tail_conv"].shape[0] == cache["tail_h"].shape[0] == 2
    outs = [tlm.decode_step(ref.tp, cache, torch.from_numpy(toks[:, t:t + 1]),
                            t, ref.tc)[0][:, 0] for t in range(40)]
    assert fam.rel(torch.stack(outs, 1), want) <= fam.RTOL


@pytest.mark.parametrize("accum", fam.ACCUMS)
def test_three_train_steps_match_jax(ref, accum):
    fam.check_train_steps(ref, accum)


def test_bf16_loss_and_grads_stay_near_jax(ref):
    fam.check_bf16(ref)
