"""The port's LM serving slice (dense, ssm and audio) against the JAX package.

Parameters come from the JAX package (``repro.models.lm.init``, numpy on
the way over) through ``repro_torch.convert.lm_params_from_jax``; inputs
from a seeded numpy generator.  Both sides run in float32 (``dtype``
replaced in the smoke configs) on the CPU.

Tolerance: max|port - jax| <= 1e-5 * max|jax| (f32).  Measured with the
CPU builds of torch 2.13 and jax 0.9: logits of the qwen1.5-4b, granite-8b
and glm4-9b smoke configs within 1.1e-6, falcon-mamba-7b within 2.2e-6;
the layers within 3e-7.  The bf16 case (the configs' own dtype) is held at
2e-2 of the max logit: the two frameworks round the bf16 matmuls and
elementwise ops at other places (measured 7.5e-3 to 8.7e-3 on qwen1.5-4b
smoke over three token draws).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _torch_cores import share_cores  # noqa: E402

share_cores(torch)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro.models import config as jconfig  # noqa: E402
from repro.models import get_config as jget  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.nn import param_count as jparam_count  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import config as tconfig  # noqa: E402
from repro_torch.models import get_config as tget  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.nn import (  # noqa: E402
    ParamSpec, cast_tree, init_params, param_count,
)
from repro_torch.runtime import steps as tsteps  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

RTOL = 1e-5
PORTED = ("qwen1.5-4b", "granite-8b", "glm4-9b", "qwen2.5-14b",
          "falcon-mamba-7b", "mixtral-8x7b", "arctic-480b",
          "llama-3.2-vision-11b", "musicgen-medium", "recurrentgemma-9b")


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _cfgs(arch, dtype="float32", **kw):
    """(jax cfg, port cfg) of an arch's smoke config in ``dtype``."""
    jc = dataclasses.replace(jget(arch, smoke=True),
                             dtype=getattr(jnp, dtype), **kw)
    tc = dataclasses.replace(tget(arch, smoke=True),
                             dtype=getattr(torch, dtype), **kw)
    return jc, tc


def _params(jc, seed=0):
    jp = jlm.init(jc, jax.random.PRNGKey(seed))
    return jp, lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_layer(tree, i=0):
    return jax.tree.map(lambda a: a[i], tree)


def _torch_layer(tree, i=0):
    return tlm._layer(tree, i)


# ------------------------------------------------------------ configs
def test_lmconfig_fields_match_the_reference():
    jf = dataclasses.fields(jconfig.LMConfig)
    tf = dataclasses.fields(tconfig.LMConfig)
    assert [f.name for f in tf] == [f.name for f in jf]
    for a, b in zip(tf, jf):
        if a.name == "dtype":
            assert a.default is torch.bfloat16 and b.default is jnp.bfloat16
        else:
            assert a.default == b.default, a.name
    assert tconfig.LM_SHAPES == tuple(
        tconfig.ShapeCell(**dataclasses.asdict(c)) for c in jconfig.LM_SHAPES)
    assert (tconfig.DENSE, tconfig.MOE, tconfig.VLM, tconfig.AUDIO,
            tconfig.SSM, tconfig.HYBRID) == (
        jconfig.DENSE, jconfig.MOE, jconfig.VLM, jconfig.AUDIO, jconfig.SSM,
        jconfig.HYBRID)


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", PORTED)
def test_registered_configs_match_the_reference(arch, smoke):
    j, t = jget(arch, smoke=smoke), tget(arch, smoke=smoke)
    for f in dataclasses.fields(j):
        if f.name != "dtype":
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert (t.head_dim, t.attention_free, t.sub_quadratic) == (
        j.head_dim, j.attention_free, j.sub_quadratic)


def test_registry_names_ported_and_pending_archs():
    """All ten of the reference's LM architectures build, full and smoke
    (their fields: test_registered_configs_match_the_reference); an
    unknown arch raises KeyError, an unknown family ValueError."""
    from repro.configs import LM_ARCHS

    assert tconfig.list_archs() == sorted(PORTED) == sorted(LM_ARCHS)
    for arch in PORTED:
        for smoke in (False, True):
            assert tlm.param_specs(tget(arch, smoke=smoke))
    with pytest.raises(KeyError, match="unknown arch"):
        tget("no-such-arch")
    odd = dataclasses.replace(tget("granite-8b", smoke=True), family="odd")
    tp = tlm.init(tget("granite-8b", smoke=True), torch.Generator())
    toks = torch.zeros((1, 2), dtype=torch.long)
    for fn in (tlm.param_specs, lambda c: tlm.cache_specs(c, 1, 4),
               lambda c: tlm.forward(tp, toks, c),
               lambda c: tlm.decode_step(tp, {}, toks[:, :1], 0, c)):
        with pytest.raises(ValueError, match="unknown family odd"):
            fn(odd)


# ------------------------------------------------------------ param specs
def _spec_rows(tree, is_jax):
    leaves = (jax.tree.leaves(tree, is_leaf=lambda x: hasattr(x, "init"))
              if is_jax else tree_leaves(tree))
    return [(tuple(s.shape), tuple(s.logical_axes), s.init, s.scale)
            for s in leaves]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", PORTED)
def test_param_specs_match_the_reference(arch, smoke):
    """Shapes, axes and initializers of every leaf, in tree order, without
    allocating the full-width parameters."""
    j, t = jget(arch, smoke=smoke), tget(arch, smoke=smoke)
    jspec, tspec = jlm.param_specs(j), tlm.param_specs(t)
    assert _spec_rows(tspec, False) == _spec_rows(jspec, True)
    assert param_count(tspec) == jparam_count(jspec)
    for B, L in ((2, 24), (3, 7)):
        assert _spec_rows(tlm.cache_specs(t, B, L), False) == _spec_rows(
            jlm.cache_specs(j, B, L), True)


def test_init_params_follows_the_specs():
    _, tc = _cfgs("falcon-mamba-7b")
    p = tlm.init(tc, torch.Generator().manual_seed(0))
    jp = jlm.init(jget("falcon-mamba-7b", smoke=True), jax.random.PRNGKey(0))
    assert [tuple(a.shape) for a in jax.tree.leaves(jp)] == [
        tuple(x.shape) for x in tree_leaves(p)]
    m = p["blocks"]["mamba"]
    np.testing.assert_array_equal(m["A_log"].numpy(),
                                  np.asarray(jp["blocks"]["mamba"]["A_log"]))
    assert torch.all(m["D"] == 1) and torch.all(m["conv_b"] == 0)
    w = m["in_proj"]  # fan_in: std 1/sqrt(d_model)
    assert abs(float(w.std()) * np.sqrt(tc.d_model) - 1.0) < 0.05
    again = tlm.init(tc, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p),
                                                  tree_leaves(again)))
    assert all(x.dtype == torch.float32 for x in tree_leaves(p))
    half = cast_tree(p, torch.bfloat16)
    assert all(x.dtype == torch.bfloat16 for x in tree_leaves(half))
    lam = init_params({"p": ParamSpec((500,), init="rglru_lambda")},
                      torch.Generator().manual_seed(0))["p"]
    a = torch.sigmoid(lam)  # uniform in [0.9, 0.999], as the reference
    assert float(a.min()) > 0.9 and float(a.max()) < 0.999
    with pytest.raises(ValueError, match="unknown init"):
        init_params({"p": ParamSpec((5,), init="no-such-init")},
                    torch.Generator())


# ------------------------------------------------------------ layers
@pytest.mark.parametrize("norm", ["rms", "ln"])
def test_apply_norm_matches_jax(norm):
    jc, tc = _cfgs("qwen1.5-4b", norm=norm)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, jc.d_model)).astype(np.float32) * 3
    scale = rng.standard_normal(jc.d_model).astype(np.float32)
    want = jlayers.apply_norm({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                              jc)
    got = tlayers.apply_norm({"scale": _t(scale)}, _t(x), tc)
    assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "gelu"])
def test_apply_mlp_matches_jax(mlp):
    jc, tc = _cfgs("qwen1.5-4b", mlp=mlp)
    rng = np.random.default_rng(1)
    spec = jlayers.mlp_spec(jc)
    p = {k: rng.standard_normal(s.shape).astype(np.float32) * 0.2
         for k, s in spec.items()}
    x = rng.standard_normal((2, 5, jc.d_model)).astype(np.float32)
    want = jlayers.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x), jc)
    got = tlayers.apply_mlp({k: _t(v) for k, v in p.items()}, _t(x), tc)
    assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("tie,softcap", [(False, 0.0), (True, 0.0),
                                         (False, 3.0)])
def test_embed_and_unembed_match_jax(tie, softcap):
    jc, tc = _cfgs("granite-8b", tie_embeddings=tie, logit_softcap=softcap)
    rng = np.random.default_rng(2)
    p = {k: rng.standard_normal(s.shape).astype(np.float32)
         for k, s in jlayers.embed_spec(jc).items()}
    toks = rng.integers(0, jc.vocab, (2, 7))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    x_j = jlayers.embed_tokens(jp, jnp.asarray(toks), jc)
    x_t = tlayers.embed_tokens(tp, _t(toks), tc)
    assert _rel(x_t, x_j) == 0.0
    got, want = tlayers.unembed(tp, x_t, tc), jlayers.unembed(jp, x_j, jc)
    assert _rel(got, want) <= RTOL
    if softcap:
        assert float(got.abs().max()) <= softcap


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "glm4-9b"])
def test_rope_angles_match_jax(arch):
    jc, tc = _cfgs(arch)
    pos = np.array([0, 1, 7, 100, 4095])
    for got, want in zip(tlayers.rope_angles(tc, _t(pos)),
                         jlayers.rope_angles(jc, jnp.asarray(pos))):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=2e-6)


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("arch,batched_angles", [
    ("qwen1.5-4b", False), ("glm4-9b", False), ("glm4-9b", True)])
def test_apply_rotary_matches_jax(arch, batched_angles, use_pallas):
    """Both flags, partial rotary (glm4: half the head dim rotates), cos/sin
    per position or per (batch, position); under use_pallas the port runs
    K6's wrapper (its plain version here) and JAX the Pallas kernel in
    interpret mode."""
    jc, tc = _cfgs(arch)
    rng = np.random.default_rng(3)
    S = 13  # not a multiple of the reference kernel's 8-row block
    x = rng.standard_normal((2, S, jc.n_heads, jc.head_dim)).astype(
        np.float32)
    pos = np.arange(S)[None].repeat(2, 0) if batched_angles else np.arange(S)
    cos, sin = jlayers.rope_angles(jc, jnp.asarray(pos))
    want = jlayers.apply_rotary(jnp.asarray(x), cos, sin, jc,
                                use_pallas=use_pallas)
    kops.reset_launch_counts()
    got = tlayers.apply_rotary(_t(x), _t(cos), _t(sin), tc,
                               use_pallas=use_pallas)
    assert kops.launch_counts()["rope"] == 0  # plain version on the CPU
    assert _rel(got, want) <= RTOL


def test_apply_rotary_kernel_flag_agrees_in_bf16():
    """bf16 (the configs' dtype): the plain version under use_pallas and
    the stepwise rotation agree with JAX's bf16 rotation to the bit."""
    jc, tc = _cfgs("qwen1.5-4b", dtype="bfloat16")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, jc.n_heads, jc.head_dim)).astype(
        np.float32)
    cos, sin = jlayers.rope_angles(jc, jnp.arange(9))
    xj = jnp.asarray(x, jnp.bfloat16)
    xt = _t(x).to(torch.bfloat16)
    for flag in (False, True):
        want = jlayers.apply_rotary(xj, cos, sin, jc, use_pallas=flag)
        got = tlayers.apply_rotary(xt, _t(cos), _t(sin), tc, use_pallas=flag)
        assert got.dtype == torch.bfloat16
        assert _rel(got, np.asarray(want.astype(jnp.float32))) == 0.0


# ------------------------------------------------------------ attention
ATTN_CASES = {  # Skv, Sq, KV heads, keyword arguments
    "causal": (16, 16, 4, dict(causal=True, chunk=8)),
    "window": (16, 16, 2, dict(causal=True, window=5, chunk=8)),
    "kv_len": (16, 1, 2, dict(causal=False, kv_len=11, chunk=8)),
    "kv padding": (13, 13, 2, dict(causal=True, chunk=8)),
    "q offset": (12, 4, 4, dict(causal=True, q_offset=8, chunk=4)),
    "p_bf16": (16, 16, 2, dict(causal=True, chunk=8, p_bf16=True)),
    "non-causal": (10, 6, 1, dict(causal=False, chunk=4)),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_chunked_attention_matches_jax(case):
    Skv, Sq, KV, kw = ATTN_CASES[case]
    rng = np.random.default_rng(5)
    H, Dh = 4, 8
    q = rng.standard_normal((2, Sq, H, Dh)).astype(np.float32)
    k = rng.standard_normal((2, Skv, KV, Dh)).astype(np.float32)
    v = rng.standard_normal((2, Skv, KV, Dh)).astype(np.float32)
    jkw = dict(kw)
    if "kv_len" in jkw:
        jkw["kv_len"] = jnp.asarray(jkw["kv_len"])
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), **jkw)
    got = tattn.chunked_attention(_t(q), _t(k), _t(v), **kw)
    assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("arch,window", [("qwen1.5-4b", 0),
                                         ("granite-8b", 0),
                                         ("granite-8b", 6)])
def test_self_attention_matches_jax(arch, window):
    jc, tc = _cfgs(arch, window=window)
    jp, tp = _params(jc)
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 11, jc.d_model)).astype(np.float32)
    pa_j = _jax_layer(jp["blocks"])["attn"]
    pa_t = _torch_layer(tp["blocks"])["attn"]
    want = jattn.self_attention(pa_j, jnp.asarray(x), jc)
    got = tattn.self_attention(pa_t, _t(x), tc)
    assert _rel(got, want) <= RTOL


@pytest.mark.parametrize("cache_len,window", [(12, 0), (5, 5)])
def test_decode_self_attention_matches_jax(cache_len, window):
    """Step by step against the reference, the cache included: a plain
    cache and a rolling window buffer that wraps twice."""
    jc, tc = _cfgs("granite-8b", window=window)
    jp, tp = _params(jc)
    pa_j = _jax_layer(jp["blocks"])["attn"]
    pa_t = _torch_layer(tp["blocks"])["attn"]
    KV, Dh = jc.n_kv_heads, jc.head_dim
    ck_j = jnp.zeros((2, cache_len, KV, Dh))
    cv_j = jnp.zeros((2, cache_len, KV, Dh))
    ck_t = torch.zeros((2, cache_len, KV, Dh))
    cv_t = torch.zeros((2, cache_len, KV, Dh))
    rng = np.random.default_rng(7)
    for pos in range(12):
        x = rng.standard_normal((2, 1, jc.d_model)).astype(np.float32)
        want, ck_j, cv_j = jattn.decode_self_attention(
            pa_j, jnp.asarray(x), ck_j, cv_j, jnp.int32(pos), jc)
        got, ck_t, cv_t = tattn.decode_self_attention(
            pa_t, _t(x), ck_t, cv_t, pos, tc)
        assert _rel(got, want) <= RTOL, pos
        assert _rel(ck_t, ck_j) <= RTOL and _rel(cv_t, cv_j) <= RTOL


# ------------------------------------------------------------ ssm
def test_causal_conv_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    state = rng.standard_normal((2, 3, 12)).astype(np.float32)
    for st in (None, state):
        wy, ws = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(b),
                                   None if st is None else jnp.asarray(st))
        ty, ts = tssm._causal_conv(_t(x), _t(w), _t(b),
                                   None if st is None else _t(st))
        assert _rel(ty, wy) <= RTOL and _rel(ts, ws) == 0.0


def test_selective_scan_matches_jax():
    """S = 13 is not a multiple of the chunk (8): the padded steps keep h."""
    rng = np.random.default_rng(9)
    B, S, D, N = 2, 13, 10, 4
    dt = np.log1p(np.exp(rng.standard_normal((B, S, D)))).astype(np.float32)
    xc = rng.standard_normal((B, S, D)).astype(np.float32)
    bs = rng.standard_normal((B, S, N)).astype(np.float32)
    cs = rng.standard_normal((B, S, N)).astype(np.float32)
    A = -np.exp(rng.standard_normal((D, N))).astype(np.float32)
    h0 = rng.standard_normal((B, D, N)).astype(np.float32)
    args = (dt, bs, cs, xc, A, h0)
    wy, wh = jssm._selective_scan(*(jnp.asarray(a) for a in args), chunk=8)
    ty, th = tssm._selective_scan(*(_t(a) for a in args), chunk=8)
    assert _rel(ty, wy) <= RTOL and _rel(th, wh) <= RTOL


def test_apply_mamba_prefill_and_decode_states_match_jax():
    jc, tc = _cfgs("falcon-mamba-7b")
    jp, tp = _params(jc)
    pm_j = _jax_layer(jp["blocks"])["mamba"]
    pm_t = _torch_layer(tp["blocks"])["mamba"]
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 11, jc.d_model)).astype(np.float32)
    want, (wc, wh) = jssm.apply_mamba(pm_j, jnp.asarray(x), jc)
    got, (tcv, th) = tssm.apply_mamba(pm_t, _t(x), tc)
    assert _rel(got, want) <= RTOL
    assert _rel(tcv, wc) == 0.0 and _rel(th, wh) <= RTOL
    x1 = rng.standard_normal((2, 1, jc.d_model)).astype(np.float32)
    want, (wc, wh) = jssm.apply_mamba(pm_j, jnp.asarray(x1), jc,
                                      conv_state=wc, ssm_state=wh)
    got, (tcv, th) = tssm.apply_mamba(pm_t, _t(x1), tc, conv_state=tcv,
                                      ssm_state=th)
    assert _rel(got, want) <= RTOL
    assert _rel(tcv, wc) == 0.0 and _rel(th, wh) <= RTOL


# ------------------------------------------------------------ the model
MODEL_ARCHS = ["qwen1.5-4b", "granite-8b", "glm4-9b", "falcon-mamba-7b",
               "musicgen-medium"]


@pytest.mark.parametrize("arch", MODEL_ARCHS)
def test_logits_and_decode_steps_match_jax(arch):
    """logits_fn on 18 tokens, then 18 decode steps against the reference's
    (cache included), and decode against the port's own prefill."""
    jc, tc = _cfgs(arch)
    jp, tp = _params(jc)
    toks = np.random.default_rng(11).integers(0, jc.vocab, (2, 18))
    want = np.asarray(jlm.logits_fn(jp, jnp.asarray(toks, jnp.int32), jc))
    prefill = tsteps.make_prefill_step(tc)(tp, {"tokens": _t(toks)})
    assert _rel(prefill, want) <= RTOL
    jcache = jlm.init_cache(jc, 2, 24)
    tcache = tlm.init_cache(tc, 2, 24)
    jstep = jax.jit(lambda p, c, t, pos: jlm.decode_step(p, c, t, pos, jc))
    tstep = tsteps.make_decode_step(tc)
    outs = []
    for t in range(18):
        wl, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1],
                                                   jnp.int32), jnp.int32(t))
        tl, tcache2 = tstep(tp, tcache, _t(toks[:, t:t + 1]), t)
        assert tcache2 is tcache  # updated in place
        assert _rel(tl, wl) <= RTOL, t
        outs.append(tl[:, 0])
    for k in tcache:
        assert _rel(tcache[k], jcache[k]) <= RTOL, k
    assert _rel(torch.stack(outs, 1), want) <= RTOL


def test_bf16_logits_stay_near_jax():
    """The configs' own dtype: within 2e-2 of the max logit (rounding
    sites differ between the frameworks)."""
    jc, tc = _cfgs("qwen1.5-4b", dtype="bfloat16")
    jp, tp = _params(jc)
    toks = np.random.default_rng(12).integers(0, jc.vocab, (2, 10))
    want = jlm.logits_fn(jp, jnp.asarray(toks, jnp.int32), jc)
    got = tlm.logits_fn(tp, _t(toks), tc)
    assert got.dtype == torch.bfloat16
    assert _rel(got, np.asarray(want.astype(jnp.float32))) <= 2e-2


# ------------------------------------------------------------ serving
@pytest.mark.parametrize("arch", ["qwen1.5-4b", "falcon-mamba-7b"])
def test_serve_matches_the_reference_launcher(arch, monkeypatch, capsys):
    """The JAX launcher (``repro.launch.serve.main``) and the port's slot
    loop on the same f32 parameters: the same served token count and the
    same greedy tokens, step by step."""
    from repro.launch import serve as jserve

    jc, tc = _cfgs(arch)
    jp, tp = _params(jc, seed=3)
    monkeypatch.setattr(jserve, "get_config", lambda name, smoke: jc)
    monkeypatch.setattr(jserve.lm, "init", lambda cfg, key: jp)
    jax_next = []
    compile_step = jserve.steps_mod.compile_decode_step

    def recording(*a, **k):
        fn, *rest = compile_step(*a, **k)

        def step(params, cache, tokens, pos):
            logits, cache = fn(params, cache, tokens, pos)
            jax_next.append(np.asarray(jnp.argmax(logits[:, 0], axis=-1)))
            return logits, cache
        return (step, *rest)

    monkeypatch.setattr(jserve.steps_mod, "compile_decode_step", recording)
    flags = dict(slots=3, requests=5, prompt_len=4, max_new=5, cache_len=24,
                 seed=2)
    argv = ["--arch", arch, "--smoke"] + [
        a for k, v in flags.items()
        for a in (f"--{k.replace('_', '-')}", str(v))]
    want_tokens = jserve.main(argv)
    assert "5/5 requests" in capsys.readouterr().out
    res = tserve.serve_requests(tc, tp, device="cpu", **flags)
    assert res["served_tokens"] == want_tokens == 25
    assert sorted(res["completed"]) == list(range(5))
    assert res["steps"] == len(jax_next)
    # the reference's greedy picks, replayed through its slot loop, are the
    # tokens the port emitted for each request
    j_outputs = _replay_outputs(jax_next, flags)
    assert j_outputs == res["outputs"]


def _replay_outputs(next_tokens, flags):
    """The per-request greedy tokens the reference's lockstep loop emits,
    given the argmax it read at every step."""
    slots, requests = flags["slots"], flags["requests"]
    prompt_len, max_new = flags["prompt_len"], flags["max_new"]
    state, outputs, nxt_req = [None] * slots, {}, 0
    for pos, nxt in enumerate(next_tokens):
        for s in range(slots):
            if state[s] is None and nxt_req < requests:
                state[s] = [nxt_req, 0]
                outputs[nxt_req] = []
                nxt_req += 1
        for s in range(slots):
            if state[s] is None:
                continue
            rid = state[s][0]
            if pos + 1 >= prompt_len:
                outputs[rid].append(int(nxt[s]))
                state[s][1] += 1
                if state[s][1] >= max_new:
                    state[s] = None
    return outputs


def test_serve_cli_on_the_cpu_and_its_refusals(capsys):
    n = tserve.main(["--arch", "falcon-mamba-7b", "--smoke", "--slots", "2",
                     "--requests", "3", "--prompt-len", "3", "--max-new",
                     "4", "--device", "cpu"])
    assert n == 12
    assert "[serve] 3/3 requests, 12 tokens" in capsys.readouterr().out
    # meshes beyond 1x1 serve (test_torch_lm_mesh_ref.py); refused is a
    # malformed --mesh; a model degree that splits neither the heads nor
    # their columns nor the vocabulary serves them whole on every rank
    # (test_torch_lm_replicate.py)
    with pytest.raises(ValueError, match="DATAxMODEL"):
        tserve.main(["--arch", "qwen1.5-4b", "--smoke", "--mesh", "2by1",
                     "--device", "cpu"])
    args = ["--arch", "qwen1.5-4b", "--smoke", "--slots", "3", "--requests",
            "1", "--prompt-len", "2", "--max-new", "1", "--device", "cpu"]
    assert tserve.main(args + ["--mesh", "1x3"]) == tserve.main(args) == 1
    capsys.readouterr()
    n = tserve.main(["--arch", "mixtral-8x7b", "--smoke", "--slots", "2",
                     "--requests", "3", "--prompt-len", "3", "--max-new",
                     "4", "--device", "cpu"])
    assert n == 12 and "[serve] 3/3 requests" in capsys.readouterr().out
    with pytest.raises(ValueError, match="missing"):
        lm_params_from_jax({"embed": {}}, device="cpu")
    with pytest.raises(ValueError, match="no LM family"):
        lm_params_from_jax({"embed": {}, "final_norm": {}, "rec_blocks": {}},
                           device="cpu")
