"""The port's moe family (mixtral-8x7b, arctic-480b) against the JAX package.

Parameters come from the JAX package (``repro.models.lm.init``, numpy on
the way over) through ``repro_torch.convert.lm_params_from_jax``; inputs
from seeded numpy generators; both sides in float32 on the CPU unless a
test says bf16.  The reference's results of each smoke config are
computed once (``_torch_lm_family.Reference``, a module-scoped fixture).

Tolerances (max|port - jax| / max|jax| of each leaf), measured with the
CPU builds of torch 2.13 and jax 0.9:
- ``apply_moe`` outputs and aux, with capacity drops (the smoke configs'
  factor 1.25 on an input that crowds two experts, drops asserted) and
  without: within 3.2e-7, held at 1e-5; ``expert_capacity`` equal.
- logits, ``lm_loss`` with the aux term and every gradient within
  1.8e-6; 18 decode steps and the final cache within 1.1e-6 of the
  reference's (capacity lifted to ``n_experts``, the reference test's
  recipe), and of the port's prefill (the reference's own bound there is
  1e-4); 40 steps through mixtral's rolling window within 1.3e-6: all
  held at 1e-5.
- three ``make_train_step`` steps at accum 1 and 2: params within 1.4e-6
  (losses and grad norms held at 1e-5 too).
- bf16 (the configs' own dtype): ``apply_moe`` on the same bf16 input on
  both sides, gradients within 1.25e-2 of their max, held at the dense
  families' 0.15.  The model against JAX run op by op (``disable_jit``):
  the loss within 9.6e-5, held at their 1e-2; the gradients within 2.0e-2
  (arctic) and 7.9e-2 (mixtral, the leaves held), held at 0.15.  Against
  ``jax.jit`` the gradients differ by 0.30 and 0.25 of their max: XLA's
  fused scan body rounds bf16 at other places.  Op by op, one token
  routes to another expert on one side (mixtral smoke, layer 1, token 78:
  JAX experts {3, 1}, the port's {3, 0}, a router-logit margin of
  6.8e-3), asserted to be the only one; it moves that token's whole
  contribution between experts, so the expert stacks (0.10-0.23) and the
  unembed, which takes the token's last-layer row (0.23), are printed,
  not held, for mixtral.
"""
import pytest

torch = pytest.importorskip("torch")

from _torch_cores import share_cores  # noqa: E402

share_cores(torch)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_lm_family as fam  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCHS = ("mixtral-8x7b", "arctic-480b")
# (layer, token) of each token the bf16 model routes to another expert
# set than JAX op by op does, on the Reference's batch
REROUTED = {"mixtral-8x7b": {(1, 78)}, "arctic-480b": set()}
ROUTE_MARGIN = 1e-2  # router logits: a few bf16 rounding steps at |x| ~ 1
MOE_EXEMPT = ("['blocks']['moe']['w_down']", "['blocks']['moe']['w_gate']",
              "['blocks']['moe']['w_up']", "['embed']['unembed']")


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    return fam.Reference(request.param)


def _moe_params(arch, seed=0):
    """(jax, port) parameters of layer 0's moe block."""
    jc, tc = fam.cfgs(arch)
    jp = jlm.init(jc, jax.random.PRNGKey(seed))
    blk = jax.tree.map(lambda a: np.asarray(a[0]), jp["blocks"]["moe"])
    return (jc, tc, jax.tree.map(jnp.asarray, blk),
            jax.tree.map(torch.from_numpy, blk))


# ------------------------------------------------------------ the block
@pytest.mark.parametrize("group", [1, 7, 37, 64, 4096])
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_capacity_matches_jax(arch, group):
    jc, tc = fam.cfgs(arch)
    assert tmoe.expert_capacity(tc, group) == jmoe.expert_capacity(jc, group)


@pytest.mark.parametrize("lifted", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(arch, lifted):
    """Outputs and aux at the smoke config's capacity factor (1.25: some
    (token, slot) pairs are dropped, asserted) and with it lifted to
    n_experts (none dropped)."""
    jc, tc, jp, tp = _moe_params(arch)
    if lifted:
        jc, tc = fam.decode_cfg(jc), fam.decode_cfg(tc)
    r = np.random.default_rng(4)
    # a component shared by every token crowds the router onto two
    # experts, past their capacity
    x = (r.standard_normal((2, 64, jc.d_model))
         + 1.5 * r.standard_normal((1, 1, jc.d_model))).astype(np.float32)
    want, waux = jax.jit(lambda p, xx: jmoe.apply_moe(p, xx, jc))(
        jp, jnp.asarray(x))
    got, taux = tmoe.apply_moe(tp, torch.from_numpy(x), tc)
    assert fam.rel(got, want) <= fam.RTOL
    assert abs(float(taux) - float(waux)) <= fam.RTOL * abs(float(waux))
    # the pairs routed to each expert of each group, against its capacity
    _, _, idx = tmoe.route(tp, torch.from_numpy(x).reshape(2, 64, -1), tc)
    load = torch.nn.functional.one_hot(idx, tc.n_experts).sum(dim=(1, 2))
    dropped = int(torch.clamp(load - tmoe.expert_capacity(tc, 64),
                              min=0).sum())
    assert (dropped == 0) if lifted else (dropped > 0)


def test_routing_takes_the_lower_expert_on_a_tie():
    """A zero router gives every expert the same probability:
    ``jax.lax.top_k`` takes the lowest indices, and so does the port."""
    _, tc, jp, tp = _moe_params("arctic-480b")
    tp["router"] = torch.zeros_like(tp["router"])
    x = torch.randn(1, 5, tc.d_model, generator=torch.Generator()
                    .manual_seed(0))
    _, weights, idx = tmoe.route(tp, x, tc)
    want_w, want_idx = jax.lax.top_k(jnp.full((1, 5, tc.n_experts),
                                              1.0 / tc.n_experts), tc.top_k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert torch.equal(weights, torch.full_like(weights, 0.5))


# ------------------------------------------------------------ the model
def test_logits_match_jax(ref):
    fam.check_logits(ref)


def test_lm_loss_with_aux_and_grads_match_jax(ref):
    """lm_loss includes 0.01 times the layers' summed aux, on both
    sides."""
    x, aux = tlm.forward(ref.tp, ref.tb["tokens"], ref.tc)
    _, jaux = jlm.forward(ref.jp, ref.jb["tokens"], ref.jc)
    assert float(aux) > 0
    assert abs(float(aux) - float(jaux)) <= fam.RTOL * float(jaux)
    fam.check_loss_and_grads(ref)


def test_train_step_grads_split_every_stacked_group(ref):
    fam.check_split_grads(ref)


def test_decode_matches_prefill_and_jax(ref):
    fam.check_decode(ref)


@pytest.mark.parametrize("accum", fam.ACCUMS)
def test_three_train_steps_match_jax(ref, accum):
    fam.check_train_steps(ref, accum)


def _parted_routes(ref, monkeypatch) -> dict:
    """The bf16 model's forward on ``ref``'s batch on both sides (JAX op
    by op, as ``ref``'s bf16 gradients are taken): {(layer, token): JAX's
    router-logit margin between its k-th and (k+1)-th expert} of each
    token whose top-k expert set differs."""
    jc, tc = fam.cfgs(ref.arch, dtype="bfloat16", remat=False)
    seen = {"jax": [], "port": []}
    real_j, real_t = jmoe.apply_moe, tmoe.apply_moe

    def jax_moe(p, x, cfg, group_size=0):
        seen["jax"].append(np.asarray(x.astype(jnp.float32)
                                      @ p["router"].astype(jnp.float32)))
        return real_j(p, x, cfg, group_size)

    def port_moe(p, x, cfg, group_size=0):
        seen["port"].append((x.float() @ p["router"].float()).detach()
                            .numpy())
        return real_t(p, x, cfg, group_size)

    monkeypatch.setattr(jmoe, "apply_moe", jax_moe)
    monkeypatch.setattr(tmoe, "apply_moe", port_moe)
    with jax.disable_jit():
        jlm.forward(ref.jp, ref.jb["tokens"], jc)
    with torch.no_grad():
        tlm.forward(ref.tp, ref.tb["tokens"], tc)
    assert len(seen["jax"]) == len(seen["port"]) == jc.n_layers
    k, parted = jc.top_k, {}
    for layer, (a, b) in enumerate(zip(seen["jax"], seen["port"])):
        a, b = (v.reshape(-1, jc.n_experts) for v in (a, b))
        ka = np.argsort(-a, -1, kind="stable")[:, :k]
        kb = np.argsort(-b, -1, kind="stable")[:, :k]
        for t in np.flatnonzero([set(u) != set(v) for u, v in zip(ka, kb)]):
            top = np.sort(a[t])[::-1]
            parted[(layer, int(t))] = float(top[k - 1] - top[k])
            print(f"{ref.arch} bf16 layer {layer} token {t}: jax experts "
                  f"{ka[t]}, port {kb[t]}, margin {parted[(layer, t)]:.3e}")
    return parted


def test_bf16_loss_and_grads_stay_near_jax(ref, monkeypatch):
    """The model in bf16 against JAX op by op: the loss within 1e-2 and
    the gradients within 0.15 of their max.  The tokens whose expert sets
    differ are exactly REROUTED's, each at a router margin below
    ROUTE_MARGIN.  Where one is re-routed, the leaves that take its expert
    outputs directly (the expert stacks and the unembed, MOE_EXEMPT) are
    printed, not held."""
    parted = _parted_routes(ref, monkeypatch)
    assert set(parted) == REROUTED[ref.arch], parted
    assert all(m < ROUTE_MARGIN for m in parted.values()), parted
    fam.check_bf16(ref, exempt=MOE_EXEMPT if parted else ())


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_apply_moe_and_grads_stay_near_jax(arch):
    """apply_moe in bf16 on the same bf16 input on both sides: the output
    and aux, and the gradients of every parameter and of the input, within
    the bf16 bound of 0.15 of their max."""
    _, _, jp, tp = _moe_params(arch)
    jc, tc = fam.cfgs(arch, dtype="bfloat16")
    x = np.random.default_rng(0).standard_normal(
        (4, 37, jc.d_model)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)

    def jloss(p, xx):
        out, aux = jmoe.apply_moe(p, xx, jc)
        return jnp.sum(out.astype(jnp.float32) ** 2) + aux

    want, (wg, wgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jp, xj)
    params = tree_map(lambda t: t.detach().requires_grad_(True), tp)
    xt = torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_(True)
    out, aux = tmoe.apply_moe(params, xt, tc)
    got = (out.float() ** 2).sum() + aux
    leaves = tree_leaves(params) + [xt]
    grads = torch.autograd.grad(got, leaves)
    assert abs(float(got) - float(want)) <= fam.BF16_LOSS_RTOL * float(want)
    gaps = [fam.rel(g, np.asarray(w, np.float32)) for g, w in zip(
        grads, jax.tree.leaves(wg) + [wgx])]
    print(f"{arch} apply_moe bf16: grads rel {max(gaps):.3e}")
    assert max(gaps) <= fam.BF16_GRAD_RTOL


def test_rolling_window_decode_matches_prefill():
    """mixtral's sliding window: 40 decode steps (more than twice the
    window of 16) through a cache of the window's length, against the
    prefill on both sides (the reference's test_rolling_window_cache)."""
    jc, tc = fam.cfgs("mixtral-8x7b", capacity_factor=8.0)
    jp = jlm.init(jc, jax.random.PRNGKey(2))
    from repro_torch.convert import lm_params_from_jax

    tp = lm_params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks = np.random.default_rng(2).integers(0, jc.vocab, (2, 40))
    want = np.asarray(jlm.logits_fn(jp, jnp.asarray(toks, jnp.int32), jc))
    prefill = tlm.logits_fn(tp, torch.from_numpy(toks), tc)
    assert fam.rel(prefill, want) <= fam.RTOL
    cache = tlm.init_cache(tc, 2, tc.window)
    assert cache["k"].shape[2] == tc.window == 16
    outs = [tlm.decode_step(tp, cache, torch.from_numpy(toks[:, t:t + 1]),
                            t, tc)[0][:, 0] for t in range(40)]
    assert fam.rel(torch.stack(outs, 1), want) <= fam.RTOL
