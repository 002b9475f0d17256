"""One rank of the port's LM mesh cases (``test_torch_lm_mesh*.py``).

``run_cases`` runs on every gloo rank of a ``(data, model)`` mesh on the
CPU, through ``repro_torch.runtime.collectives.spawn_ranks``: each case
names a task and its inputs (numpy parameters, batches and tokens), the
rank runs it on its blocks and gathers what it computed into global numpy
arrays.  It imports nothing of JAX, so a spawned rank starts fast; the
test process holds the results against the port's one-rank run and the
JAX package.
"""
import contextlib
import dataclasses

import numpy as np
import torch

CPU = "cpu"


def _np(t):
    return t.detach().float().cpu().numpy()


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _shapes(tree) -> list:
    from repro_torch.tree import tree_leaves

    return [tuple(t.shape) for t in tree_leaves(tree)]


def launcher_optimizer():
    """The launcher's optimizer (lr 3e-4, warmup 20, wd 0.01, clip 1)."""
    from repro_torch.optim import AdamW, warmup_cosine

    return AdamW(lr=warmup_cosine(3e-4, 20, 100), weight_decay=0.01,
                 grad_clip_norm=1.0)


def family(mesh, case, shd, steps, lm):
    """Prefill logits, lm_loss and its gradients, decode steps and one
    AdamW step of one config on this rank's blocks, each gathered."""
    from repro_torch.tree import tree_map

    cfg, params = case["cfg"], _tensors(case["params"])
    batch = _tensors(case["batch"])
    out = {}
    pspecs = lm.param_specs(cfg)
    p_place = shd.tree_shardings(pspecs, mesh)
    local = shd.local_tree(params, p_place, mesh)
    b_specs = {k: _Spec(v.shape) for k, v in batch.items()}

    fn, _, b_place, _ = steps.compile_prefill_step(cfg, mesh, b_specs,
                                                   device=CPU)
    b_local = shd.local_tree(batch, b_place, mesh)
    with torch.no_grad():
        logits = fn(local, b_local)
    out["logits"] = _np(shd.gather_leaf(
        logits, steps.logits_sharding(cfg, mesh, batch["tokens"].shape[0]),
        mesh))
    out["param_shapes"] = _shapes(local)

    split = b_place["tokens"][:1] != (None,)
    with shd.activation_sharding(mesh, batch_sharded=split):
        loss, grads = steps.loss_and_grads(
            lambda p, b: lm.lm_loss(p, b, cfg), local, b_local,
            pspecs=p_place, mesh=mesh)
    out["loss"] = float(loss)
    out["grads"] = tree_map(_np, shd.gather_tree(grads, p_place, mesh))

    dec = case.get("decode")
    if dec is not None:
        dcfg, toks = dec["cfg"], torch.from_numpy(dec["tokens"])
        B, L = toks.shape[0], dec["cache_len"]
        fn_d, dp_place, c_place, cspecs = steps.compile_decode_step(
            dcfg, mesh, B, L, device=CPU)
        cache = shd.sharded_zeros(cspecs, mesh, device=CPU)
        if "xk" in dec:
            for k in ("xk", "xv"):
                cache[k] = shd.local_tree(
                    {k: torch.from_numpy(dec[k])}, {k: c_place[k]}, mesh)[k]
        out["cache_shapes"] = _shapes(cache)
        tok_place = shd.batch_sharding(mesh, 2, batch_size=B)
        dec_local = shd.local_tree(params, dp_place, mesh)
        got = []
        with torch.no_grad():
            for t in range(toks.shape[1]):
                lg, cache = fn_d(dec_local, cache, shd.local_block(
                    toks[:, t:t + 1], tok_place, mesh), t)
                got.append(_np(shd.gather_leaf(
                    lg, steps.logits_sharding(dcfg, mesh, B), mesh))[:, 0])
        out["decode"] = np.stack(got, 1)
        out["cache"] = tree_map(_np, shd.gather_tree(cache, c_place, mesh))

    step = case.get("step")
    if step is not None:
        fn_t, s_place, sb_place, _ = steps.compile_train_step(
            cfg, mesh, b_specs, optimizer=launcher_optimizer(), device=CPU,
            accum_steps=step.get("accum", 1))
        state = steps.init_train_state(
            cfg, torch.Generator().manual_seed(0), launcher_optimizer(),
            mesh=mesh)
        out["state_shapes"] = _shapes(state)
        state["params"] = shd.local_tree(params, p_place, mesh)
        metrics = []
        for b in step["batches"]:
            state, m = fn_t(state, shd.local_tree(_tensors(b), sb_place,
                                                  mesh))
            metrics.append({k: float(v) for k, v in m.items()})
        out["step_metrics"] = metrics
        out["step_params"] = tree_map(_np, shd.gather_tree(
            state["params"], p_place, mesh))
    return out


def suite_steps(mesh, case):
    """The reference's SUITE case 1 on this mesh: the first step's loss and
    gradients, then the losses of ``len(batches)`` compiled train steps."""
    from repro_torch.models import lm
    from repro_torch.optim import AdamW
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps
    from repro_torch.tree import tree_map

    cfg, params = case["cfg"], _tensors(case["params"])
    batch = _tensors(case["batch"])
    b_specs = {k: _Spec(v.shape) for k, v in batch.items()}
    fn, s_place, b_place, _ = steps.compile_train_step(
        cfg, mesh, b_specs, optimizer=AdamW(lr=case["lr"]), device=CPU)
    p_place = s_place["params"]
    local = shd.local_tree(params, p_place, mesh)
    b_local = shd.local_tree(batch, b_place, mesh)
    with shd.activation_sharding(mesh):
        loss, grads = steps.loss_and_grads(
            lambda p, b: lm.lm_loss(p, b, cfg), local, b_local,
            pspecs=p_place, mesh=mesh)
    out = {"loss0": float(loss),
           "grads0": tree_map(_np, shd.gather_tree(grads, p_place, mesh))}
    state = steps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   AdamW(lr=case["lr"]), mesh=mesh)
    state["params"] = local
    losses = []
    for _ in range(case["steps"]):
        state, m = fn(state, b_local)
        losses.append(float(m["loss"]))
    out["losses"] = losses
    return out


def save_state(mesh, case):
    """One train step on this mesh, the state saved under it (rank 0
    writes); returns the gathered state that was saved."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps
    from repro_torch.tree import tree_map

    cfg, batch = case["cfg"], _tensors(case["batch"])
    b_specs = {k: _Spec(v.shape) for k, v in batch.items()}
    fn, s_place, b_place, _ = steps.compile_train_step(
        cfg, mesh, b_specs, optimizer=launcher_optimizer(), device=CPU)
    state = steps.init_train_state(cfg, torch.Generator().manual_seed(0),
                                   launcher_optimizer(), mesh=mesh)
    state["params"] = shd.local_tree(_tensors(case["params"]),
                                     s_place["params"], mesh)
    state, _ = fn(state, shd.local_tree(batch, b_place, mesh))
    ckpt.save(case["dir"], 1, state, mesh=mesh, pspecs=s_place)
    return tree_map(lambda t: t.numpy().copy(),
                    shd.gather_tree(state, s_place, mesh))


def restore_state(mesh, case):
    """The state saved by ``save_state`` restored on this mesh: the leaf
    shapes this rank holds and the gathered leaves."""
    from repro_torch import checkpoint as ckpt
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps
    from repro_torch.tree import tree_map

    sspecs = steps.train_state_specs(case["cfg"])
    s_place = shd.tree_shardings(sspecs, mesh)
    state = ckpt.restore(case["dir"], 1, shd.abstract_like(sspecs),
                         device=CPU, mesh=mesh, pspecs=s_place)
    return {"shapes": _shapes(state),
            "state": tree_map(lambda t: t.numpy().copy(),
                              shd.gather_tree(state, s_place, mesh))}


def compressed_mean(mesh, case):
    """``compressed_psum_mean`` of this rank's row over every rank, and
    whether every rank got the same result."""
    import torch.distributed as dist

    from repro_torch.optim.compression import compressed_psum_mean
    from repro_torch.runtime.collectives import all_gather_dim

    x = torch.from_numpy(case["x"][dist.get_rank()])
    got = compressed_psum_mean(x)
    every = all_gather_dim(got[None], dist.group.WORLD, 0)
    return {"mean": got.numpy(),
            "same": bool(all(torch.equal(r, got) for r in every))}


def sharded_norm(mesh, case):
    """``global_norm`` of this rank's blocks of a global tree."""
    from repro_torch.optim.adamw import global_norm
    from repro_torch.runtime import sharding as shd

    tree = _tensors(case["tree"])
    return float(global_norm(shd.local_tree(tree, case["places"], mesh),
                             case["places"], mesh))


@contextlib.contextmanager
def f32_launchers():
    """Both LM launchers build their configs in float32 inside (the
    launcher tests compare meshes, whose bf16 partial sums round apart)."""
    from repro_torch.launch import serve as tserve
    from repro_torch.launch import train as ttrain
    from repro_torch.models import get_config

    def f32(arch, smoke=False):
        return dataclasses.replace(get_config(arch, smoke=smoke),
                                   dtype=torch.float32)

    real = ttrain.get_config, tserve.get_config
    ttrain.get_config = tserve.get_config = f32
    try:
        yield
    finally:
        ttrain.get_config, tserve.get_config = real


def launcher_train(mesh, case):
    """``launch.train.main(case["argv"])`` in f32 on this mesh's ranks (a
    rank with the process group up runs, it does not spawn); its losses."""
    from repro_torch.launch import train as ttrain

    with f32_launchers():
        return ttrain.main(case["argv"])


def launcher_serve(mesh, case):
    """``launch.serve.main(case["argv"])`` in f32; the tokens served and
    each request's greedy tokens."""
    from repro_torch.launch import serve as tserve

    real, seen = tserve.serve_requests, {}

    def recording(*a, **kw):
        seen.update(real(*a, **kw))
        return seen

    tserve.serve_requests = recording
    try:
        with f32_launchers():
            served = tserve.main(case["argv"])
    finally:
        tserve.serve_requests = real
    return {"served": served, "outputs": seen["outputs"]}


def launcher_rollback(mesh, case):
    """``launch.train.main`` in f32 on this mesh's ranks: a clean run, then
    one whose step poisons the state (a NaN final norm scale) on one call
    after a checkpoint; both runs' losses."""
    with f32_launchers():
        return _rollback(case)


def _rollback(case):
    from repro_torch.launch import train as ttrain

    argv, real = case["argv"], ttrain.steps_mod.compile_train_step
    clean = ttrain.main(argv)
    calls = {"n": 0}

    def compile_train_step(*a, **kw):
        fn, s_place, b_place, sspecs = real(*a, **kw)

        def step(state, batch):
            calls["n"] += 1
            if calls["n"] == case["poison_call"]:
                state["params"]["final_norm"]["scale"].fill_(float("nan"))
            return fn(state, batch)

        return step, s_place, b_place, sspecs

    ttrain.steps_mod.compile_train_step = compile_train_step
    try:
        rolled = ttrain.main(argv + ["--ckpt-dir", case["dir"],
                                     "--ckpt-every", "5"])
    finally:
        ttrain.steps_mod.compile_train_step = real
    return {"clean": clean, "rolled": rolled}


class _Spec:
    """A batch entry's shape, what ``compile_*_step`` reads of a spec."""

    def __init__(self, shape):
        self.shape = tuple(shape)


def run_cases(rank, data, model, cases):
    """Every case of one (data, model) mesh on this rank; rank 0 returns
    the results (every rank computes them)."""
    torch.set_num_threads(1)
    from repro_torch.models import lm
    from repro_torch.runtime import sharding as shd
    from repro_torch.runtime import steps

    mesh = shd.make_mesh_2d(data, model, device=CPU)
    out = {}
    for name, case in cases.items():
        task = case.get("task", "family")
        if task == "family":
            out[name] = family(mesh, case, shd, steps, lm)
        else:
            out[name] = globals()[task](mesh, case)
    return out if rank == 0 else None


# ------------------------------------------------ the cases and one rank
def family_case(arch, seed, B, S, dec_b, dec_steps, cache_len):
    """The numpy inputs of one family's mesh case: f32 smoke parameters
    from the port's ``lm.init`` (vlm's cross gates opened), a padded
    batch, decode tokens (moe at the capacity lifted to n_experts, vlm's
    xk/xv from vision states) and one train step's batch."""
    import dataclasses

    from repro_torch.models import get_config, lm
    from repro_torch.tree import tree_map

    cfg = dataclasses.replace(get_config(arch, smoke=True),
                              dtype=torch.float32)
    params = lm.init(cfg, torch.Generator().manual_seed(seed))
    if cfg.family == "vlm":  # away from the zero init that cuts them off
        params["cross_blocks"]["xattn"]["gate"].fill_(0.5)
        params["cross_blocks"]["gate_ffn"].fill_(0.5)
    r = np.random.default_rng(seed)
    batch = {"tokens": r.integers(0, cfg.vocab, (B, S)),
             "labels": r.integers(0, cfg.vocab, (B, S))}
    batch["labels"][0, :3] = -1
    if cfg.family == "vlm":
        batch["vision"] = r.standard_normal(
            (B, cfg.vision_seq, cfg.d_model)).astype(np.float32)
    dcfg = (dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
            if cfg.family == "moe" else cfg)
    dec = {"cfg": dcfg, "tokens": r.integers(0, cfg.vocab,
                                             (dec_b, dec_steps)),
           "cache_len": cache_len}
    if cfg.family == "vlm":  # the cross K/V of vision states
        vis = r.standard_normal((dec_b, cfg.vision_seq, cfg.d_model))
        for name, w in (("xk", "wk"), ("xv", "wv")):
            wt = params["cross_blocks"]["xattn"][w].numpy()
            kv = np.einsum("bsd,ldk->lbsk", vis, wt)
            dec[name] = kv.reshape(kv.shape[:3] + (
                cfg.n_kv_heads, cfg.head_dim)).astype(np.float32)
    return {"cfg": cfg, "params": tree_map(lambda t: t.numpy(), params),
            "batch": batch, "decode": dec, "step": {"batches": [batch]}}


def one_rank(case) -> dict:
    """The port's one-rank results of a ``family_case`` (what ``family``
    computes on a mesh)."""
    from repro_torch.models import lm
    from repro_torch.runtime import steps
    from repro_torch.tree import tree_map

    cfg = case["cfg"]
    params = tree_map(torch.from_numpy, case["params"])
    tb = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    out = {}
    with torch.no_grad():
        out["logits"] = lm.logits_fn(params, tb["tokens"], cfg,
                                     tb.get("vision")).numpy()
    loss, grads = steps.loss_and_grads(lambda p, b: lm.lm_loss(p, b, cfg),
                                       params, tb)
    out["loss"], out["grads"] = float(loss), tree_map(
        lambda t: t.numpy(), grads)
    dec = case["decode"]
    toks = torch.from_numpy(dec["tokens"])
    cache = lm.init_cache(dec["cfg"], toks.shape[0], dec["cache_len"])
    for k in ("xk", "xv"):
        if k in dec:
            cache[k] = torch.from_numpy(dec[k])
    got = []
    with torch.no_grad():
        for t in range(toks.shape[1]):
            lg, cache = lm.decode_step(params, cache, toks[:, t:t + 1], t,
                                       dec["cfg"])
            got.append(lg[:, 0].numpy())
    out["decode"] = np.stack(got, 1)
    out["cache"] = tree_map(lambda t: t.numpy(), cache)
    step = case.get("step")
    if step is not None:
        opt = launcher_optimizer()
        state = {"params": tree_map(torch.clone, params),
                 "step": torch.zeros((), dtype=torch.int32)}
        moments = opt.init(state["params"])
        state.update(mu=moments.mu, nu=moments.nu)
        fn = steps.make_train_step(cfg, opt,
                                   accum_steps=step.get("accum", 1))
        metrics = []
        for b in step["batches"]:
            state, m = fn(state, {k: torch.from_numpy(v)
                                  for k, v in b.items()})
            metrics.append({k: float(v) for k, v in m.items()})
        out["step_metrics"] = metrics
        out["step_params"] = tree_map(lambda t: t.numpy(), state["params"])
    return out
