"""One rank of the port's mesh cases (``test_torch_mesh.py``).

``run_mesh`` runs on every gloo rank of a ``(data, model)`` mesh on the
CPU, through ``repro_torch.runtime.collectives.spawn_ranks``, and returns
numpy results: the sharded losses and gathered gradients of each family,
the compiled sharded and data-parallel steps, the chunk, the pencil FFT
and the engines' outputs.  It imports nothing of JAX, so a spawned rank
starts fast; the test process holds every result against the JAX package.
"""
import warnings

import numpy as np
import torch

CPU = "cpu"


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()


def _loss_grads(ds, shd, mesh, case):
    cfg, params, batch = case["cfg"], case["params"], case["batch"]
    rules = shd.donn_rules()
    pspecs = shd.tree_pspecs(ds.donn_state_specs(cfg)["params"], mesh, rules)
    loss_fn = ds.make_donn_sharded_loss(cfg, mesh, device=CPU)
    loss, grads = ds.value_and_grad(
        loss_fn, ds.shard_state(params, pspecs, mesh),
        ds.shard_state(batch, ds._batch_pspecs(cfg, mesh, rules), mesh))
    return float(loss), _np(ds.gather_state(grads, pspecs, mesh))


def _steps(fn, s_pspecs, b_pspecs, ds, mesh, state, batches):
    st = ds.shard_state(state, s_pspecs, mesh)
    losses = []
    for b in batches:
        st, m = fn(st, ds.shard_state(b, b_pspecs, mesh))
        losses.append(np.asarray(m["loss"]).reshape(-1).tolist())
    return sum(losses, []), _np(ds.gather_state(st, s_pspecs, mesh))


def _pencil(mesh, shd):
    """The pencil fft2/ifft2 of a (B, C, H, W) field's row blocks, the
    deprecated standalone form, and the gradient of a weighted spectral
    power through the exchange, each gathered whole."""
    from repro_torch.runtime.collectives import all_gather_dim, sum_over
    from repro_torch.runtime.pencil_fft import (
        local_spectral_pair, pencil_fft2, propagate_tf_distributed,
    )

    group = mesh.get_group("model")
    fft2, ifft2 = local_spectral_pair(group, shd.mesh_shape(mesh)["model"])
    rng = np.random.default_rng(5)
    x = torch.view_as_complex(torch.from_numpy(
        rng.standard_normal((2, 3, 16, 24, 2)).astype(np.float32)))
    wts = torch.from_numpy(rng.random((16, 24)).astype(np.float32))
    h_tf = torch.view_as_complex(torch.from_numpy(
        rng.standard_normal((16, 24, 2)).astype(np.float32)))
    local = shd.local_block(x, (None, None, "model", None), mesh).contiguous()
    whole = lambda t: all_gather_dim(t.detach(), group, -2).numpy()  # noqa
    out = {"x": x.numpy(), "weights": wts.numpy(), "h_tf": h_tf.numpy(),
           "fft2": whole(fft2(local)), "ifft2": whole(ifft2(local)),
           "propagated": whole(propagate_tf_distributed(
               local, shd.local_block(h_tf, ("model", None), mesh), mesh))}
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        dep = pencil_fft2(local, mesh)
    out["deprecated_warns"] = any(issubclass(i.category, DeprecationWarning)
                                  for i in w)
    out["deprecated_equal"] = bool(torch.equal(dep, fft2(local)))
    xl = local.clone().requires_grad_(True)
    part = (torch.abs(fft2(xl)) ** 2
            * shd.local_block(wts, ("model", None), mesh)).sum()
    (g,) = torch.autograd.grad(sum_over(part, group), xl)
    out["grad"] = whole(g)
    return out


def _serve(inf, md, case, data, model):
    cfg, params, x = case["cfg"], case["params"], case["x"]
    m = md.build_model(cfg, device=CPU)
    dep = inf.freeze(m, {"phase": {k: torch.from_numpy(v) for k, v in
                                   params["phase"].items()}}, device=CPU)
    out = {}
    engines = {}
    if data > 1:  # data parallel over every rank of the world
        engines["dp"] = dict(mesh_devices=data * model, dp_min_bucket=8)
        engines["dp_small"] = dict(mesh_devices=data * model,
                                   dp_min_bucket=8)
    if model > 1:
        engines["rows"] = dict(mesh_devices=data, model_devices=model,
                               dp_min_bucket=8)
    for name, kw in engines.items():
        buckets = (2, 8) if name == "dp_small" else (8,)
        eng = inf.InferenceEngine(dep, buckets=buckets, device=CPU, **kw)
        xs = x[:2] if name == "dp_small" else x
        got = eng.infer(xs)
        out[name] = got
        out[name + "_repeat_equal"] = bool(np.array_equal(got, eng.infer(xs)))
    return out


def run_mesh(rank, data, model, cases):
    """Every case of one (data, model) mesh on this rank."""
    torch.set_num_threads(1)
    from repro_torch.core import models as md
    from repro_torch.optim import AdamW
    from repro_torch.runtime import donn_steps as ds
    from repro_torch.runtime import inference as inf
    from repro_torch.runtime import sharding as shd

    mesh = shd.make_mesh_2d(data, model, device=CPU)
    out = {"families": {}}
    for tag, case in cases["families"].items():
        out["families"][tag] = _loss_grads(ds, shd, mesh, case)

    step = cases["step"]
    cfg, state, batches = step["cfg"], step["state"], step["batches"]
    fn, s_ps, b_ps, _ = ds.compile_donn_train_step_sharded(
        cfg, mesh, optimizer=AdamW(lr=0.05), global_batch=8, device=CPU)
    out["sharded_step"] = _steps(fn, s_ps, b_ps, ds, mesh, state, batches)
    fn, s_ps, b_ps, _ = ds.compile_donn_train_step(
        cfg, mesh, optimizer=AdamW(lr=0.05), global_batch=8, device=CPU)
    out["dp_step"] = _steps(fn, s_ps, b_ps, ds, mesh, state, batches)

    chunk = cases["chunk"]
    fn, s_ps, b_ps, _ = ds.compile_donn_train_chunk(
        chunk["cfg"], mesh, optimizer=AdamW(lr=0.05), device=CPU)
    stacked = [{k: np.stack([b[k] for b in chunk["batches"][i:i + 2]])
                for k in chunk["batches"][0]}
               for i in range(0, len(chunk["batches"]), 2)]
    out["dp_chunk"] = _steps(fn, s_ps, b_ps, ds, mesh, chunk["state"],
                             stacked)

    if model > 1:
        out["pencil"] = _pencil(mesh, shd)
    out["serve"] = _serve(inf, md, cases["serve"], data, model)
    return out
