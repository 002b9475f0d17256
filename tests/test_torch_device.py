"""Hygiene and device rules of the port; CUDA-only kernel checks.

This file imports no JAX, so the CUDA-only tests run on a machine with a
card and PyTorch alone:

    PYTHONPATH=src python -m pytest tests/test_torch_device.py

Whether a card is present is decided inside the ``cuda`` fixture at test
time; without one those tests skip with a reason.
"""
import ast
import dataclasses
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_cores import share_cores  # noqa: E402

share_cores(torch)

from repro_torch.convert import (  # noqa: E402
    donn_state_from_jax, lm_params_from_jax, lm_train_state_from_jax,
    params_from_jax,
)
from repro_torch.optim import AdamW  # noqa: E402
from repro_torch.runtime.donn_steps import make_donn_train_step  # noqa: E402
from repro_torch.core.config import DONNConfig, LayerSpec  # noqa: E402
from repro_torch.core.models import DONN, build_model  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve, serve_donn  # noqa: E402
from repro_torch.runtime import steps as lm_steps  # noqa: E402
from repro_torch.models import get_config as lm_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.layers import apply_rotary, rope_angles  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.runtime.inference import (  # noqa: E402
    InferenceEngine, MicroBatcher, freeze,
)
from repro_torch import checkpoint as ckpt  # noqa: E402
from repro_torch.runtime.fleet import FleetRouter  # noqa: E402
from repro_torch.runtime.resilience import (  # noqa: E402
    EngineSupervisor, load_deployed, save_deployed,
)
from repro_torch.testing import FlakyEngine, kill_replica  # noqa: E402

REPO = pathlib.Path(__file__).resolve().parent.parent
CFG = DONNConfig(name="dev", n=32, depth=2, distance=0.05, det_size=6,
                 codesign="qat", use_pallas=True)


# ------------------------------------------------------------ hygiene
def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node.lineno, a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("__import__", "import_module")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


# the scripts that run the JAX package: one writes the JAX-side fixture
# the port is held against (tests/fixtures/jax_artifact_n64), one measures
# the reference's own sharded-vs-single-device gap; the port, the chip
# smoke and every other script never import it
JAX_FIXTURE_WRITER = REPO / "scripts" / "write_jax_artifact_fixture.py"
JAX_SCRIPTS = (JAX_FIXTURE_WRITER, REPO / "scripts" / "reference_mesh_gap.py")


def _jax_imports(files) -> list:
    bad = []
    for f in files:
        for line, mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro", "flax", "optax",
                       "ml_dtypes"):
                bad.append(f"{f.relative_to(REPO)}:{line} imports {mod}")
    return bad


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    files.extend(f for f in sorted((REPO / "scripts").glob("*.py"))
                 if f not in JAX_SCRIPTS)
    assert len(files) > 15
    bad = _jax_imports(files)
    assert not bad, "\n".join(bad)


def test_the_fixture_writer_is_the_script_that_runs_the_reference():
    """The exemptions above name scripts that exist and run JAX."""
    for f in JAX_SCRIPTS:
        assert _jax_imports([f]), f


def _entry_points():
    model = lambda: build_model(CFG)  # noqa: E731
    return {
        "build_model": model,
        "DONN": lambda: DONN(CFG),
        "params_from_jax": lambda: params_from_jax(
            {"phase": {"layer_0": np.zeros((2, 2), np.float32)}}),
        "serve_donn": lambda: serve_donn.main(["--n", "32", "--depth", "2",
                                               "--requests", "4"]),
        "lm_params_from_jax": lambda: lm_params_from_jax(
            {"embed": {}, "final_norm": {}, "blocks": {}}),
        "serve": lambda: serve.main(["--arch", "qwen1.5-4b", "--smoke",
                                     "--slots", "2", "--requests", "2",
                                     "--prompt-len", "3", "--max-new", "2"]),
        "donn_state_from_jax": lambda: donn_state_from_jax({
            "params": {"phase": {}}, "mu": {"phase": {}},
            "nu": {"phase": {}}, "step": np.zeros((), np.int32)}),
        "make_donn_train_step": lambda: make_donn_train_step(CFG, AdamW()),
        "lm_train_state_from_jax": lambda: lm_train_state_from_jax({
            "params": {"embed": {}, "final_norm": {}, "blocks": {}},
            "mu": {}, "nu": {}, "step": np.zeros((), np.int32)}),
    }


@pytest.mark.parametrize("name", ["build_model", "DONN", "params_from_jax",
                                  "serve_donn", "lm_params_from_jax",
                                  "serve", "donn_state_from_jax",
                                  "make_donn_train_step",
                                  "lm_train_state_from_jax"])
def test_entry_points_default_to_the_card(name):
    call = _entry_points()[name]
    if torch.cuda.is_available():
        call()  # runs on the card
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_freeze_and_engine_default_to_the_card():
    model = build_model(CFG, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    dep = freeze(model, params, device="cpu")
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="lives on"):
            freeze(model, params)
        with pytest.raises(ValueError, match="lives on"):
            InferenceEngine(dep)
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        freeze(model, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(dep)


def _cpu_artifact(root: pathlib.Path) -> pathlib.Path:
    model = build_model(CFG, device="cpu")
    dep = freeze(model, model.init(torch.Generator().manual_seed(0)),
                 device="cpu")
    save_deployed(dep, root / "art")
    ckpt.save(root / "ck", 0, {"w": torch.ones(3)})
    return root


def _persistence_entry_points(root: pathlib.Path):
    art = root / "art"
    return {
        "load_deployed": lambda: load_deployed(art),
        "restore": lambda: ckpt.restore(root / "ck", 0, {"w": 0.0}),
        "EngineSupervisor": lambda: EngineSupervisor(art).start(),
        "FleetRouter.from_artifact": lambda: FleetRouter.from_artifact(
            art, replicas=1, buckets=(1,)).close(),
        "serve_donn --artifact": lambda: serve_donn.main(
            ["--artifact", str(art), "--requests", "4"]),
    }


@pytest.mark.parametrize("name", ["load_deployed", "restore",
                                  "EngineSupervisor",
                                  "FleetRouter.from_artifact",
                                  "serve_donn --artifact"])
def test_persistence_entry_points_default_to_the_card(tmp_path, name):
    """Artifacts written on the CPU load onto the card by default; without
    a card each entry point raises, nothing rebuilds on the CPU."""
    call = _persistence_entry_points(_cpu_artifact(tmp_path))[name]
    if torch.cuda.is_available():
        call()  # runs on the card
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only "
                    "there (no interpret mode)")
    return torch.device("cuda", 0)


def _field(gen, shape, dev):
    return torch.complex(torch.randn(shape, generator=gen),
                         torch.randn(shape, generator=gen)).to(dev)


def _rel(got, want) -> float:
    return float((got.cpu() - want.cpu()).abs().max()
                 / want.cpu().abs().max())


def _rope_inputs(gen, dev, dtype):
    x = torch.randn((2, 3, 37, 64), generator=gen)
    ang = torch.rand((37, 32), generator=gen) * 50.0
    return (x.to(dev, dtype), torch.cos(ang).to(dev, dtype),
            torch.sin(ang).to(dev, dtype))


def _scan_inputs(gen, dev, D=203, N=16):
    """K7 inputs: D not a multiple of the kernel's channels per block."""
    B, S = 2, 37
    dt = torch.nn.functional.softplus(torch.randn((B, S, D), generator=gen))
    x = torch.randn((B, S, D), generator=gen)
    bs = torch.randn((B, S, N), generator=gen)
    cs = torch.randn((B, S, N), generator=gen)
    a = -torch.arange(1, N + 1, dtype=torch.float32).expand(D, N)
    return [t.to(dev) for t in (dt, x, bs, cs, a)]


def _general_scan_inputs(gen, dev, B, S, D, N):
    """K7 inputs at general A, as a trained mixer has: A = -exp(randn(D, N))
    and dt log-uniform over 1e-3..1.  The s4d A = -(n+1) of ``_scan_inputs``
    (and of the served mixer's init) would hide a kernel that is right only
    for that structure."""
    dt = torch.empty((B, S, D)).uniform_(np.log(1e-3), 0.0,
                                         generator=gen).exp()
    x = torch.randn((B, S, D), generator=gen)
    bs = torch.randn((B, S, N), generator=gen)
    cs = torch.randn((B, S, N), generator=gen)
    a = -torch.exp(torch.randn((D, N), generator=gen))
    return [t.to(dev) for t in (dt, x, bs, cs, a)]


def _rope_bound_ok(got, want, x, cos, sin) -> bool:
    """K6 in bf16 against its plain version: per element within
    ``ref.rope_rounding_bound``, 3 * 2^-8 (|x1 c| + |x2 s|) (the plain
    version rounds each bf16 product and the result, the kernel once)."""
    got, want = got.float().cpu(), want.float().cpu()
    bound = ref.rope_rounding_bound(x.cpu(), cos.cpu(), sin.cpu())
    return bool(((got - want).abs() <= bound).all())


def test_wrappers_launch_kernels_never_plain_versions(cuda, monkeypatch):
    gen = torch.Generator().manual_seed(0)
    x = _field(gen, (4, 3, 37, 53), cuda)
    th = torch.rand((3, 37, 53), generator=gen).to(cuda) * 6.0
    amp = torch.rand((3, 37, 53), generator=gen).to(cuda)
    masks = torch.randn((10, 37, 53), generator=gen).to(cuda)
    b = _field(gen, (37, 53), cuda)
    rope32 = _rope_inputs(gen, cuda, torch.float32)
    rope16 = _rope_inputs(gen, cuda, torch.bfloat16)
    scan = _scan_inputs(gen, cuda)
    geo = torch.tensor([[36e-6, 532e-9, 0.3, 0.2], [20e-6, 633e-9, 0.1, 0.4]],
                       dtype=torch.float64, device=cuda)
    want = {
        "hop": ops.fused_spectral_hop(x.cpu(), th.cpu(), amp.cpu(), th.cpu(),
                                      amp.cpu()),
        "tf": ops.phase_tf_apply(x.cpu(), th.cpu(), amp.cpu()),
        "readout": ops.intensity_readout(x.cpu(), masks.cpu()),
        "k4": ops.phase_apply(x.cpu(), th[0].cpu(), 1.12),
        "k5": ops.complex_mul(x[:, 0].cpu(), b.cpu()),
        "k6": ops.apply_rope(*(t.cpu() for t in rope32)),
        "k6 bf16": ops.apply_rope(*(t.cpu() for t in rope16)),
        "k7": ops.selective_scan(*(t.cpu() for t in scan)),
        "planes": ops.transfer_planes_batched(geo.cpu(), 40, "rs", True,
                                              False)[0],
    }

    def forbidden(*a, **k):
        raise AssertionError("a plain version ran on a CUDA tensor")

    for fn in _PLAIN_VERSIONS:
        monkeypatch.setattr(ref, fn, forbidden)
    ops.reset_launch_counts()
    got = {
        "hop": ops.fused_spectral_hop(x, th, amp, th, amp),
        "tf": ops.phase_tf_apply(x, th, amp),
        "readout": ops.intensity_readout(x, masks),
        "k4": ops.phase_apply(x, th[0], 1.12),
        "k5": ops.complex_mul(x[:, 0], b),
        "k6": ops.apply_rope(*rope32),
        "k6 bf16": ops.apply_rope(*rope16),
        "k7": ops.selective_scan(*scan),
        "planes": ops.transfer_planes_batched(geo, 40, "rs", True, False)[0],
    }
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"conj_phase_scale": 2,
                                   "phase_tf_apply": 1,
                                   "intensity_readout": 1,
                                   "phase_apply": 1,
                                   "complex_mul": 1,
                                   "rope": 2,
                                   "selective_scan": 1,
                                   "transfer_planes": 1}
    tols = {"k6": 1e-6}
    for k in want:
        assert got[k].device.type == "cuda"
        if k == "k6 bf16":
            assert got[k].dtype == torch.bfloat16
            assert _rope_bound_ok(got[k], want[k], *rope16), k
        else:
            assert _rel(got[k], want[k]) <= tols.get(k, 1e-5), k


def test_fused_hop_at_prime_sizes_repeats_bitwise_on_the_card(cuda):
    """The hop of the test above at 37x53 (primes: cuFFT plans them with
    Bluestein's algorithm) gives one bitwise result, within 1e-5 of the
    CPU, run after run with the allocator's free blocks filled with NaN
    and with cuFFT's plan cache on and off: no freed buffer and no cuFFT
    work area is read before it is written.  (A single miss of this
    comparison, 5.7e-5, was seen once and never reproduced; ROADMAP queue
    3 records the hunt.)"""
    gen = torch.Generator().manual_seed(0)
    x = _field(gen, (4, 3, 37, 53), cuda)
    th = torch.rand((3, 37, 53), generator=gen).to(cuda) * 6.0
    amp = torch.rand((3, 37, 53), generator=gen).to(cuda)
    want = ops.fused_spectral_hop(x.cpu(), th.cpu(), amp.cpu(), th.cpu(),
                                  amp.cpu())
    first = ops.fused_spectral_hop(x, th, amp, th, amp)
    plans = torch.backends.cuda.cufft_plan_cache[cuda.index]
    size = plans.max_size
    try:
        for max_size in (size, 0):
            plans.clear()
            plans.max_size = max_size
            for _ in range(10):
                junk = [torch.full((1 << k,), float("nan"), device=cuda)
                        for k in range(8, 24)]
                del junk
                got = ops.fused_spectral_hop(x, th, amp, th, amp)
                torch.cuda.synchronize()
                assert torch.equal(got, first)
    finally:
        plans.max_size = size
    assert _rel(first, want) <= 1e-5


def test_gradients_flow_through_each_function_on_the_card(cuda):
    """Each autograd Function's backward launches its kernel on the card
    and matches autograd through the plain version there (1e-5 of the
    max); a raw kernel call refuses to drop a gradient silently, and
    inputs on two devices still raise."""
    gen = torch.Generator().manual_seed(2)
    x = _field(gen, (4, 37, 53), cuda)
    th = (torch.rand((37, 53), generator=gen) * 6.0).to(cuda)
    amp = torch.rand((37, 53), generator=gen).to(cuda)
    masks = torch.rand((10, 37, 53), generator=gen).to(cuda)
    w = _field(gen, (4, 37, 53), cuda)

    def project(out):
        return (w.real * out.real + w.imag * out.imag).sum()

    zero = dict.fromkeys(ops.KERNELS, 0)
    fns = {  # kernel path, plain path, launches of forward + backward
        "tf": (lambda a, t: ops.phase_tf_apply(a, t, amp),
               lambda a, t: ref.phase_tf_apply_ref(a, t[None], amp[None], 4),
               {**zero, "phase_tf_apply": 2}),
        "hop": (lambda a, t: ops.fused_spectral_hop(a, th, amp, t, amp),
                lambda a, t: torch.polar(amp, t) * torch.fft.ifft2(
                    torch.polar(amp, th) * torch.fft.fft2(a)),
                {**zero, "conj_phase_scale": 2, "phase_tf_apply": 2}),
        "k4": (lambda a, t: ops.phase_apply(a, t, 1.12),
               lambda a, t: ref.phase_apply_ref(a, t, 1.12),
               {**zero, "phase_apply": 2}),
    }
    for name, (kern, plain, launches) in fns.items():
        grads = []
        for fn in (kern, plain):
            a = x.clone().requires_grad_(True)
            t = th.clone().requires_grad_(True)
            ops.reset_launch_counts()
            grads.append(torch.autograd.grad(project(fn(a, t)), [a, t]))
            if fn is kern:
                assert ops.launch_counts() == launches, name
        torch.cuda.synchronize()
        for got, want in zip(*grads):
            assert _rel(got, want) <= 1e-5, name
    u = x.clone().requires_grad_(True)
    g = torch.rand((4, 10), generator=gen).to(cuda)
    (du,) = torch.autograd.grad((ops.intensity_readout(u, masks) * g).sum(),
                                u)
    u2 = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(
        (ref.intensity_readout_ref(u2, masks) * g).sum(), u2)
    assert _rel(du, want) <= 1e-5
    # K5 and K6: the Functions' backward launches the kernel again
    bplane = _field(gen, (37, 53), cuda)
    rx, rc, rs = _rope_inputs(gen, cuda, torch.float32)
    rw = torch.randn(rx.shape, generator=gen).to(cuda)
    fns = {
        "k5": (lambda a, b: project(ops.complex_mul(a, b)),
               lambda a, b: project(ref.complex_mul_ref(a, b)),
               (x, bplane), {**zero, "complex_mul": 2}),
        "k6": (lambda a: (rw * ops.apply_rope(a, rc, rs)).sum(),
               lambda a: (rw * ref.rope_ref(a.reshape(6, 37, 64), rc, rs)
                          .reshape(a.shape)).sum(),
               (rx,), {**zero, "rope": 2}),
    }
    for name, (kern, plain, inputs, launches) in fns.items():
        grads = []
        for fn in (kern, plain):
            args = [t.clone().requires_grad_(True) for t in inputs]
            ops.reset_launch_counts()
            grads.append(torch.autograd.grad(fn(*args), args))
            if fn is kern:
                assert ops.launch_counts() == launches, name
        torch.cuda.synchronize()
        for got, want in zip(*grads):
            assert _rel(got, want) <= 1e-5, name
    with pytest.raises(RuntimeError, match="records no gradient"):
        ops.phase_tf_apply_planes(x, th[None].requires_grad_(True),
                                  amp[None], 4)
    scan = _scan_inputs(gen, cuda)
    scan[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="records no gradient"):
        ops.selective_scan(*scan)  # forward only, as in the reference
    with pytest.raises(ValueError, match="inputs on"):
        ops.phase_tf_apply(x, torch.zeros((37, 53)), torch.ones((37, 53)))


def test_readout_is_deterministic_and_batch_independent(cuda):
    """K3 repeats to the bit, and a field's readout does not depend on the
    batch it is served in, at the edges of the tiling: H*W not a multiple
    of the tile (37x53), C = 1 and C = 17 (across the class chunk), B = 1
    and B = 33 (beyond one field group), and an 8-byte-aligned field.  Each
    within 1e-5 of the plain version."""
    gen = torch.Generator().manual_seed(1)
    for (B, H, W), C in (((9, 200, 200), 10), ((33, 200, 200), 10),
                         ((1, 200, 200), 10), ((9, 37, 53), 1),
                         ((9, 37, 53), 17)):
        u = _field(gen, (B, H, W), cuda)
        masks = torch.rand((C, H, W), generator=gen).to(cuda)
        a = ops.intensity_readout(u, masks)
        for _ in range(3):
            assert torch.equal(ops.intensity_readout(u, masks), a)
        assert _rel(a, ref.intensity_readout_ref(u, masks)) <= 1e-5
        # a field's readout does not depend on the batch it is served in
        # (at odd H*W, u[3:5] starts 8 bytes off a 16-byte boundary; at
        # B = 1 it is empty)
        assert torch.equal(ops.intensity_readout(u[3:5], masks), a[3:5])
        assert torch.equal(ops.intensity_readout(u[:1], masks), a[:1])
    # one field alone and inside batches of 8 and 32, at two positions
    u = _field(gen, (32, 200, 200), cuda)
    masks = torch.rand((10, 200, 200), generator=gen).to(cuda)
    alone = ops.intensity_readout(u[5:6].clone(), masks)[0]
    for batch, pos in ((u, 5), (u[:8], 5), (u[3:11], 2), (u[5:], 0)):
        assert torch.equal(ops.intensity_readout(batch, masks)[pos], alone)
    odd = _field(gen, (9, 37, 53), cuda)
    omasks = torch.rand((10, 37, 53), generator=gen).to(cuda)
    alone = ops.intensity_readout(odd[3:4].clone(), omasks)[0]
    for batch, pos in ((odd, 3), (odd[3:4], 0), (odd[1:], 2)):
        assert torch.equal(ops.intensity_readout(batch, omasks)[pos], alone)


def test_selective_scan_at_general_a_repeats_and_is_batch_independent(cuda):
    """K7 within 1e-5 of its plain version at general A for N 1, 4, 16 and
    32 (states padded to NP 1, 4, 16, 32), D 203 (4-byte copies, a ragged
    last block) and D 260 (16-byte copies, a partial last block), and S of
    1, 17 and 2 * 16 + 3 (the kernel's tile is 16 steps); to the bit on a
    repeat call; and each batch row computed alone equals it inside the
    batch of 3, since rows are independent.  One launch a call."""
    gen = torch.Generator().manual_seed(5)
    ops.reset_launch_counts()
    calls = 0
    for N in (1, 4, 16, 32):
        for S in (1, 17, 35):
            for D in (203, 260):
                args = _general_scan_inputs(gen, cuda, 3, S, D, N)
                got = ops.selective_scan(*args)
                assert _rel(got, ref.selective_scan_ref(*args)) <= 1e-5, \
                    (N, S, D)
                assert torch.equal(ops.selective_scan(*args), got), (N, S, D)
                for r in range(3):
                    alone = ops.selective_scan(*(
                        t[r:r + 1] if t.dim() == 3 else t for t in args))
                    assert torch.equal(alone, got[r:r + 1]), (N, S, D, r)
                calls += 5
    torch.cuda.synchronize()
    assert ops.launch_counts()["selective_scan"] == calls


def test_complex_mul_at_odd_sizes_and_misaligned_views(cuda):
    """K5 against its plain version (1e-5 of the max) where its float4
    pairs meet an edge: odd H*W (a pair straddles two fields, a lone last
    element), a[1:] and a[1:3] of an odd-H*W batch (a start 8 bytes off
    16, lone first and last elements), a plane b 8 bytes off 16, and one
    launch counted each."""
    gen = torch.Generator().manual_seed(3)
    odd = _field(gen, (6, 37, 53), cuda)
    planes = _field(gen, (2, 37, 53), cuda)
    cases = [(odd[:5], planes[0]), (odd[1:], planes[0]),
             (odd[1:3], planes[1]), (odd[2:3].clone(), planes[1]),
             (_field(gen, (3, 1, 1), cuda)[1:], _field(gen, (1, 1), cuda)),
             (_field(gen, (32, 200, 200), cuda), _field(gen, (200, 200),
                                                        cuda))]
    ops.reset_launch_counts()
    for a, b in cases:
        got = ops.complex_mul_rows(a, b)
        assert _rel(got, ref.complex_mul_ref(a, b)) <= 1e-5
    assert ops.launch_counts()["complex_mul"] == len(cases)


def test_serving_slice_on_the_card_matches_cpu(cuda):
    model = build_model(CFG, device=cuda)
    params = model.init(torch.Generator().manual_seed(0))
    cpu_model = build_model(CFG, device="cpu")
    cpu_params = {"phase": {k: v.cpu() for k, v in params["phase"].items()}}
    x = np.random.default_rng(0).random((5, 28, 28), np.float32)
    for dtype, rfft in (("float32", False), ("int8", True)):
        eng = InferenceEngine(freeze(model, params, dtype, rfft),
                              buckets=(1, 4), device=cuda)
        ops.reset_launch_counts()
        got = eng.infer(x)
        mb = MicroBatcher(eng, max_wait_ms=2.0)
        singles = np.stack([f.result(timeout=60)
                            for f in [mb.submit(xi) for xi in x]])
        assert mb.close(timeout=30)
        counts = ops.launch_counts()
        for k in ("phase_apply", "complex_mul", "rope", "selective_scan",
                  "transfer_planes"):
            assert counts.pop(k) == 0  # not on the frozen serving path
        assert min(counts.values()) > 0, counts
        want = freeze(cpu_model, cpu_params, dtype, rfft,
                      device="cpu").forward(torch.from_numpy(x)).numpy()
        scale = np.max(np.abs(want))
        assert np.max(np.abs(got - want)) <= 1e-4 * scale
        assert np.max(np.abs(singles - want)) <= 1e-4 * scale
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


_PLAIN_VERSIONS = ("conj_phase_scale_ref", "phase_tf_apply_ref",
                   "intensity_readout_ref", "phase_apply_ref",
                   "complex_mul_ref", "rope_ref", "selective_scan_ref",
                   "transfer_planes_ref")


def _forbid_plain_versions(monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("a plain version ran on a CUDA tensor")

    for fn in _PLAIN_VERSIONS:
        monkeypatch.setattr(ref, fn, forbidden)


def test_channel_readout_launches_k3_never_plain_version(cuda, monkeypatch):
    """The RGB detector: K3 over the B*C rows (one launch), then the
    channel sum; it repeats to the bit."""
    gen = torch.Generator().manual_seed(5)
    u = _field(gen, (4, 3, 37, 53), cuda)
    masks = torch.rand((6, 37, 53), generator=gen).to(cuda)
    want = ops.channel_intensity_readout(u.cpu(), masks.cpu())
    _forbid_plain_versions(monkeypatch)
    ops.reset_launch_counts()
    got = ops.channel_intensity_readout(u, masks)
    torch.cuda.synchronize()
    assert ops.launch_counts()["intensity_readout"] == 1
    assert got.shape == (4, 6) and _rel(got, want) <= 1e-5
    assert torch.equal(ops.channel_intensity_readout(u, masks), got)


def test_rgb_plane_stack_goes_through_k1(cuda, monkeypatch):
    """The RGB scan engine runs its (L, C, N, N) phase stack through K1 on
    the card (two launches a layer), K2 on the final hop and K3 once, and
    agrees with its CPU copy; the eager engine runs K4, one (N, N) plane
    per channel and layer."""
    cfg = dataclasses.replace(CFG, channels=3, num_classes=6)
    x = np.random.default_rng(0).random((4, 3, 28, 28), np.float32)
    for engine, launches in (
            ("scan", {"conj_phase_scale": 2 * cfg.depth,
                      "phase_tf_apply": 1, "intensity_readout": 1}),
            ("eager", {"phase_apply": 3 * cfg.depth,
                       "intensity_readout": 1})):
        ecfg = dataclasses.replace(cfg, engine=engine)
        model = build_model(ecfg, device=cuda)
        params = model.init(torch.Generator().manual_seed(0))
        want = build_model(ecfg, device="cpu").apply(
            tree_map(lambda t: t.cpu(), params), torch.from_numpy(x))
        with monkeypatch.context() as m:
            _forbid_plain_versions(m)
            ops.reset_launch_counts()
            got = model.apply(params, torch.from_numpy(x).to(cuda))
            torch.cuda.synchronize()
            counts = ops.launch_counts()
        assert counts == {**dict.fromkeys(ops.KERNELS, 0), **launches}
        assert _rel(got, want) <= 1e-4


def test_families_serve_on_the_card_like_cpu(cuda):
    """Frozen RGB, segmentation and heterogeneous serving on the card
    against the same deployments on CPU copies (1e-4 of the max)."""
    kws = {
        "multi": dict(channels=3, num_classes=6),
        "seg": dict(segmentation=True, skip_from=0, layer_norm=True),
        "hetero": dict(n=40, layers=(
            LayerSpec(0.05, size=40), LayerSpec(0.05, size=32,
                                                pixel_size=48e-6))),
    }
    for family, kw in kws.items():
        cfg = dataclasses.replace(CFG, **kw)
        model = build_model(cfg, device=cuda)
        params = model.init(torch.Generator().manual_seed(0))
        shape = (5, 3, 28, 28) if family == "multi" else (5, 28, 28)
        x = np.random.default_rng(1).random(shape, np.float32)
        eng = InferenceEngine(freeze(model, params), buckets=(1, 4),
                              device=cuda)
        got = eng.infer(x)
        want = freeze(build_model(cfg, device="cpu"),
                      tree_map(lambda t: t.cpu(), params),
                      device="cpu").forward(torch.from_numpy(x)).numpy()
        assert np.max(np.abs(got - want)) <= 1e-4 * np.max(np.abs(want)), \
            family


def test_lm_smoke_configs_on_the_card_match_cpu(cuda):
    """qwen1.5-4b and falcon-mamba-7b smoke configs in float32: prefill
    logits and decode steps on the card against CPU copies (1e-5 of the
    max), K6 through apply_rotary on the served q, and serve.main."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in ("qwen1.5-4b", "falcon-mamba-7b"):
        cfg = dataclasses.replace(lm_config(arch, smoke=True),
                                  dtype=torch.float32)
        params = lm.init(cfg, torch.Generator(device=cuda).manual_seed(0))
        cpu = tree_map(lambda t: t.cpu(), params)
        toks = torch.from_numpy(
            np.random.default_rng(0).integers(0, cfg.vocab, (2, 12)))
        got = lm.logits_fn(params, toks.to(cuda), cfg)
        want = lm.logits_fn(cpu, toks, cfg)
        assert _rel(got, want) <= 1e-5, arch
        cache = lm.init_cache(cfg, 2, 16, device=cuda)
        dec = []
        for t in range(12):
            logits, cache = lm.decode_step(params, cache,
                                           toks[:, t:t + 1].to(cuda), t, cfg)
            dec.append(logits[:, 0])
        assert _rel(torch.stack(dec, 1), want) <= 1e-4, arch
    cfg = lm_config("qwen1.5-4b", smoke=True)
    q = torch.randn((2, 12, cfg.n_heads, cfg.head_dim)).to(cuda, cfg.dtype)
    cos, sin = rope_angles(cfg, torch.arange(12, device=cuda))
    ops.reset_launch_counts()
    k6 = apply_rotary(q, cos, sin, cfg, use_pallas=True)
    assert ops.launch_counts()["rope"] == 1
    plain = apply_rotary(q, cos, sin, cfg)
    assert _rope_bound_ok(k6.transpose(1, 2), plain.transpose(1, 2),
                          q.transpose(1, 2), cos.to(q.dtype), sin.to(q.dtype))
    assert serve.main(["--arch", "falcon-mamba-7b", "--smoke", "--slots", "2",
                       "--requests", "3", "--prompt-len", "3", "--max-new",
                       "4", "--device", "cuda"]) == 12


def _no_plane_major(monkeypatch):
    def forbidden(*a, **k):
        raise AssertionError("a plane-major transpose on the batched path")

    monkeypatch.setattr(ops, "_plane_major", forbidden)


def test_emulate_batch_runs_k_major_slabs_through_the_kernels(cuda,
                                                              monkeypatch):
    """K candidates of each family as one candidate-major field: the set's
    planes in one build, K1 twice a layer and K2 once for all K (the final
    hop; segmentation's skip hop is a second K2), K3 once over the K*B
    (K*C*B) rows, never a plain version or a plane-major transpose;
    against the same call on CPU copies."""
    from repro_torch.core.models import clear_emulation_caches, emulate_batch

    geos = [(36e-6, 0.05), (30e-6, 0.04), (40e-6, 0.06)]
    cases = {
        "cls": (dict(), (4, 28, 28), dict(phase_tf_apply=1,
                                          intensity_readout=1)),
        "rgb": (dict(channels=3, num_classes=6), (4, 3, 28, 28),
                dict(phase_tf_apply=1, intensity_readout=1)),
        "seg": (dict(segmentation=True, skip_from=0, layer_norm=True),
                (4, 28, 28), dict(phase_tf_apply=2)),
    }
    for family, (kw, shape, launches) in cases.items():
        cfgs = [dataclasses.replace(CFG, pixel_size=ps, distance=D, **kw)
                for ps, D in geos]
        model = build_model(cfgs[0], device=cuda)
        params = [model.init(torch.Generator().manual_seed(k))
                  for k in range(3)]
        x = np.random.default_rng(2).random(shape, np.float32)
        kwargs = dict(train=True) if family == "seg" else {}
        want = emulate_batch(cfgs, [tree_map(lambda t: t.cpu(), p)
                                    for p in params], x, device="cpu",
                             **kwargs)
        # the families share their geometry: each builds its own set
        clear_emulation_caches()
        with monkeypatch.context() as m:
            _forbid_plain_versions(m)
            _no_plane_major(m)
            ops.reset_launch_counts()
            got = emulate_batch(cfgs, params, x, device=cuda, **kwargs)
            torch.cuda.synchronize()
            counts = ops.launch_counts()
        assert counts == {**dict.fromkeys(ops.KERNELS, 0),
                          "conj_phase_scale": 2 * CFG.depth,
                          "transfer_planes": 1, **launches}, family
        assert _rel(got, want) <= 1e-4, family


def _transfer(a, b, polar: bool) -> torch.Tensor:
    a, b = a.double(), b.double()
    return b * torch.exp(1j * a) if polar else torch.complex(a, b)


def test_transfer_planes_kernel_matches_its_plain_version(cuda):
    """A DSE sweep's candidate set (K=32 geometries, L+1=6 gaps, 200x200)
    in one launch, both conventions and both methods, against the plain
    version in f64 on the card and against the host's numpy planes: H
    within 1e-6 (theta is compared through amp exp(j theta)); it repeats
    to the bit.  Then a sub-half-wavelength pitch, whose planes reach the
    evanescent decay, with and without the band limit and under pad."""
    from repro_torch.core import diffraction as df
    from repro_torch.core import propagation as pp

    rng = np.random.default_rng(29)
    K, G = 32, 6
    sweep = np.column_stack([rng.uniform(8e-6, 56e-6, K), np.full(K, 532e-9)]
                            + [rng.uniform(0.1, 0.5, K)] * G)
    tiny = np.array([[2e-7, 532e-9, 1e-6, 3e-6]])
    # (geometry, field size, pad, method, band limit, polar)
    cases = [(sweep, 200, False, m, True, polar) for m in ("rs", "fresnel")
             for polar in (True, False)]
    cases += [(tiny, 48, pad, "rs", bl, polar) for pad in (False, True)
              for bl in (True, False) for polar in (True, False)]
    for geo, n, pad, method, bl, polar in cases:
        N = 2 * n if pad else n
        Kc = geo.shape[0]
        t = torch.tensor(geo, dtype=torch.float64, device=cuda)
        ops.reset_launch_counts()
        a, b = ops.transfer_planes_batched(t, N, method, bl, polar)
        torch.cuda.synchronize()
        assert ops.launch_counts()["transfer_planes"] == 1
        assert a.shape == (Kc * (geo.shape[1] - 2), N, N)
        got = _transfer(a, b, polar)
        want = _transfer(*ref.transfer_planes_ref(t, N, method, bl, polar),
                         polar)
        what = (N, method, bl, polar)
        assert float((got - want).abs().max()) <= 1e-6, what
        again = ops.transfer_planes_batched(t, N, method, bl, polar)
        assert torch.equal(again[0], a) and torch.equal(again[1], b), what
        for k in (0, Kc - 1):
            for g in (0, geo.shape[1] - 3):
                h = pp.transfer_planes(df.Grid(n, geo[k, 0]), geo[k, 2 + g],
                                       geo[k, 1], method, bl, pad)
                host = torch.from_numpy(h["hr"].astype(np.float64)
                                        + 1j * h["hi"])
                row = got[g * Kc + k].cpu()
                assert float((row - host).abs().max()) <= 1e-6, (what, k, g)


def test_remat_backward_relaunches_exactly_the_forward_kernels(cuda):
    """A scan training step launches K1 2L, K2 2L and K3 once; ``remat``
    ("layer" or "segment") re-runs every layer's forward in the backward
    pass, 2L more K1 launches and nothing else, and the gradients equal
    the step without it."""
    cfg = dataclasses.replace(CFG, depth=3, codesign="gumbel",
                              device_levels=16)
    x = torch.from_numpy(
        np.random.default_rng(3).random((4, 28, 28), np.float32)).to(cuda)
    grads = {}
    for remat in ("none", "layer", "segment"):
        model = build_model(dataclasses.replace(cfg, remat=remat),
                            device=cuda)
        params = model.init(torch.Generator().manual_seed(0))
        leaves = [p.requires_grad_(True) for p in params["phase"].values()]
        gen = torch.Generator(device=cuda).manual_seed(4)
        ops.reset_launch_counts()
        loss = model.apply(params, x, gen).square().sum()
        grads[remat] = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        L = cfg.depth
        assert ops.launch_counts() == {
            **dict.fromkeys(ops.KERNELS, 0),
            "conj_phase_scale": 2 * L + (0 if remat == "none" else 2 * L),
            "phase_tf_apply": 2 * L, "intensity_readout": 1}, remat
    for remat in ("layer", "segment"):
        for g, g0 in zip(grads[remat], grads["none"]):
            assert _rel(g, g0) <= 1e-6, remat


def test_load_deployed_lands_on_the_card_and_serves_through_k1_k3(
        cuda, tmp_path, monkeypatch):
    """A CPU-written artifact cold-starts on the card with no device given:
    planes, source and engine there; a batch launches K1 2L, K2 once and
    K3 once and no plain version; the output equals the CPU's within 1e-4
    and the in-memory deployment's on the card bit for bit."""
    model = build_model(CFG, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    x = np.random.default_rng(1).random((4, 28, 28), np.float32)
    for dtype in ("float32", "bfloat16", "int8"):
        cpu_dep = freeze(model, params, dtype, device="cpu")
        save_deployed(cpu_dep, tmp_path / dtype)
        dep = load_deployed(tmp_path / dtype)
        assert dep.device == cuda and dep.plane_dtype == dtype
        assert all(t.is_cuda for t in dep.frozen) and dep.source.is_cuda
        eng = InferenceEngine(dep, buckets=(4,))
        with monkeypatch.context() as m:
            _forbid_plain_versions(m)
            ops.reset_launch_counts()
            got = eng.infer(x)
            torch.cuda.synchronize()
            assert ops.launch_counts() == {
                **dict.fromkeys(ops.KERNELS, 0),
                "conj_phase_scale": 2 * CFG.depth, "phase_tf_apply": 1,
                "intensity_readout": 1}, dtype
        want = cpu_dep.forward(torch.from_numpy(x)).numpy()
        assert np.max(np.abs(got - want)) <= 1e-4 * np.max(np.abs(want))
        gpu_model = build_model(CFG, device=cuda)
        gpu_params = tree_map(lambda t: t.to(cuda), params)
        mem = InferenceEngine(freeze(gpu_model, gpu_params, dtype),
                              buckets=(4,)).infer(x)
        np.testing.assert_array_equal(got, mem)


def test_fleet_replicas_on_one_card_fail_over_bitwise(cuda, tmp_path):
    """Two replicas of one deployment on one card: a replica killed
    mid-run gives zero drops with every output equal to the reference
    engine's bit for bit (one bucket)."""
    model = build_model(CFG, device=cuda)
    dep = freeze(model, model.init(torch.Generator().manual_seed(0)))
    xs = np.random.default_rng(2).random((64, 28, 28), np.float32)
    ref_out = InferenceEngine(dep, buckets=(8,)).infer(xs)
    engines = [InferenceEngine(dep, buckets=(8,)) for _ in range(2)]
    for e in engines:
        e.warmup()
    router = FleetRouter([FlakyEngine(e) for e in engines], seed=0,
                         backoff_base_ms=1.0)
    try:
        futs = [router.submit(x) for x in xs]
        kill_replica(router)
        outs = np.stack([f.result(timeout=60) for f in futs])
    finally:
        assert router.close()
    np.testing.assert_array_equal(outs, ref_out)
    assert router.stats()["failed"] == 0


def test_engine_sees_plane_writes_the_caller_queued(cuda):
    """Plane writes the caller queued behind a long kernel, with no
    synchronize, are seen by the engine's next batch: the outputs are the
    new planes'."""
    model = build_model(CFG, device=cuda)
    dep = freeze(model, model.init(torch.Generator().manual_seed(0)))
    new = freeze(model, model.init(torch.Generator().manual_seed(1)))
    x = np.random.default_rng(3).random((4, 28, 28), np.float32)
    eng = InferenceEngine(dep, buckets=(4,))
    old_out = eng.infer(x)
    want = InferenceEngine(new, buckets=(4,)).infer(x)
    assert not np.array_equal(old_out, want)
    torch.cuda.synchronize()
    torch.cuda._sleep(1 << 30)  # holds the default stream for ~0.5 s
    for t, u in zip(dep.frozen, new.frozen):
        t.copy_(u)
    assert not torch.cuda.current_stream(cuda).query()
    np.testing.assert_array_equal(eng.infer(x), want)


def test_lm_train_step_on_the_card_launches_no_kernel(cuda):
    """Smoke train steps of the dense and ssm families on the card launch
    none of K1-K7 (the reference's LM training path reaches no Pallas
    kernel either: RoPE without ``use_pallas``, the chunked plain scan);
    the loss and the grad norm match a CPU copy's step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for arch in ("qwen1.5-4b", "falcon-mamba-7b"):
        cfg = dataclasses.replace(lm_config(arch, smoke=True),
                                  dtype=torch.float32)
        opt = AdamW(lr=3e-4, weight_decay=0.01, grad_clip_norm=1.0)
        state = lm_steps.init_train_state(
            cfg, torch.Generator(device=cuda).manual_seed(0), opt)
        cpu = tree_map(lambda t: t.cpu(), state)
        r = np.random.default_rng(0)
        batch = {k: torch.from_numpy(r.integers(0, cfg.vocab, (2, 12)))
                 for k in ("tokens", "labels")}
        step = lm_steps.make_train_step(cfg, opt, accum_steps=2)
        ops.reset_launch_counts()
        state, m = step(state, tree_map(lambda t: t.to(cuda), batch))
        torch.cuda.synchronize()
        assert set(ops.launch_counts().values()) == {0}, arch
        cpu, want = step(cpu, batch)
        for k, tol in (("loss", 1e-5), ("grad_norm", 1e-4)):
            assert abs(float(m[k]) - float(want[k])) <= tol * float(
                want[k]), (arch, k)
        assert all(torch.isfinite(t).all() for t in tree_leaves(state))
