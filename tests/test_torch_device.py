"""Hygiene and device rules of the port; CUDA-only kernel checks.

This file imports no JAX, so the CUDA-only tests run on a machine with a
card and PyTorch alone:

    PYTHONPATH=src python -m pytest tests/test_torch_device.py

Whether a card is present is decided inside the ``cuda`` fixture at test
time; without one those tests skip with a reason.
"""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.core.config import DONNConfig  # noqa: E402
from repro_torch.core.models import DONN, build_model  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch import serve_donn  # noqa: E402
from repro_torch.runtime.inference import (  # noqa: E402
    InferenceEngine, MicroBatcher, freeze,
)

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


def test_port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    bad = []
    for f in files:
        for line, mod in _imports(f):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro", "flax", "optax"):
                bad.append(f"{f.relative_to(REPO)}:{line} imports {mod}")
    assert not bad, "\n".join(bad)


def _entry_points():
    model = lambda: build_model(CFG)  # noqa: E731
    return {
        "build_model": model,
        "DONN": lambda: DONN(CFG),
        "params_from_jax": lambda: params_from_jax(
            {"phase": {"layer_0": np.zeros((2, 2), np.float32)}}),
        "serve_donn": lambda: serve_donn.main(["--n", "32", "--depth", "2",
                                               "--requests", "4"]),
    }


@pytest.mark.parametrize("name", ["build_model", "DONN", "params_from_jax",
                                  "serve_donn"])
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


def test_wrappers_launch_kernels_never_plain_versions(cuda, monkeypatch):
    gen = torch.Generator().manual_seed(0)
    x = _field(gen, (4, 3, 37, 53), cuda)
    th = torch.rand((3, 37, 53), generator=gen).to(cuda) * 6.0
    amp = torch.rand((3, 37, 53), generator=gen).to(cuda)
    masks = torch.randn((10, 37, 53), generator=gen).to(cuda)
    want = {
        "hop": ops.fused_spectral_hop(x.cpu(), th.cpu(), amp.cpu(), th.cpu(),
                                      amp.cpu()),
        "tf": ops.phase_tf_apply(x.cpu(), th.cpu(), amp.cpu()),
        "readout": ops.intensity_readout(x.cpu(), masks.cpu()),
    }

    def forbidden(*a, **k):
        raise AssertionError("a plain version ran on a CUDA tensor")

    for fn in ("conj_phase_scale_ref", "phase_tf_apply_ref",
               "intensity_readout_ref"):
        monkeypatch.setattr(ref, fn, forbidden)
    ops.reset_launch_counts()
    got = {
        "hop": ops.fused_spectral_hop(x, th, amp, th, amp),
        "tf": ops.phase_tf_apply(x, th, amp),
        "readout": ops.intensity_readout(x, masks),
    }
    torch.cuda.synchronize()
    assert ops.launch_counts() == {"conj_phase_scale": 2,
                                   "phase_tf_apply": 1,
                                   "intensity_readout": 1}
    for k in want:
        assert got[k].device.type == "cuda"
        assert _rel(got[k], want[k]) <= 1e-5, k


def test_kernels_refuse_inputs_that_require_grad(cuda):
    x = torch.ones((2, 8, 8), dtype=torch.complex64, device=cuda)
    th = torch.zeros((8, 8), device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="forward only"):
        ops.phase_tf_apply(x, th, torch.ones((8, 8), device=cuda))
    with pytest.raises(ValueError, match="inputs on"):
        ops.phase_tf_apply(x, torch.zeros((8, 8)), torch.ones((8, 8)))


def test_readout_is_deterministic_and_batch_independent(cuda):
    gen = torch.Generator().manual_seed(1)
    u = _field(gen, (9, 200, 200), cuda)
    masks = torch.rand((10, 200, 200), generator=gen).to(cuda)
    a = ops.intensity_readout(u, masks)
    for _ in range(3):
        assert torch.equal(ops.intensity_readout(u, masks), a)
    # a field's readout does not depend on the batch it is served in
    assert torch.equal(ops.intensity_readout(u[3:5], masks), a[3:5])


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
        assert min(counts.values()) > 0, counts
        want = freeze(cpu_model, cpu_params, dtype, rfft,
                      device="cpu").forward(torch.from_numpy(x)).numpy()
        scale = np.max(np.abs(want))
        assert np.max(np.abs(got - want)) <= 1e-4 * scale
        assert np.max(np.abs(singles - want)) <= 1e-4 * scale
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
