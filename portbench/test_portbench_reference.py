"""The plain DONN classifier reference (``reference/donn.py``) against
the port on the CPU (``use_pallas`` off), over the configurations whose
file names it: the same physics from the same configuration, worked out
apart.  A configuration that names another reference ``<ref>`` is held
to it by ``test_portbench_reference_<ref>.py``."""
import json

import numpy as np
import pytest
import torch

from portbench.harness import images, program, spec
from portbench.reference import donn as ref

FILES = {c["name"]: json.loads((spec.ROOT / c["file"]).read_text())
         for c in spec.load_benchmark()["configs"]}
CONFIGS = {name: raw for name, raw in FILES.items()
           if raw["reference"] == "donn"}


def _fields(name, smoke=False):
    raw = CONFIGS[name]
    out = {k: v for k, v in raw.items() if k not in spec.CONFIG_META}
    if smoke:
        out.update(raw["smoke"])
    return out


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_transfer_plane_and_detector_match_the_port(name):
    from repro_torch.core import diffraction as df
    from repro_torch.core import propagation as pp
    from repro_torch.core.layers import Detector

    f = _fields(name)
    for dx, z in ((f["pixel_size"], f["distance"]), (8e-6, 0.5), (5.6e-5, 0.1)):
        want = pp.cached_transfer_function(df.Grid(f["n"], dx), z,
                                           f["wavelength"])
        got = ref.transfer_function(f["n"], dx, z, f["wavelength"])
        assert np.abs(got - want).max() < 1e-6  # complex64 rounding apart
    det = Detector(df.Grid(f["n"], f["pixel_size"]), f["num_classes"],
                   f["det_size"], device="cpu")
    assert np.array_equal(ref.detector_masks(f["n"], f["num_classes"],
                                             f["det_size"]), det.masks)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_logits_match_the_port(name):
    from repro_torch.core.models import build_model

    f = _fields(name, smoke=True)
    x, _ = images.glyphs(6, seed=3, size=f["input_size"])
    phases = program.phases(3, 0, (f["depth"], f["n"], f["n"]), "cpu")
    model = build_model(program.donn_config(f), device="cpu")
    want = model.apply(program.as_params(phases), torch.from_numpy(x))
    got = ref.Classifier(f, "cpu").infer(phases, torch.from_numpy(x), block=4)
    assert program.row_gap(got, want) < 1e-5


def test_qat_holds_the_nearest_level():
    f = {"codesign": "qat", "device_levels": 4, "response_gamma": 1.0}
    phi = torch.tensor([0.1, 1.4, -0.2, 7.0, 3.0])
    held = ref.device_phase(phi, f)
    step = 2 * np.pi / 4
    assert torch.allclose(held, torch.tensor([0.0, step, 0.0, 0.0, 2 * step]),
                          atol=1e-6)


def test_training_steps_match_the_port():
    """Three AdamW steps of the port's chunk driver against the
    reference's, from the same weights on the same batches."""
    from repro_torch.core.models import build_model
    from repro_torch.core.train_utils import make_train_chunk
    from repro_torch.optim import AdamW

    fields = _fields("donn-xl-500", smoke=True)
    f = program.donn_config(fields)
    opt = {"lr": 0.01, "b1": 0.9, "b2": 0.999, "eps": 1e-8,
           "weight_decay": 0.0}
    x, y = images.glyphs(12, seed=5)
    xs, ys = x.reshape(3, 4, 28, 28), y.reshape(3, 4)
    p0 = program.phases(5, 0, (f.depth, f.n, f.n), "cpu")
    model = build_model(f, device="cpu")
    chunk = make_train_chunk(model, AdamW(**opt), f.num_classes)
    params = program.as_params(p0.clone())
    params, _, losses, _ = chunk(params, AdamW(**opt).init(params), 0, xs, ys)
    want = ref.train(ref.Classifier(fields, "cpu"), p0,
                     [(torch.from_numpy(a), torch.from_numpy(b))
                      for a, b in zip(xs, ys)], opt)
    assert np.allclose(losses.numpy(), want["losses"], rtol=1e-5)
    change = program.leaf_stack(params) - p0
    assert torch.allclose(change.flatten(1).norm(dim=1),
                          want["change"].flatten(1).norm(dim=1), rtol=1e-4)


def test_images_are_fixed_by_the_seed_and_carry_unit_power():
    a, la = images.glyphs(40, seed=9, stream=1)
    b, lb = images.glyphs(40, seed=9, stream=1)
    c, _ = images.glyphs(40, seed=10, stream=1)
    assert np.array_equal(a, b) and np.array_equal(la, lb)
    assert not np.array_equal(a, c)
    assert np.allclose((a.astype(np.float64) ** 2).sum((1, 2)), 1.0)
    assert set(np.unique(la)) <= set(range(10))


def test_every_reference_a_configuration_names_has_its_tests():
    """No configuration joins without its reference and tests of it: the
    DONN classifier's are this file's, another reference ``<ref>``'s are
    in ``test_portbench_reference_<ref>.py``."""
    for name, raw in FILES.items():
        ref_name = raw["reference"]
        assert (spec.PACKAGE / "reference" / f"{ref_name}.py").exists(), name
        tests = spec.PACKAGE / (
            "test_portbench_reference.py" if ref_name == "donn"
            else f"test_portbench_reference_{ref_name}.py")
        assert tests.exists() and "\ndef test_" in tests.read_text(), name
