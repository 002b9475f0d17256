"""The yardstick's counts against hand counts, and each per-layer
reader on a trace made up for it."""
import math
import types

import pytest

from portbench.counts import donn, kernels, peaks
from portbench.harness import spec
from portbench.harness.trace import TraceData


def test_model_flops_by_hand():
    # n = 4: 16 points, log2 16 = 4 -> 5 * 16 * 4 = 320 a transform
    assert donn.fft2_flops(4) == 320.0
    hop = 2 * 320 + 6 * 16
    layer = hop + 6 * 16
    readout = 3 * 16 + 2 * 1 * 1
    assert donn.forward_flops(4, 3, 2, 1) == 3 * layer + hop + readout
    assert donn.train_flops(4, 3, 2, 1) == 3 * donn.forward_flops(4, 3, 2, 1)


def test_donn_xl_500_sample_is_about_1_48_gflop():
    f = donn.forward_flops(500, 30, 10, 40)
    assert 1.47e9 < f < 1.49e9
    assert 4.4e9 < donn.train_flops(500, 30, 10, 40) < 4.5e9


def test_kernel_launch_costs_by_hand():
    _, plane_cost, _ = kernels.ENTRY_POINTS["conj_phase_scale"]
    flops, nbytes = plane_cost(((6, 3, 5), (2, 3, 5), (2, 3, 5)))
    assert nbytes == 2 * 8 * 6 * 15 + 2 * 4 * 2 * 15
    assert flops == 6 * 6 * 15 + 3 * 2 * 15
    _, readout, _ = kernels.ENTRY_POINTS["intensity_readout_rows"]
    flops, nbytes = readout(((4, 3, 5), (10, 3, 5)))
    assert nbytes == 8 * 4 * 15 + 4 * 10 * 15 + 4 * 4 * 10
    assert flops == 4 * 15 * (3 + 2 * 10)


@pytest.mark.parametrize("function,shape,dims,flops,nbytes", [
    ("fft2", (2, 4, 8), (-2, -1), 2 * 5 * 32 * 5, 2 * 8 * 64),
    ("ifft", (3, 16), (-1,), 3 * 5 * 16 * 4, 2 * 8 * 48),
    ("rfft2", (4, 8), (-2, -1), 2.5 * 32 * 5, 4 * 32 + 8 * 20),
    ("irfft2", (4, 5), (-2, -1), 2.5 * 32 * 5, 8 * 20 + 4 * 32),
])
def test_fft_costs_by_hand(function, shape, dims, flops, nbytes):
    assert kernels.fft_cost(function, shape, dims) == (flops, nbytes)


def test_bound_is_the_larger_term():
    assert peaks.bound_s(67e12, 0.0) == pytest.approx(1.0)
    assert peaks.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(67e12, 6.7e12) == pytest.approx(2.0)


def _trace(**kw):
    base = dict(window_s=2.0, busy_s=1.5, device_time_us={}, launches={},
                launch_counts={}, ffts=[], idle_gaps=[])
    base.update(kw)
    return TraceData(**base)


def _read(name, trace):
    return spec.metric_reader(name).read(trace, {"name": name}, None)


def test_idle_share_and_mfu():
    t = _trace(readings={"model_flops": 67e12 * 0.1})
    assert _read("idle_share.train", t) == pytest.approx(25.0)
    assert _read("mfu.train", t) == pytest.approx(5.0)
    idle = _trace(busy_s=0.0, readings={"model_flops": 1.0})
    assert _read("idle_share.serve", idle) is None
    assert _read("mfu.serve", idle) is None


def test_mfu_divides_by_the_peak_the_driver_hands_it():
    flops = 989.4e12 * 0.1  # a tenth of the bf16 peak over the 2 s window
    bf16 = _trace(readings={"model_flops": flops,
                            "peak_flops": peaks.BF16_FLOPS})
    assert _read("mfu.train", bf16) == pytest.approx(5.0)
    f32 = _trace(readings={"model_flops": flops})  # as the DONN drivers
    assert _read("mfu.train", f32) == pytest.approx(
        100.0 * flops / (2.0 * 67e12))
    assert peaks.BF16_FLOPS == 989.4e12 and peaks.F32_FLOPS == 67e12


def test_entry_points_merge_cost_files(tmp_path):
    assert kernels.ENTRY_POINTS == kernels.KERNELS  # no cost file yet
    (tmp_path / "kernels_made_up.py").write_text(
        "from portbench.counts.kernels import F32\n"
        "ENTRY_POINTS = {'made_up': (('made_up_kernel',),\n"
        "                 lambda shapes: (1.0, F32), 'made_up')}\n")
    (tmp_path / "other.py").write_text("ENTRY_POINTS = {'other': None}\n")
    files = kernels.cost_files(tmp_path)
    assert [m.__name__ for m in files] == ["portbench.counts.kernels_made_up"]
    merged = kernels.entry_points(files)
    assert set(merged) == set(kernels.KERNELS) | {"made_up"}
    assert merged["made_up"][1](()) == (1.0, 4)
    assert merged["conj_phase_scale"] is kernels.KERNELS["conj_phase_scale"]
    clash = types.ModuleType("portbench.counts.kernels_clash")
    clash.ENTRY_POINTS = {"intensity_readout_rows": (("x",), None, "x")}
    with pytest.raises(ValueError, match="intensity_readout_rows"):
        kernels.entry_points(files + [clash])


def test_kernel_roofline_reads_only_counted_launches():
    shapes = ((32, 200, 200), (1, 200, 200), (1, 200, 200))
    one = peaks.bound_s(*kernels.ENTRY_POINTS["conj_phase_scale"][1](shapes))
    t = _trace(launches={"conj_phase_scale": [shapes] * 4},
               launch_counts={"conj_phase_scale": 4},
               device_time_us={"conj_phase_scale_kernel(float2 const*)":
                               4 * one * 2e6})
    assert _read("kernel_roofline.emulate", t) == pytest.approx(50.0)
    t.launch_counts["conj_phase_scale"] = 5  # a launch the wrapper missed
    assert _read("kernel_roofline.emulate", t) is None


def test_fft_roofline():
    one = peaks.bound_s(*kernels.fft_cost("fft2", (32, 500, 500), (-2, -1)))
    t = _trace(ffts=[("fft2", (32, 500, 500), (-2, -1))] * 3,
               device_time_us={"void regular_fft<500u>": 3 * one * 4e6})
    assert _read("fft_roofline.serve", t) == pytest.approx(25.0)
    assert _read("fft_roofline.serve", _trace()) is None


def test_layer_readers():
    t = _trace(readings={"requests": 96, "batches": 3,
                         "dispatch_s_per_step": [0.01, 0.03],
                         "set_call_s": [[0.3, 0.1, 0.1], [0.2, 0.1], [0.5]],
                         "tf_misses": 64, "sets": 2})
    assert _read("serve.rows_per_batch", t) == 32
    assert _read("train.dispatch_ms", t) == pytest.approx(20.0)
    assert _read("dse.new_set_ms", t) == pytest.approx(150.0)
    assert _read("dse.tf_misses_per_set", t) == 32
    empty = _trace()
    for name in ("serve.rows_per_batch", "train.dispatch_ms",
                 "dse.new_set_ms", "dse.tf_misses_per_set"):
        assert _read(name, empty) is None


def test_gap_labels_name_the_open_span():
    from portbench.harness.trace import _label_gaps

    host = [(0.0, 100.0, "portbench.dse.call"), (10.0, 20.0, "cudaMalloc")]
    gaps = [(15.0, 1e-5), (50.0, 2e-5), (200.0, 3e-5)]
    labels = dict(_label_gaps(gaps, host))
    assert labels == {"portbench.dse.call / cudaMalloc": 1e-5,
                      "portbench.dse.call / host code": 2e-5,
                      "port / host code": 3e-5}
    assert math.isclose(sum(labels.values()), 6e-5)
