"""Each cell run end to end on the CPU at its configuration's and
traffic's smoke twins (``use_pallas`` off): the window, the reading of
the trace and the comparison with the reference.  A sound run is
correct; the control (the port's bfloat16 planes) and every fault the
cell's driver can plant make ``correct`` come out false."""
import json

import pytest

from portbench.harness import cell as runner
from portbench.harness import spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
SECONDS = 0.3


def _run(name, **kw):
    return runner.run_cell(name, 2_147_483_647, SECONDS, kw.pop("trace", False),
                           "cpu", smoke=True, guard=False, **kw)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = _run(name)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    cell = spec.resolve(name)
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert list(r)[-1] == "checks"
    json.dumps(r, allow_nan=False)


@pytest.mark.parametrize("name", CELLS)
def test_traced_run(name):
    r = _run(name, trace=True)
    assert r["correct"], r["checks"]
    names = {m["name"] for m in spec.resolve(name).per_layer}
    assert set(r["metrics"]) <= names
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(r, allow_nan=False)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    assert not _run(name, control=True)["correct"]


FAULTED = [(name, fault) for name in CELLS
           for fault in spec.driver_module(spec.resolve(name)).FAULTS]


@pytest.mark.parametrize("name,fault", FAULTED)
def test_planted_fault_is_not_correct(name, fault):
    assert not _run(name, fault=fault)["correct"]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(card, name):
    r = runner.run_cell(name, 7, 2.0, False, card)
    assert r["correct"], r["checks"]
    assert r["device"]["platform"] == "gpu"
