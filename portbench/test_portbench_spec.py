"""Every cell of BENCHMARK.json finds its files by name, and the file
keeps to the shape the benchmark's contract gives it."""
import json
import re

import pytest

from portbench.harness import spec

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_units_and_lines():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    for group in (names, CELLS, [c["name"] for c in BENCH["configs"]]):
        assert len(set(group)) == len(group)
        assert all(NAME.match(n) for n in group), group
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in BENCH["workloads"]]
                 + [c["why"] for c in BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}


def test_per_layer_metrics_move_what_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert "workloads" not in moved or cell in moved["workloads"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves(name):
    cell = spec.resolve(name)
    assert cell.chips == 1
    assert spec.driver_module(cell).Driver
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(spec.metric_reader(m["name"]).read)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_registered_config(entry):
    """The file holds the registered configuration with its overrides,
    and nothing of it is cut."""
    import dataclasses

    from repro_torch.configs.donn import get_config
    from repro_torch.core.config import DONNConfig

    raw = json.loads((spec.ROOT / entry["file"]).read_text())
    fields = {k: v for k, v in raw.items() if k not in spec.CONFIG_META}
    want = dataclasses.replace(get_config(raw["registered"]),
                               **raw["overrides"])
    assert DONNConfig(**fields) == want
    assert entry["reduced"] == raw["reduced"] == []
    assert entry["file"].startswith("portbench/")
    assert (spec.PACKAGE / "reference" / f"{raw['reference']}.py").exists()
