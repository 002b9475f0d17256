"""Every cell of BENCHMARK.json finds its files by name, and the file
keeps to the shape the benchmark's contract gives it."""
import json
import re

import pytest

from portbench.harness import program, spec

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


# what a language model's file may cut: depth, the chip's share of the
# experts, a slice of the vocabulary; a DONN's file cuts nothing
LM_CUTS = {"n_layers", "n_experts", "vocab"}


def check_config_file(entry: dict, root=spec.ROOT) -> None:
    """Fail unless the file of ``configs`` entry ``entry`` holds the port's
    registered configuration (its DONN registry, else
    ``repro_torch.models.config.get_config``) with the file's
    ``overrides``, and ``reduced`` lists exactly the numeric fields that
    the overrides lower, each one its family may cut.  ``reduced`` may
    also name keys of the file that are no field (a catalog model's own
    name for a cut size).  ``BENCHMARK.json``'s ``reduced`` is the
    file's."""
    import dataclasses

    from repro_torch.configs import donn
    from repro_torch.models.config import get_config

    raw = json.loads((root / entry["file"]).read_text())
    fields = {k: v for k, v in raw.items() if k not in spec.CONFIG_META}
    if raw["registered"] in donn.CONFIGS:
        registered = donn.get_config(raw["registered"])
        overrides, cuts = raw["overrides"], set()
        built = program.donn_config(fields)
    else:
        registered = get_config(raw["registered"])
        overrides, cuts = program.lm_fields(raw["overrides"]), LM_CUTS
        built = program.lm_config(fields)
    assert built == dataclasses.replace(registered, **overrides)
    lowered = {k for k, v in overrides.items()
               if isinstance(v, (int, float)) and not isinstance(v, bool)
               and v < getattr(registered, k)}
    assert lowered <= cuts, f"{sorted(lowered - cuts)} may not be cut"
    names = {f.name for f in dataclasses.fields(registered)}
    listed = set(raw["reduced"])
    assert listed & names == lowered, (sorted(listed), sorted(lowered))
    assert listed - names <= set(fields), sorted(listed - names - set(fields))
    assert len(listed) == len(raw["reduced"])
    assert entry["reduced"] == raw["reduced"]
    assert entry["file"].startswith("portbench/")


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file_is_the_registered_config(entry):
    """The file holds the registered configuration with its overrides,
    and cuts nothing but what its family may cut (a DONN's nothing)."""
    check_config_file(entry)
    raw = json.loads((spec.ROOT / entry["file"]).read_text())
    assert (spec.PACKAGE / "reference" / f"{raw['reference']}.py").exists()


def _made_up(tmp_path, registered, overrides, reduced, extra=None):
    """A configuration file under ``tmp_path`` and its ``configs`` entry."""
    import dataclasses

    from repro_torch.configs import donn
    from repro_torch.models.config import get_config

    if registered in donn.CONFIGS:
        cfg = dataclasses.replace(donn.get_config(registered), **overrides)
    else:
        cfg = dataclasses.replace(get_config(registered),
                                  **program.lm_fields(overrides))
    fields = {k: (str(v).removeprefix("torch.") if k == "dtype" else v)
              for k, v in dataclasses.asdict(cfg).items()}
    raw = {"registered": registered, "overrides": overrides,
           "reduced": reduced, "reference": "stub", **fields, **(extra or {})}
    path = tmp_path / "portbench" / "configs" / f"{registered}.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(raw))
    return {"name": registered, "file": f"portbench/configs/{path.name}",
            "reduced": reduced}


MADE_UP = {  # case -> (registered, overrides, reduced, extra keys, passes)
    "lm-cut-depth": ("mixtral-8x7b", {"n_layers": 8}, ["n_layers"], None,
                     True),
    "lm-cut-unlisted": ("mixtral-8x7b", {"n_layers": 8}, [], None, False),
    "lm-cut-width": ("mixtral-8x7b", {"n_layers": 8, "d_model": 2048},
                     ["n_layers", "d_model"], None, False),
    "lm-cut-listed-twice": ("mixtral-8x7b", {"n_layers": 8},
                            ["n_layers", "n_layers"], None, False),
    "lm-catalog-name": ("mixtral-8x7b", {"n_layers": 8, "dtype": "float32"},
                        ["n_layers", "num_hidden_layers"],
                        {"num_hidden_layers": 8}, True),
    "lm-unknown-name": ("mixtral-8x7b", {"n_layers": 8},
                        ["n_layers", "num_hidden_layers"], None, False),
    "lm-uncut": ("falcon-mamba-7b", {}, [], None, True),
    "donn-cut-depth": ("donn-mnist-5l", {"depth": 3}, ["depth"], None, False),
    "donn-cut-unlisted": ("donn-xl-500", {"n": 250}, [], None, False),
    "donn-uncut": ("donn-mnist-5l", {"use_pallas": True}, [], None, True),
}


@pytest.mark.parametrize("case", sorted(MADE_UP))
def test_config_file_check_on_made_up_files(tmp_path, case):
    registered, overrides, reduced, extra, passes = MADE_UP[case]
    entry = _made_up(tmp_path, registered, overrides, reduced, extra)
    if passes:
        check_config_file(entry, root=tmp_path)
    else:
        with pytest.raises(AssertionError):
            check_config_file(entry, root=tmp_path)


def test_lm_config_takes_dtype_names_and_leaves_other_keys_out():
    import torch

    from repro_torch.models.config import get_config

    want = get_config("mixtral-8x7b")
    fields = {k: getattr(want, k) for k in ("name", "family", "n_layers",
                                            "d_model", "n_heads",
                                            "n_kv_heads", "d_ff", "vocab")}
    got = program.lm_config({**fields, "dtype": "float32",
                             "hidden_size": 4096})
    assert got.dtype is torch.float32 and got.d_model == want.d_model
    with pytest.raises(ValueError):
        program.lm_fields({"dtype": "float_nothing"})
