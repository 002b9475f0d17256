"""Finding a cell's files by the names in ``BENCHMARK.json``.

- configuration ``<c>``: the file its ``configs`` entry names (under
  ``configs/``), holding the fields as run (a ``DONNConfig``'s or an
  ``LMConfig``'s), the registered name and overrides they come from, and
  a ``smoke`` twin for the CPU;
- traffic ``<t>``: ``traffic/<t>.json``, whose ``driver`` names the
  module ``drivers/<driver>.py`` that runs it;
- correctness limits of cell ``<w>``: ``limits/<w>.json``;
- per-layer metric ``<m>``: ``metrics/<m>.py``, else
  ``metrics/<m up to its first dot>.py`` (one reader serves the
  ``.train``, ``.emulate`` and ``.serve`` splits of a quantity).
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib

PACKAGE = pathlib.Path(__file__).resolve().parent.parent
ROOT = PACKAGE.parent
# keys of a configuration file that are not configuration fields
CONFIG_META = ("registered", "overrides", "source", "reduced", "assumed",
               "reference", "smoke")


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # configuration fields as run (smoke applied)
    traffic: dict         # traffic parameters (smoke applied)
    limits: dict          # compared number -> limit
    end_to_end: list      # metric entries of BENCHMARK.json this cell reports
    per_layer: list


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(name: str, smoke: bool = False, root: pathlib.Path = ROOT) -> Cell:
    """The cell ``name`` with every file it names read; ``smoke`` applies
    the configuration's and the traffic's CPU twins."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r}; have {sorted(cells)}")
    w = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    raw = _json(root / entry["file"])
    config = {k: v for k, v in raw.items() if k not in CONFIG_META}
    traffic = _json(PACKAGE / "traffic" / f"{w['traffic']}.json")
    if smoke:
        config.update(raw.get("smoke", {}))
        traffic.update(traffic.get("smoke", {}))
    traffic.pop("smoke", None)
    return Cell(
        name=name, chips=int(w["chips"]), config=config, traffic=traffic,
        limits=_json(PACKAGE / "limits" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
    )


def driver_module(cell: Cell):
    return importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")


def metric_reader(name: str):
    """The module whose ``read(trace)`` gives per-layer metric ``name``."""
    for stem in (name, name.split(".")[0]):
        path = PACKAGE / "metrics" / f"{stem}.py"
        if path.exists():
            spec = importlib.util.spec_from_file_location(
                f"portbench.metrics.{stem.replace('.', '_')}", path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            return module
    raise FileNotFoundError(f"no reader for metric {name!r} in "
                            f"{PACKAGE / 'metrics'}")
