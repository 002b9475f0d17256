"""The port's public surface holds the reference's, name by name.

The reference is read through ``ast`` only: no JAX import, and none of the
side effects of importing ``repro.launch.*``.  For every module of
``src/repro`` the walker collects its public names:

- module-level functions, classes and assignments;
- public methods and annotated fields of its public classes;
- the names in ``__all__`` and, in a package's ``__init__.py``, the names
  it imports (re-exports).

Each name must have a same-named counterpart in the matching module of
``src/repro_torch``: ``hasattr`` on the imported module (so a method a
class inherits counts, e.g. ``DONN.init`` from ``_PhaseStack``), or a
dataclass/annotated field of the class.  A package's re-export must also
be bound by the port's own ``__init__.py`` (an attribute a submodule
import leaves behind elsewhere does not count).

A name without such a counterpart needs a row in ``TABLE``: a ``Map`` to
the port's counterpart under another name (checked to exist, and, for a
TPU kernel, its CUDA source and launcher symbol), or an ``Exempt`` whose
kind is one of ``EXEMPT_KINDS``, the things that have no PyTorch
counterpart by nature.  A row for a class covers its members.  A row must
name something of the reference that the port lacks, so a stale row
fails as well.
"""
from __future__ import annotations

import ast
import dataclasses
import importlib
import pathlib
import re
from typing import NamedTuple, Optional

import pytest

torch = pytest.importorskip("torch")

from _torch_cores import share_cores  # noqa: E402

share_cores(torch)

SRC = pathlib.Path(__file__).resolve().parent.parent / "src"
REF = SRC / "repro"
PORT = SRC / "repro_torch"

EXEMPT_KINDS = ("JAX shim", "XLA compile or scan cache", "HLO text",
                "TPU constant")


class Map(NamedTuple):
    """The reference's name lives on in the port as ``target``
    ("rel/path.py:Name"); ``source`` is a (CUDA file, launcher) pair for
    a TPU kernel's counterpart."""
    target: str
    reason: str
    source: Optional[tuple] = None


class Exempt(NamedTuple):
    kind: str
    reason: str


_SHIM = "JAX version shim (jax.shard_map / make_mesh / AxisType spellings)"
_HLO = "parses XLA's HLO text; the port counts ops as they run instead"

TABLE = {
    # compat.py: the reference's JAX-version shim
    "compat.py:AxisType": Exempt("JAX shim", _SHIM),
    "compat.py:shard_map": Exempt("JAX shim", _SHIM),
    "compat.py:make_mesh": Exempt("JAX shim", _SHIM),
    "compat.py:axis_size": Exempt("JAX shim", _SHIM),
    "compat.py:compiled_cost_analysis": Exempt("JAX shim", _SHIM),
    # XLA's compile-once and scan machinery: eager PyTorch compiles nothing
    "core/propagation.py:cached_executable": Exempt(
        "XLA compile or scan cache", "AOT-compiled XLA executables keyed "
        "by avals; eager PyTorch runs the plan's ops directly"),
    "core/propagation.py:default_scan_unroll": Exempt(
        "XLA compile or scan cache", "the unroll of a lax.scan; the port's "
        "layer loop is a Python loop"),
    "core/train_utils.py:optimizer_cache_key": Exempt(
        "XLA compile or scan cache", "keys the compiled train-step cache"),
    "runtime/inference.py:DeployedDONN.static_key": Exempt(
        "XLA compile or scan cache", "keys the compiled serving executable"),
    # HLO text parsing; its counterpart counts the ops a run dispatches
    "runtime/hlo_analysis.py:Op": Exempt("HLO text", _HLO),
    "runtime/hlo_analysis.py:Computation": Exempt("HLO text", _HLO),
    "runtime/hlo_analysis.py:parse_hlo": Exempt("HLO text", _HLO),
    "runtime/hlo_analysis.py:analyze": Map(
        "runtime/cost_analysis.py:count",
        "FLOPs, bytes and collective bytes of one step, counted by a "
        "TorchDispatchMode over the ops it runs"),
    "runtime/hlo_analysis.py:HloCost": Map(
        "runtime/cost_analysis.py:Cost",
        "the same fields, then the run's memory"),
    # TPU v5e constants: the card's replace them
    "launch/mesh.py:ICI_BW": Map(
        "launch/mesh.py:LINK_BW", "TPU v5e ICI link -> NVLink 4"),
    "launch/dryrun.py:HBM_PER_CHIP": Map(
        "launch/mesh.py:HBM_PER_DEVICE", "TPU v5e 16 GB -> the card's HBM"),
    # the seven Pallas kernels: a CUDA launcher behind a raw wrapper each
    "kernels/spectral_hop.py:conj_phase_scale_pallas": Map(
        "kernels/ops.py:conj_phase_scale", "K1",
        ("kernels/csrc/spectral_hop.cu", "conj_phase_scale")),
    "kernels/complex_mul.py:phase_tf_apply_pallas": Map(
        "kernels/ops.py:phase_tf_apply_planes", "K2",
        ("kernels/csrc/complex_mul.cu", "phase_tf_apply")),
    "kernels/intensity_readout.py:intensity_readout_pallas": Map(
        "kernels/ops.py:intensity_readout_rows", "K3",
        ("kernels/csrc/intensity_readout.cu", "intensity_readout")),
    "kernels/complex_mul.py:phase_apply_pallas": Map(
        "kernels/ops.py:phase_apply_rows", "K4",
        ("kernels/csrc/complex_mul.cu", "phase_apply")),
    "kernels/complex_mul.py:complex_mul_pallas": Map(
        "kernels/ops.py:complex_mul_rows", "K5",
        ("kernels/csrc/complex_mul.cu", "complex_mul")),
    "kernels/rope.py:rope_pallas": Map(
        "kernels/ops.py:rope_rows", "K6 (f32 and bf16 launchers)",
        ("kernels/csrc/rope.cu", "rope_f32")),
    "kernels/selective_scan.py:selective_scan_pallas": Map(
        "kernels/ops.py:selective_scan", "K7",
        ("kernels/csrc/selective_scan.cu", "selective_scan")),
}


# --------------------------------------------------------------------------
# the walker
# --------------------------------------------------------------------------
def _public(name: str) -> bool:
    return not name.startswith("_")


def _assigned(node) -> list:
    if isinstance(node, ast.Assign):
        return [t.id for t in node.targets if isinstance(t, ast.Name)]
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return [node.target.id]
    return []


def _imported(node) -> list:
    if isinstance(node, (ast.Import, ast.ImportFrom)):
        return [(a.asname or a.name).split(".")[0] for a in node.names
                if a.name != "*"]
    return []


def _dunder_all(tree) -> list:
    for node in tree.body:
        if "__all__" in _assigned(node) and isinstance(
                node.value, (ast.List, ast.Tuple)):
            return [e.value for e in node.value.elts
                    if isinstance(e, ast.Constant)]
    return []


def bound_names(path: pathlib.Path) -> set:
    """Every name a module binds at its top level (defs, assignments,
    imports)."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        out.update(_assigned(node))
        out.update(_imported(node))
    return out


def public_names(path: pathlib.Path) -> set:
    """The public surface of one module, "Name" or "Class.member"."""
    tree = ast.parse(path.read_text())
    out = set(_dunder_all(tree))
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            if _public(node.name):
                for b in node.body:
                    members = _assigned(b)
                    if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        members = [b.name]
                    out.update(f"{node.name}.{m}" for m in members)
        else:
            out.update(_assigned(node))
            if path.name == "__init__.py":
                out.update(n for n in _imported(node) if n != "annotations")
    return {n for n in out if all(_public(p) for p in n.split("."))}


def _module_name(pkg: str, rel: str) -> str:
    parts = [pkg] + rel[:-len(".py")].split("/")
    if parts[-1] == "__init__":
        parts.pop()
    return ".".join(parts)


def _import(pkg: str, rel: str):
    name = _module_name(pkg, rel)
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name == name:
            return None
        raise


def _has_member(cls, member: str) -> bool:
    if hasattr(cls, member):
        return True
    if dataclasses.is_dataclass(cls) and member in {
            f.name for f in dataclasses.fields(cls)}:
        return True
    return any(member in getattr(k, "__annotations__", {})
               for k in getattr(cls, "__mro__", ()))


def _resolve(mod, name: str) -> bool:
    head, _, member = name.partition(".")
    if mod is None or not hasattr(mod, head):
        return False
    return not member or _has_member(getattr(mod, head), member)


def has_counterpart(port_root: pathlib.Path, port_pkg: str, rel: str,
                    name: str) -> bool:
    mod = _import(port_pkg, rel)
    if not _resolve(mod, name):
        return False
    if rel.endswith("__init__.py") and "." not in name:
        # a re-export must be the port package's own binding
        return name in bound_names(port_root / rel)
    return True


def _row_problem(port_root, port_pkg: str, key: str, row,
                 ref_names: set) -> Optional[str]:
    rel, name = key.split(":")
    if name not in ref_names:
        return f"stale row {key}: the reference has no such name"
    if has_counterpart(port_root, port_pkg, rel, name):
        return f"row {key} not needed: the port has the same name"
    if isinstance(row, Exempt):
        if row.kind not in EXEMPT_KINDS:
            return f"row {key}: {row.kind!r} is no exemption"
        return None
    t_rel, t_name = row.target.split(":")
    if not (port_root / t_rel).exists() or not _resolve(
            _import(port_pkg, t_rel), t_name):
        return f"row {key}: its counterpart {row.target} does not exist"
    if row.source is not None:
        path, symbol = row.source
        src = port_root / path
        if not src.exists() or not re.search(
                rf'extern "C" int {symbol}\(', src.read_text()):
            return f"row {key}: no launcher {symbol} in {path}"
    return None


def judge(ref_root: pathlib.Path, port_root: pathlib.Path, port_pkg: str,
          rel: str, table: dict) -> list:
    """Problems of one reference module ``rel``: public names with neither
    a counterpart nor a row, and rows of this module that are wrong."""
    names = public_names(ref_root / rel)
    rows = {k: v for k, v in table.items() if k.split(":")[0] == rel}
    covered = {k.split(":")[1] for k in rows}
    problems = []
    for name in sorted(names):
        if name in covered or name.split(".")[0] in covered:
            continue
        if not has_counterpart(port_root, port_pkg, rel, name):
            problems.append(f"{rel}:{name} has no counterpart in the port")
    for key, row in sorted(rows.items()):
        problem = _row_problem(port_root, port_pkg, key, row, names)
        if problem is None and isinstance(row, Map) and "." not in \
                key.split(":")[1]:
            problem = _class_map_problem(ref_root, port_pkg, key, row)
        if problem:
            problems.append(problem)
    return problems


def _class_map_problem(ref_root, port_pkg, key, row) -> Optional[str]:
    """A class mapped to a class: each of its members must be on the
    target under the same name."""
    rel, name = key.split(":")
    members = [n.split(".", 1)[1] for n in public_names(ref_root / rel)
               if n.startswith(name + ".")]
    t_rel, t_name = row.target.split(":")
    target = getattr(_import(port_pkg, t_rel), t_name)
    lost = [m for m in members if not _has_member(target, m)]
    if lost:
        return f"row {key}: {row.target} lacks {lost}"
    return None


REF_MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


# --------------------------------------------------------------------------
# the cases
# --------------------------------------------------------------------------
@pytest.mark.parametrize("rel", REF_MODULES)
def test_reference_module_has_its_counterparts(rel):
    assert judge(REF, PORT, "repro_torch", rel, TABLE) == []


def test_table_rows_name_reference_modules():
    for key, row in TABLE.items():
        rel = key.split(":")[0]
        assert rel in REF_MODULES, f"row {key}: no module {rel} in repro"
        assert isinstance(row, (Map, Exempt)) and row.reason, key
        if isinstance(row, Exempt):
            assert row.kind in EXEMPT_KINDS, key


_REF_SRC = {
    "__init__.py": "from refpkg import mod\nfrom refpkg.mod import present\n",
    "mod.py": (
        "import dataclasses\n"
        "LIMIT = 1\n"
        "_PRIVATE = 2\n"
        "class A:\n"
        "    def own(self): ...\n"
        "    def inherited(self): ...\n"
        "    def _hidden(self): ...\n"
        "@dataclasses.dataclass\n"
        "class Rec:\n"
        "    field: int\n"
        "def present(): ...\n"
        "def missing(): ...\n"
        "def mapped(): ...\n"
        "def exempted(): ...\n"
    ),
}
_PORT_SRC = {
    "__init__.py": "",
    "mod.py": (
        "import dataclasses\n"
        "LIMIT = 1\n"
        "class Base:\n"
        "    def inherited(self): ...\n"
        "class A(Base):\n"
        "    def own(self): ...\n"
        "@dataclasses.dataclass\n"
        "class Rec:\n"
        "    field: int\n"
        "def present(): ...\n"
        "def target(): ...\n"
    ),
    "other.py": "import {pkg}.mod\n",
}


def _write(root: pathlib.Path, files: dict, pkg: str) -> None:
    root.mkdir()
    for name, text in files.items():
        (root / name).write_text(text.format(pkg=pkg))


def test_walker_judges_small_packages(tmp_path, monkeypatch):
    """A missing name, an unneeded or stale row, a wrong exemption kind
    and a re-export that only a submodule import leaves behind each fail;
    an inherited method, a dataclass field and a checked map pass."""
    port_pkg = f"portpkg_{tmp_path.name}"
    _write(tmp_path / "refpkg", _REF_SRC, "refpkg")
    _write(tmp_path / port_pkg, _PORT_SRC, port_pkg)
    monkeypatch.syspath_prepend(str(tmp_path))
    importlib.import_module(f"{port_pkg}.other")  # binds pkg.mod
    ref, port = tmp_path / "refpkg", tmp_path / port_pkg

    assert public_names(ref / "mod.py") == {
        "LIMIT", "A", "A.own", "A.inherited", "Rec", "Rec.field",
        "present", "missing", "mapped", "exempted"}
    table = {"mod.py:mapped": Map("mod.py:target", "renamed"),
             "mod.py:exempted": Exempt("TPU constant", "by nature")}
    assert judge(ref, port, port_pkg, "mod.py", table) == [
        "mod.py:missing has no counterpart in the port"]

    stale = {**table, "mod.py:gone": Exempt("JAX shim", "removed"),
             "mod.py:present": Exempt("JAX shim", "ported after all"),
             "mod.py:missing": Exempt("not ported yet", "unported")}
    assert judge(ref, port, port_pkg, "mod.py", stale) == [
        "stale row mod.py:gone: the reference has no such name",
        "row mod.py:missing: 'not ported yet' is no exemption",
        "row mod.py:present not needed: the port has the same name"]

    wrong_map = {**table, "mod.py:mapped": Map("mod.py:nowhere", "typo")}
    assert "row mod.py:mapped: its counterpart mod.py:nowhere does not " \
        "exist" in judge(ref, port, port_pkg, "mod.py", wrong_map)

    # ``mod`` is the port package's attribute only because ``other``
    # imported it: not a re-export
    assert judge(ref, port, port_pkg, "__init__.py", {}) == [
        "__init__.py:mod has no counterpart in the port",
        "__init__.py:present has no counterpart in the port"]
    (port / "__init__.py").write_text(
        f"from {port_pkg} import mod\nfrom {port_pkg}.mod import present\n")
    importlib.reload(importlib.import_module(port_pkg))
    assert judge(ref, port, port_pkg, "__init__.py", {}) == []
