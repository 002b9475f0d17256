"""The port's dry-run tools (``launch/specs``, ``launch/dryrun``,
``launch/perf``, the 3-D production mesh) against the JAX package's, on
the CPU.

- ``input_specs`` of every arch and shape of the reference's sweep: the
  same kind, input names, shapes, dtypes and ``cell_status`` text;
- ``lm_model_flops``, ``donn_model_flops`` and ``param_count`` of the full
  configs equal;
- ``OVERRIDES``, ``PREFILL_OVERRIDES`` and ``VARIANTS`` equal as tables,
  dtypes by name;
- a fake tensor reaching a K1-K7 wrapper raises;
- the 3-D mesh's flattened groups (a subprocess, a fake process group of 8
  initialised once a rank): ``("pod", "data")`` and ``("data", "pod")`` on
  ``(2, 2, 2)`` list their members in ``axes_index``'s order, and each
  rank's own place in that list is its ``axes_index``.  ``new_group``
  ranks a group by global rank, so for ``("data", "pod")`` the order is
  the one ``collectives.block_ranks`` records, not the group's own;
- the dry-run CLI with ``--smoke --device cpu`` on qwen1.5-4b
  ``train_4k`` and donn-xl-500 at both production meshes (three
  subprocesses at once): records with ``tests/test_artifacts.py``'s keys,
  ``chips`` 256 and 512, collective bytes on the FSDP cell.  The DONN
  cell is ``train_b1024``: the smoke config's n = 96 has only that shape
  (``shapes_for`` gives ``train_b256`` from n = 500, in the reference
  too).

The reference's ``launch/dryrun.py`` and ``launch/perf.py`` set
``XLA_FLAGS`` to 512 host devices when imported; the test imports them
with the variable restored at once, before any JAX backend starts here.
"""
import concurrent.futures
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from _torch_cores import share_cores  # noqa: E402

share_cores(torch)

import jax  # noqa: E402

from repro.configs import DONN_ARCHS, LM_ARCHS  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.nn import param_count as jparam_count  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import dryrun as tdry  # noqa: E402
from repro_torch.launch import perf as tperf  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.nn import param_count as tparam_count  # noqa: E402
from test_artifacts import OK_REQUIRED, REQUIRED  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
       "OMP_NUM_THREADS": "1"}


def _reference(name):
    """``repro.launch.<name>`` imported with ``XLA_FLAGS`` left as it was."""
    before = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(f"repro.launch.{name}")
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before


jdry = _reference("dryrun")
jperf = _reference("perf")

CELLS = [(arch, cell.name) for arch in LM_ARCHS + DONN_ARCHS
         for cell in jspecs.shapes_for(jspecs.get_config(arch))]


def _abstract(tree) -> dict:
    """path -> (shape, dtype name) of a tree of ShapeDtypeStructs or meta
    tensors."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(p): (tuple(x.shape),
                                      str(x.dtype).removeprefix("torch."))
            for p, x in leaves}


def test_sweep_tables_equal_the_references():
    assert tconfigs.LM_ARCHS == LM_ARCHS
    assert tconfigs.DONN_ARCHS == DONN_ARCHS
    assert tdry.all_cells() == CELLS
    smoke = tdry.all_cells(smoke=True)  # each cell one the config has
    assert smoke == [c if c[0] != "donn-xl-500" else (c[0], "train_b1024")
                     for c in CELLS]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_the_references(arch, shape):
    jcfg, jcell, jkind, jin = jspecs.input_specs(arch, shape)
    tcfg, tcell, tkind, tin = tspecs.input_specs(arch, shape)
    assert (tkind, dataclasses.astuple(tcell)) == (
        jkind, dataclasses.astuple(jcell))
    assert tspecs.cell_status(tcfg, tcell) == jspecs.cell_status(jcfg, jcell)
    assert all(t.device.type == "meta" for t in jax.tree.leaves(tin))
    assert _abstract(tin) == _abstract(jin)
    with pytest.raises(KeyError, match="unknown shape"):
        tspecs.input_specs(arch, "train_1m")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal_the_references(arch, shape):
    jcfg, jcell, kind, _ = jspecs.input_specs(arch, shape)
    tcfg, tcell, _, _ = tspecs.input_specs(arch, shape)
    if arch in DONN_ARCHS:
        got = tdry.donn_model_flops(tcfg, tcell.global_batch)
        want = jdry.donn_model_flops(jcfg, jcell.global_batch)
    else:
        got = tdry.lm_model_flops(tcfg, kind, tcell)
        want = jdry.lm_model_flops(jcfg, kind, jcell)
        assert tparam_count(tlm.param_specs(tcfg)) == jparam_count(
            jlm.param_specs(jcfg))
    assert got == pytest.approx(want, rel=1e-12)


def _names(table: dict) -> dict:
    return {k: {n: getattr(v, "__name__", str(v).removeprefix("torch."))
                for n, v in kw.items()} for k, kw in table.items()}


def test_override_and_variant_tables_equal_the_references():
    assert _names(tdry.OVERRIDES) == _names(jdry.OVERRIDES)
    assert _names(tdry.PREFILL_OVERRIDES) == _names(jdry.PREFILL_OVERRIDES)
    for over in tdry.OVERRIDES.values():
        assert all(isinstance(v, (int, torch.dtype)) for v in over.values())
    assert tdry.override_names(tdry.OVERRIDES[
        ("arctic-480b", "train_4k", False)]) == {
            "accum_steps": "8", "param_dtype": "bfloat16",
            "state_dtype": "bfloat16", "accum_dtype": "bfloat16"}
    assert set(tperf.VARIANTS) == set(jperf.VARIANTS)
    for key, want in jperf.VARIANTS.items():
        got = tperf.VARIANTS[key]
        assert (got["arch"], got["shape"]) == (want["arch"], want["shape"])
        assert [(n, c, _names({0: k})[0], s) for n, c, k, s in
                got["variants"]] == [(n, c, _names({0: k})[0], s)
                                     for n, c, k, s in want["variants"]]


def test_a_fake_tensor_never_reaches_a_kernel():
    """A trace on fake tensors raises at a K1-K7 wrapper: neither the
    kernel nor its plain version may be counted in its place."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import ops

    with FakeTensorMode():
        u = torch.zeros(2, 8, 8, dtype=torch.complex64)
        with pytest.raises(RuntimeError, match="fake tensor"):
            ops.intensity_readout(u, torch.zeros(3, 8, 8))
        with pytest.raises(RuntimeError, match="fake tensor"):
            ops.phase_apply(u, torch.zeros(8, 8))


GROUPS = textwrap.dedent("""
    import json
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.runtime import collectives, sharding as shd

    out = {}
    for rank in range(8):
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=8)
        mesh = mesh_mod.make_mesh((2, 2, 2), mesh_mod.AXES_3D, device="cpu")
        for axes in (("pod", "data"), ("data", "pod")):
            g = shd.axes_group(mesh, axes)
            out[f"{rank} {','.join(axes)}"] = {
                "coord": list(mesh.get_coordinate()),
                "block_ranks": collectives.block_ranks(g),
                "group_ranks": dist.get_process_group_ranks(g),
                "index": list(shd.axes_index(mesh, axes)),
                "same": shd.axes_group(mesh, axes) is g,
            }
        dist.destroy_process_group()
    print(json.dumps(out))
""")


def test_3d_mesh_groups_in_axes_index_order():
    r = subprocess.run([sys.executable, "-c", GROUPS], capture_output=True,
                       text=True, timeout=120, env=ENV)
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    sizes = {"pod": 2, "data": 2, "model": 2}
    for rank in range(8):
        coord = dict(zip(("pod", "data", "model"), divmod(rank // 2, 2)
                         + (rank % 2,)))
        for axes in (("pod", "data"), ("data", "pod")):
            rec = got[f"{rank} {','.join(axes)}"]
            assert rec["coord"] == list(coord.values())
            a, b = axes
            want = []  # the members in axes_index order: a major, b minor
            for i in range(sizes[a]):
                for j in range(sizes[b]):
                    c = {**coord, a: i, b: j}
                    want.append(c["pod"] * 4 + c["data"] * 2 + c["model"])
            assert rec["block_ranks"] == want, (rank, axes)
            assert rec["group_ranks"] == sorted(want)
            idx = coord[a] * sizes[b] + coord[b]
            assert rec["index"] == [idx, 4]
            assert want[idx] == rank
            assert rec["same"]  # one group a tuple of names
    # the mesh's own order needs no record
    assert got["0 pod,data"]["group_ranks"] == [0, 2, 4, 6]
    assert got["0 data,pod"]["block_ranks"] == [0, 4, 2, 6]


def _cli(tmp, *args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--smoke",
         "--device", "cpu", "--out", str(tmp), *args],
        capture_output=True, text=True, timeout=600, env=ENV)


def test_dryrun_cli_on_both_production_meshes(tmp_path):
    runs = [("qwen1.5-4b", "train_4k", "single"),
            ("qwen1.5-4b", "train_4k", "multi"),
            ("donn-xl-500", "train_b1024", "both")]
    with concurrent.futures.ThreadPoolExecutor(len(runs)) as pool:
        done = list(pool.map(lambda r: _cli(tmp_path, "--arch", r[0],
                                            "--shape", r[1], "--mesh",
                                            r[2]), runs))
    for r in done:
        assert r.returncode == 0, r.stdout + r.stderr
    recs = {p.name: json.loads(p.read_text())
            for p in sorted(tmp_path.glob("*.json"))}
    assert sorted(recs) == [f"{a}__{s}__{m}.json"
                            for a, s in (("donn-xl-500", "train_b1024"),
                                         ("qwen1.5-4b", "train_4k"))
                            for m in ("pod1", "pod2")]
    for name, rec in recs.items():
        for k in REQUIRED + OK_REQUIRED:
            assert k in rec, (name, k)
        assert rec["status"] == "ok"
        assert rec["chips"] == (512 if "pod2" in name else 256)
        assert rec["mesh"] == ("pod2-512" if "pod2" in name else "pod1-256")
        assert set(rec["terms"]) == {"compute_s", "memory_s",
                                     "collective_s"}
        assert rec["hlo_dot_flops_per_dev"] > 0 or "donn" in name
        assert rec["memory"]["per_device_bytes"] > 0
        assert rec["memory"]["fits_hbm"]
        assert 0 < rec["roofline_fraction"] <= 1
    for m in ("pod1", "pod2"):
        qwen = recs[f"qwen1.5-4b__train_4k__{m}.json"]
        # FSDP gathers and their reduce-scatters, the data-parallel sums
        assert {"all-gather", "reduce-scatter", "all-reduce"} <= set(
            qwen["collective_breakdown"])
        assert qwen["collective_bytes_per_dev"] > 0
        donn = recs[f"donn-xl-500__train_b1024__{m}.json"]
        assert set(donn["collective_breakdown"]) == {"all-reduce"}
