"""Sharded, atomic, integrity-checked checkpoint store.

The port of ``repro.checkpoint.store``, with its on-disk format byte for
byte, so either package reads what the other wrote:

    ckpt_dir/
      step_00000042/
        MANIFEST.json        # leaf paths, shapes, dtypes, chunking, crc32
        leaf_00000.c000.npy  # chunk files (split along axis 0, ~64MB each)
        ...
      LATEST                 # atomically-updated pointer file

Each chunk file is a uint8 ``.npy`` of the chunk's raw bytes; its crc32 is
over the same bytes.  Leaves are named by their ``jax.tree_util.keystr``
path (``repro_torch.tree.tree_paths``) and stored in ``tree_leaves`` order
(dict keys sorted).  ``bfloat16`` leaves are written and read as raw
2-byte words (no ``ml_dtypes``): the manifest still says ``"bfloat16"``.

Commit protocol: write everything into ``step_N.tmp/``, fsync the
manifest, rename to ``step_N/`` (atomic on POSIX), then rewrite LATEST via
tmp+rename.  A crash at any point leaves either the old or the new
checkpoint fully valid.

A save takes a host copy of every leaf first (``_snapshot``), so a tensor
mutated in place after ``AsyncCheckpointer.save`` returns cannot reach the
file.  ``restore`` places the leaves on ``device``, the CUDA card unless
the caller names another.

Under a mesh (``mesh=`` and the state's spec tuples ``pspecs=``, as
``runtime.steps.compile_train_step`` places a sharded state) a save
gathers one leaf at a time to rank 0, which alone writes the same format;
a restore reads each leaf on every rank and keeps the rank's block, so a
state saved on one mesh restores on any other (elastic restore).
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import zlib
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.runtime.sharding import gather_leaf, local_block
from repro_torch.tree import tree_leaves, tree_map, tree_paths, tree_unflatten

CHUNK_BYTES = 64 << 20
BF16 = "bfloat16"


def _np_dtype(name: str) -> np.dtype:
    """The numpy dtype a manifest's dtype string is read as (bf16 as its
    raw 2-byte words)."""
    if name == BF16:
        return np.dtype(np.int16)
    try:
        return np.dtype(name)
    except TypeError as e:
        raise ValueError(f"checkpoint dtype {name!r} is not supported "
                         "without ml_dtypes") from e


def _host_leaf(leaf) -> tuple:
    """(numpy array, manifest dtype string) of one leaf: a host copy that
    shares no memory with the caller's tensor or array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), BF16
        arr = t.numpy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _spec_list(tree, pspecs) -> list:
    """The spec tuple of each leaf of ``tree``, in ``tree_leaves`` order."""
    out = []
    tree_map(lambda _, spec: out.append(spec), tree, pspecs)
    return out


def _rank0(mesh) -> bool:
    return mesh is None or dist.get_rank() == 0


def _snapshot(state, mesh=None, pspecs=None) -> list:
    """[(path, array, dtype string)] for every leaf of ``state``; under a
    mesh each leaf gathered whole in turn (a collective on every rank),
    the host copies kept by rank 0 only (other ranks get [])."""
    if mesh is None:
        return [(name, *_host_leaf(leaf))
                for name, leaf in zip(tree_paths(state), tree_leaves(state))]
    out = []
    keep = _rank0(mesh)
    for name, leaf, spec in zip(tree_paths(state), tree_leaves(state),
                                _spec_list(state, pspecs)):
        whole = gather_leaf(leaf, spec, mesh)
        if keep:
            out.append((name, *_host_leaf(whole)))
        del whole
    return out


def _save_chunk(path, chunk: np.ndarray):
    """Serialize via raw bytes (the reference's layout)."""
    np.save(path, np.frombuffer(np.ascontiguousarray(chunk).tobytes(),
                                np.uint8))


def _commit(ckpt_dir, step: int, snapshot: list, keep: int,
            verify: bool) -> pathlib.Path:
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "leaves": []}
    for i, (name, arr, dtype) in enumerate(snapshot):
        entry = {"name": name, "dtype": dtype, "shape": list(arr.shape),
                 "chunks": []}
        if arr.ndim == 0 or arr.nbytes <= CHUNK_BYTES:
            splits = [(0, arr.shape[0] if arr.ndim else 0, arr)]
        else:
            rows_per = max(1, int(CHUNK_BYTES
                                  / max(arr.nbytes / arr.shape[0], 1)))
            splits = [
                (r, min(r + rows_per, arr.shape[0]),
                 arr[r: min(r + rows_per, arr.shape[0])])
                for r in range(0, arr.shape[0], rows_per)
            ]
        for ci, (r0, r1, chunk) in enumerate(splits):
            fname = f"leaf_{i:05d}.c{ci:03d}.npy"
            _save_chunk(tmp / fname, chunk)
            entry["chunks"].append({
                "file": fname, "row0": int(r0), "row1": int(r1),
                "shape": list(np.shape(chunk)),
                "crc32": (zlib.crc32(np.ascontiguousarray(chunk).tobytes())
                          if verify else None),
            })
        manifest["leaves"].append(entry)
    with open(tmp / "MANIFEST.json", "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if final.exists():  # idempotent re-save of the same step
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    _write_latest(ckpt_dir, final.name)
    _gc(ckpt_dir, keep)
    return final


def save(ckpt_dir, step: int, state, *, keep: int = 3,
         verify: bool = True, mesh=None, pspecs=None):
    """Blocking save with atomic commit. Returns the final directory (None
    on the ranks other than 0 under a mesh).

    ``state`` is a tree (``repro_torch.tree``) of tensors, numpy arrays
    and Python scalars on any device; under ``mesh`` this rank's blocks,
    placed by ``pspecs``."""
    snapshot = _snapshot(state, mesh, pspecs)
    final = (_commit(ckpt_dir, step, snapshot, keep, verify)
             if _rank0(mesh) else None)
    _barrier(mesh)
    return final


def _barrier(mesh) -> None:
    """Every rank waits for rank 0's commit before it reads the store."""
    if mesh is not None:
        dist.barrier()


def _write_latest(ckpt_dir: pathlib.Path, name: str):
    tmp = ckpt_dir / "LATEST.tmp"
    tmp.write_text(name)
    os.rename(tmp, ckpt_dir / "LATEST")


def _gc(ckpt_dir: pathlib.Path, keep: int):
    steps = sorted(d for d in ckpt_dir.iterdir()
                   if d.is_dir() and d.name.startswith("step_")
                   and not d.name.endswith(".tmp"))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(d, ignore_errors=True)


def _manifest_ok(step_dir: pathlib.Path) -> bool:
    """A checkpoint directory is usable iff its manifest parses."""
    try:
        json.loads((step_dir / "MANIFEST.json").read_text())
        return True
    except (OSError, ValueError):
        return False


def valid_steps(ckpt_dir) -> list:
    """All step numbers with a parseable MANIFEST.json, ascending."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.is_dir():
        return []
    out = []
    for d in ckpt_dir.iterdir():
        if (d.is_dir() and d.name.startswith("step_")
                and not d.name.endswith(".tmp") and _manifest_ok(d)):
            try:
                out.append(int(d.name.split("_")[1]))
            except (IndexError, ValueError):
                continue
    return sorted(out)


def latest_step(ckpt_dir) -> Optional[int]:
    """Newest usable checkpoint step, or None.

    Follows the LATEST pointer when it names a directory with a valid
    manifest; when the pointer is missing, dangling or points at a corrupt
    directory, falls back to the newest ``step_*`` directory whose
    MANIFEST.json parses.
    """
    ckpt_dir = pathlib.Path(ckpt_dir)
    ptr = ckpt_dir / "LATEST"
    if ptr.exists():
        name = ptr.read_text().strip()
        if _manifest_ok(ckpt_dir / name):
            return int(name.split("_")[1])
    steps = valid_steps(ckpt_dir)
    return steps[-1] if steps else None


def _to_tensor(arr: np.ndarray, dtype: str, dev: torch.device):
    t = torch.from_numpy(arr)
    if dtype == BF16:
        t = t.view(torch.bfloat16)
    return t.to(dev)


def restore(ckpt_dir, step: int, target_tree, *, device=None,
            verify: bool = True, mesh=None, pspecs=None):
    """Restore into the structure of ``target_tree`` (values ignored), each
    leaf a tensor of its saved dtype and shape on ``device`` (the CUDA card
    by default); under ``mesh``, this rank's block of each leaf as
    ``pspecs`` places it, whatever mesh wrote the checkpoint.

    ``verify`` (default on) recomputes each chunk's crc32 against the
    manifest and raises ``IOError`` on a mismatch; pass ``verify=False``
    only to skip the checksum pass on trusted local storage.
    """
    dev = resolve_device(device)
    d = pathlib.Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "MANIFEST.json").read_text())
    n_target = len(tree_leaves(target_tree))
    if len(manifest["leaves"]) != n_target:
        raise ValueError(
            f"checkpoint has {len(manifest['leaves'])} leaves, "
            f"target expects {n_target}"
        )
    specs = (_spec_list(target_tree, pspecs) if mesh is not None
             else [None] * n_target)
    out = []
    for entry, spec in zip(manifest["leaves"], specs):
        shape = tuple(entry["shape"])
        dtype = _np_dtype(entry["dtype"])
        arr = np.empty(shape, dtype)
        for ch in entry["chunks"]:
            raw = np.load(d / ch["file"]).tobytes()
            if verify and ch.get("crc32") is not None:
                if zlib.crc32(raw) != ch["crc32"]:
                    raise IOError(f"crc mismatch in {ch['file']}")
            chunk = np.frombuffer(raw, dtype).reshape(
                tuple(ch.get("shape", shape)))
            if arr.ndim == 0:
                arr = chunk.copy()
            else:
                arr[ch["row0"]: ch["row1"]] = chunk
        if spec is not None:
            arr = local_block(torch.from_numpy(arr), spec, mesh).numpy().copy()
        out.append(_to_tensor(arr, entry["dtype"], dev))
    return tree_unflatten(target_tree, out)


class AsyncCheckpointer:
    """Snapshot on the caller's thread, serialize/commit on a worker thread.

    ``save`` copies every leaf to the host before it returns (a tensor the
    caller mutates in place afterwards, or frees, does not reach the file);
    the worker only writes.  A failed commit is raised by the next
    ``save`` or ``wait``.
    """

    def __init__(self, ckpt_dir, keep: int = 3, *, mesh=None, pspecs=None):
        """Under ``mesh`` (``pspecs``: the state's spec tuples) each save
        gathers the state leaf by leaf on the caller's thread, rank 0
        commits it, and ``wait`` holds every rank until the commit is
        done."""
        self.ckpt_dir = pathlib.Path(ckpt_dir)
        self.keep = keep
        self.mesh, self.pspecs = mesh, pspecs
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, state):
        self.wait()
        snapshot = _snapshot(state, self.mesh, self.pspecs)
        if not _rank0(self.mesh):
            return

        def work():
            try:
                _commit(self.ckpt_dir, step, snapshot, self.keep, True)
            except BaseException as e:  # noqa: BLE001 - re-raised by wait
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
        _barrier(self.mesh)
