"""Build and load the hand-written Hopper kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded through ``ctypes``: seconds per
file, where a ``torch.utils.cpp_extension`` source that includes PyTorch's
headers takes minutes.  The ctypes argument types are read from each
source's ``extern "C"`` prototypes (``exported_signatures``), so a
launcher's C declaration is the one definition of its arguments.  The
build runs at first use, from the sources in the checkout, into
``_build/`` beside this file (listed in ``.gitignore``).  Library names
carry a digest of the sources and flags, so an edited source never loads a
stale build.  All sources compile in parallel, one ``nvcc`` each.

A lock guards the build: the serving worker thread and the main thread
may both reach a kernel first.  A failed build raises; nothing falls back
to the plain PyTorch versions on the card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading
import time

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"

SOURCES = {
    "spectral_hop": "spectral_hop.cu",
    "complex_mul": "complex_mul.cu",
    "intensity_readout": "intensity_readout.cu",
}
HEADERS = ("common.cuh",)
# no --use_fast_math: its __sincosf breaks the 1e-5 parity as |theta| grows
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# C type of an exported argument or result -> its ctypes type.  The
# signatures are read from the sources' `extern "C"` prototypes, so the
# argument list that ctypes converts has one definition: the .cu file.
C_TYPES = {
    "void*": ctypes.c_void_p,
    "const void*": ctypes.c_void_p,
    "int64_t": ctypes.c_int64,
    "float": ctypes.c_float,
    "int": ctypes.c_int,
    "const char*": ctypes.c_char_p,
}
_EXTERN = re.compile(
    r'extern\s+"C"\s+((?:const\s+)?\w+\s*\**)\s*(\w+)\s*\(([^)]*)\)')


def _c_type(decl: str, what: str):
    t = re.sub(r"\s*\*", "*", " ".join(decl.split()))
    if t not in C_TYPES:
        raise RuntimeError(f"{what}: C type {t!r} has no ctypes mapping")
    return C_TYPES[t]


def exported_signatures(text: str) -> dict:
    """``{name: (argtypes, restype)}`` of every ``extern "C"`` function."""
    sigs = {}
    for ret, name, args in _EXTERN.findall(text):
        argtypes = []
        for i, arg in enumerate(a.strip() for a in args.split(",")):
            if not arg or arg == "void":
                continue
            m = re.fullmatch(r"(.+?)\s*\b\w+", arg, re.S)
            if m is None:
                raise RuntimeError(f"{name}: cannot read argument {i} {arg!r}")
            argtypes.append(_c_type(m.group(1), f"{name} argument {i}"))
        sigs[name] = (argtypes, _c_type(ret, f"{name} result"))
    return sigs


def source_signatures(name: str) -> dict:
    """The exported signatures of source ``name`` and the headers it uses."""
    text = "\n".join((CSRC / f).read_text()
                     for f in (SOURCES[name],) + HEADERS)
    return exported_signatures(text)


_LOCK = threading.Lock()
_LIBS: dict = {}
BUILD_LOG: dict = {}  # name -> nvcc/ptxas output of the last build


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the port's "
        "kernels build from csrc/ at first use on the card"
    )


def _target(name: str) -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (SOURCES[name],) + HEADERS:
        h.update((CSRC / f).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _load(name: str, path: pathlib.Path):
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in source_signatures(name).items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return lib


def build_all() -> float:
    """Build (or reuse) and load every kernel library; returns seconds."""
    t0 = time.perf_counter()
    with _LOCK:
        todo = [n for n in SOURCES if n not in _LIBS]
        if not todo:
            return 0.0
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for name in todo:
            out = _target(name)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / SOURCES[name])]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            BUILD_LOG[name] = log
            if proc.returncode != 0:
                failed.append(f"{SOURCES[name]} (exit {proc.returncode}):\n"
                              f"{log}")
                continue
            os.replace(tmp, out)  # atomic: concurrent builders never
            # load a half-written library
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for name in todo:
            _LIBS[name] = _load(name, _target(name))
    return time.perf_counter() - t0


def library(name: str):
    """The loaded library ``name``, building every kernel at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all()
        lib = _LIBS[name]
    return lib


def check(lib, code: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({code})")
