"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each source under `evoworld_tpu_torch/csrc/` becomes one shared library with
a plain C interface, compiled for sm_90a into `build/torch_kernels/<hash>/`
at the root of the checkout, keyed by a hash of the sources and the flags.
Nothing is built when a module is imported: the first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _lib_path(source: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):  # headers shared by sources count too
        if f.suffix in (".cu", ".cuh", ".h"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{Path(source).stem}.so"


def build_log(source: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) for `source`."""
    log = _lib_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `source`, compiled with nvcc first unless it exists."""
    lib = _loaded.get(source)
    if lib is not None:
        return lib
    out = _lib_path(source)
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = out.with_suffix(".log")
        with open(log, "w") as fh:
            rc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
                                stdout=fh, stderr=subprocess.STDOUT, check=False).returncode
        if rc != 0:
            raise RuntimeError(f"nvcc failed ({rc}) for {out.name}:\n{log.read_text()}")
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    lib = _loaded[source] = ctypes.CDLL(str(out))
    return lib
