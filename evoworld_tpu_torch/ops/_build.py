"""Build the package's native sources and load them with ctypes.

Each source under `evoworld_tpu_torch/csrc/` becomes one shared library with
a plain C interface in `build/torch_kernels/<hash>/` at the root of the
checkout, keyed by a hash of the sources and the flags: a CUDA source (.cu)
with nvcc for sm_90a, a C++ source (.cpp, the image IO) with g++ against
zlib. Nothing is built when a module is imported: the first call builds.
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
# No contraction into fused multiply-adds: the image IO's float arithmetic
# must round as its counterparts' does (tests/test_torch_port_cli.py).
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off", "-pthread")
GXX_LIBS = ("-lz",)

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
        if f.suffix in (".cu", ".cuh", ".h", ".cpp"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS + GXX_FLAGS + GXX_LIBS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{Path(source).stem}.so"


def build_log(source: str) -> str:
    """The compiler's output for `source` (for a CUDA source, ptxas's register
    and shared-memory report)."""
    log = _lib_path(source).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `source`, compiled first unless it exists."""
    lib = _loaded.get(source)
    if lib is not None:
        return lib
    out = _lib_path(source)
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = out.with_suffix(".log")
        with open(log, "w") as fh:
            if source.endswith(".cpp"):
                cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(CSRC / source), *GXX_LIBS]
            else:
                cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
            rc = subprocess.run(cmd, stdout=fh, stderr=subprocess.STDOUT, check=False).returncode
        if rc != 0:
            raise RuntimeError(f"{cmd[0]} failed ({rc}) for {out.name}:\n{log.read_text()}")
        os.replace(tmp, out)  # atomic: a concurrent builder sees all or nothing
    lib = _loaded[source] = ctypes.CDLL(str(out))
    return lib
