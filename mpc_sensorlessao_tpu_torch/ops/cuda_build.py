"""Build and load the port's CUDA sources.

Each ``csrc/<name>.cu`` exposes a plain C interface.  At first use it is
compiled by ``nvcc`` for Hopper (sm_90a) into a shared library under the
repository's ``build/kernels/`` directory, named by a hash of its source,
the ``csrc/`` headers it includes and the flags (an edited source or
header builds anew; an unchanged one is reused), and loaded with ctypes.  Nothing here
runs at import time: this module is imported on machines without a GPU
or nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc on PATH, else under $CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cand = home / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: building the CUDA kernels needs the "
                       "CUDA toolkit (nvcc on PATH or under CUDA_HOME)")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = sorted(set(re.findall(rb'#include\s+"([^"]+)"', src)))
    src += b"".join((CSRC / h.decode()).read_bytes() for h in headers)
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str, ptxas_info: bool = False) -> tuple[Path, str]:
    """Compile csrc/<name>.cu unless its library exists.

    Returns (library path, nvcc's diagnostic output -- with
    ``ptxas_info`` the per-kernel register and shared-memory report --
    or "" when the cached library was reused).  The library is written
    under a temporary name and renamed into place, so concurrent builds
    never load a half-written file.
    """
    out = library_path(name)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, prefix=f".{name}-",
                               suffix=".so")
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS]
    if ptxas_info:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", tmp, str(CSRC / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on "
                               f"{name}.cu:\n{proc.stderr}{proc.stdout}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stderr + proc.stdout


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)[0]))
        _loaded[name] = lib
    return lib


def function(name: str, argtypes: list):
    """The C entry point ``name`` of csrc/<name>.cu, which returns a
    cudaError_t as int, as a call that raises RuntimeError on a non-zero
    code, named by the library's ``<name>_error_string``."""
    lib = load(name)
    fn, err_string = getattr(lib, name), getattr(lib, f"{name}_error_string")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err_string.argtypes = [ctypes.c_int]
        err_string.restype = ctypes.c_char_p

    def call(*args) -> None:
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{name} launch failed: "
                               f"{err_string(err).decode()} ({err})")
    return call
