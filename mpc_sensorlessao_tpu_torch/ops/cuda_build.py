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

from ..utils import profiling

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_loaded: dict[str, ctypes.CDLL] = {}
# nvcc runs in this process: 0 while every library comes from the cache
compiles = 0


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


def _nvcc(name: str, out: str, ptxas_info: bool) -> str:
    """Compile csrc/<name>.cu into the library ``out``; returns nvcc's
    diagnostic output, raises on a failed build."""
    cmd = [nvcc_path(), *NVCC_FLAGS]
    if ptxas_info:
        cmd += ["-Xptxas", "-v"]
    cmd += ["-o", out, str(CSRC / f"{name}.cu")]
    global compiles
    compiles += 1
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {name}.cu:\n"
                           f"{proc.stderr}{proc.stdout}")
    return proc.stderr + proc.stdout


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
    try:
        log = _nvcc(name, tmp, ptxas_info)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, log


def ptxas_report(name: str) -> str:
    """nvcc's per-kernel register, stack and spill report (``-Xptxas
    -v``) for csrc/<name>.cu, from a build into a temporary directory: a
    cached library has none to give."""
    with tempfile.TemporaryDirectory() as tmp:
        return _nvcc(name, os.path.join(tmp, f"lib{name}.so"), True)


def ptxas_resources(report: str) -> dict:
    """{kernel's mangled name: {"registers", "stack", "spill_stores",
    "spill_loads"}} (bytes but the registers) read from a ``-Xptxas -v``
    report."""
    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            out[name].update(stack=int(m[1]), spill_stores=int(m[2]),
                             spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m[1])
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        with profiling.span("setup.kernels"):
            lib = ctypes.CDLL(str(build(name)[0]))
        _loaded[name] = lib
    return lib


def function(name: str, argtypes: list, entry: str | None = None):
    """The C entry point ``entry`` (default ``name``) of csrc/<name>.cu,
    which returns a cudaError_t as int, as a call that raises
    RuntimeError on a non-zero code, named by the library's
    ``<entry>_error_string``."""
    lib = load(name)
    entry = entry or name
    fn, err_string = (getattr(lib, entry),
                      getattr(lib, f"{entry}_error_string"))
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        err_string.argtypes = [ctypes.c_int]
        err_string.restype = ctypes.c_char_p

    def call(*args) -> None:
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"{entry} launch failed: "
                               f"{err_string(err).decode()} ({err})")
    return call
