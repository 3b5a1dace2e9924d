"""Where kernel B1's bf16 time goes, by knock-out builds, on one CUDA card.

    python -m mpc_sensorlessao_tpu_torch.benchmarks.bf16_knockouts [R] [B] [out.json]

Builds copies of ``csrc/`` in a temporary directory, each with one part
of a kernel knocked out (its results are then wrong: only the time is
read), and times every build's entry point at R, B (defaults 128, 4096:
the main path's) with 31-px crops on the kernel A/B's inputs
(``kernel_variants.inputs``), in two turns, with CUDA events
(``profiling.cuda_time_ms``, 20 calls).  A part's cost is the full
build's time less its knock-out's; parts overlap, so they need not sum
to the whole.

  old design, B1 bf16's mma.sync engine (``psf_mma.cuh``, Precision::
  kBf16) as ``psf_div3_sym_thin_bf16`` still runs it (B4 bf16 is B1
  bf16's old instantiation):
    sincosf        the field forming's sincosf (a cheap stand-in)
    fragments      the shared-memory fragment loads and their bf16
                   rounding (fragments made from addresses)
    rounding       the rounding alone (cvt.rn.bf16x2 -> a bit mix)
    mma            the mma.sync issue (a bit mix in its place)
    barriers       the two __syncthreads of each of its steps
  new design, ``psf_div3_sym_bf16`` on ``psf_wgmma.cuh``:
    sincosf        as above
    forming        the whole field forming (T left as it is)
    stage1         stage 1's wgmma
    loads          the TMA copies (the stages arrive empty)
    skeleton       forming and loads both out: wgmma, waits, epilogues

Prints one JSON line -- ``<build>_ms`` (each build's two times, e.g.
``old_full_ms``), ``<build>_cost_ms`` (a part's cost, from each build's
faster turn, e.g. ``new_sincosf_cost_ms``), ``R``, ``B``, ``w``, ``card``
-- and writes it to ``out.json`` where given.  Raises without a CUDA
device.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from ..ops import cuda_build, psf_kernels
from ..utils import profiling
from . import kernel_variants

_FRAG = ("re.v[r] = bf16x2(v[2 * r].x, v[2 * r + 1].x);\n"
         "      im.v[r] = bf16x2(v[2 * r].y, v[2 * r + 1].y);")
_MIX = ("re.v[r] = __float_as_uint(v[2 * r].x) ^ "
        "__float_as_uint(v[2 * r + 1].x);\n"
        "      im.v[r] = __float_as_uint(v[2 * r].y) ^ "
        "__float_as_uint(v[2 * r + 1].y);")
_SHARED = "static_cast<unsigned>(__cvta_generic_to_shared(p))"
_MMA_BF16 = """  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));"""
_FORM = "          form(st, st + (3 + wg) * kMapTile, tb, fy, fxg);\n"
_NO_LOADS = [
    ("psf_wgmma.cuh", "mbar_expect_tx(&full[stage], kStageBytes);",
     "mbar_expect_tx(&full[stage], 0);"),
    ("psf_wgmma.cuh", "int c0, int c1, uint64_t* b) {\n  asm volatile(",
     "int c0, int c1, uint64_t* b) {\n  return;\n  asm volatile("),
    ("psf_wgmma.cuh",
     "int c0, int c1, int c2, uint64_t* b) {\n  asm volatile(",
     "int c0, int c1, int c2, uint64_t* b) {\n  return;\n  asm volatile("),
]

# build -> (library, entry point, [(file, text, replacement)])
BUILDS = {
    "old_full": ("psf_div3_sym_thin", "psf_div3_sym_thin_bf16", []),
    "old_sincosf": ("psf_div3_sym_thin", "psf_div3_sym_thin_bf16", [
        ("psf_sym3.cuh", "sincosf(m[0], &s, &c);",
         "s = m[0]; c = 1.f - m[0];")]),
    "old_fragments": ("psf_div3_sym_thin", "psf_div3_sym_thin_bf16", [
        ("psf_mma.cuh", _FRAG, _MIX),
        ("psf_mma.cuh",
         "v[V * r + e] = p[(r % 2) * 8 * kStride + 4 * (e + V * (r / 2))];",
         f"v[V * r + e] = make_float2(__uint_as_float({_SHARED} + 8 * r + "
         "e), 1.f);"),
        ("psf_mma.cuh",
         "for (int e = 0; e < V; ++e) v[V * r + e] = p[4 * (e + V * r) * "
         "k_stride];",
         "for (int e = 0; e < V; ++e) v[V * r + e] = make_float2("
         f"__uint_as_float({_SHARED} + k_stride * r + e), 1.f);")]),
    "old_rounding": ("psf_div3_sym_thin", "psf_div3_sym_thin_bf16", [
        ("psf_mma.cuh", _FRAG, _MIX)]),
    "old_mma": ("psf_div3_sym_thin", "psf_div3_sym_thin_bf16", [
        ("psf_mma.cuh", _MMA_BF16,
         "  c[0] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] ^ b[0] ^ "
         "b[1]);")]),
    "old_barriers": ("psf_div3_sym_thin", "psf_div3_sym_thin_bf16", [
        ("psf_mma.cuh", "    // fbuf ready; raw and the other ring slot are "
         "free\n    __syncthreads();", ""),
        ("psf_mma.cuh", '    asm volatile("cp.async.wait_group 0;" ::: '
         '"memory");\n    __syncthreads();\n  }',
         '    asm volatile("cp.async.wait_group 0;" ::: "memory");\n  }')]),
    "new_full": ("psf_div3_sym", "psf_div3_sym_bf16", []),
    "new_sincosf": ("psf_div3_sym", "psf_div3_sym_bf16", [
        ("psf_wgmma.cuh", "sincosf(ph[e], &s, &c);",
         "s = ph[e]; c = 1.f - ph[e];")]),
    "new_forming": ("psf_div3_sym", "psf_div3_sym_bf16", [
        ("psf_wgmma.cuh", _FORM, "")]),
    "new_stage1": ("psf_div3_sym", "psf_div3_sym_bf16", [
        ("psf_wgmma.cuh",
         "            wgmma_n96(S, a1 + slice(4 * kc + j), bt + j * kStep,\n"
         "                      kc > 0 || j > 0);",
         "            S[j] += 1.f;")]),
    "new_loads": ("psf_div3_sym", "psf_div3_sym_bf16", _NO_LOADS),
    "new_skeleton": ("psf_div3_sym", "psf_div3_sym_bf16",
                     [("psf_wgmma.cuh", _FORM, "")] + _NO_LOADS),
}


def patched_sources(build: str, root: Path) -> Path:
    """A copy of csrc/ under ``root`` with ``build``'s knock-outs;
    raises if a knocked-out text is not in the sources."""
    dest = root / build
    shutil.copytree(cuda_build.CSRC, dest)
    for name, text, new in BUILDS[build][2]:
        src = (dest / name).read_text()
        if src.count(text) != 1:
            raise ValueError(f"{build}: {name} does not hold its knock-out "
                             f"text once: {text[:60]!r}")
        (dest / name).write_text(src.replace(text, new))
    return dest


def _build(build: str, root: Path) -> Path:
    lib = BUILDS[build][0]
    src = patched_sources(build, root)
    out = root / f"lib{lib}_{build}.so"
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                           "-o", str(out), str(src / f"{lib}.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {build}:\n{proc.stderr}")
    return out


def _caller(path: Path, entry: str, inp: dict):
    """A call of ``entry`` in the library at ``path`` on B1's inputs, as
    psf_kernels._launch makes it."""
    fn = getattr(ctypes.CDLL(str(path)), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    p, op = inp["phase"], inp["dft_op"]
    B, R, w = p.shape[0], p.shape[-1], op.shape[0]
    maps = psf_kernels._sym3_maps(p, inp["pupil"], inp["cos_a"],
                                  inp["sin_a"])
    a_ri = torch.view_as_real(op).permute(2, 0, 1).contiguous()
    out = torch.empty((B, 3, w, w), device=p.device)
    scratch = torch.empty(psf_kernels._operator_scratch(R, w),
                          device=p.device)
    ptrs = [t.data_ptr() for t in (p, *(m for _, m, _ in maps), a_ri[0],
                                   a_ri[1], scratch, out)]

    def call():
        err = fn(*ptrs, B, R, w, kernel_variants.SCALE, p.device.index,
                 torch.cuda.current_stream(p.device).cuda_stream)
        if err:
            raise RuntimeError(f"{path.name} {entry} failed: {err}")
    call.tensors = (maps, a_ri, scratch, out)   # alive while ptrs are used
    return call


def run(R: int = 128, B: int = 4096) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the knock-out split needs a CUDA device")
    inp = kernel_variants.inputs(R, B, "cuda")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        with concurrent.futures.ThreadPoolExecutor(len(BUILDS)) as pool:
            paths = dict(zip(BUILDS, pool.map(lambda b: _build(b, root),
                                               BUILDS)))
        calls = {b: _caller(paths[b], BUILDS[b][1], inp) for b in BUILDS}
        times = {b: [] for b in BUILDS}
        for _ in range(2):
            for b, call in calls.items():
                times[b].append(profiling.cuda_time_ms(call, 20))
    out = {"R": R, "B": B, "w": kernel_variants.CROP}
    for b, t in times.items():
        out[f"{b}_ms"] = t
    for b in BUILDS:
        design, part = b.split("_", 1)
        if part != "full":
            full = min(times[f"{design}_full"])
            out[f"{design}_{part}_cost_ms"] = full - min(times[b])
    return out


def main() -> None:
    R = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    B = int(sys.argv[2]) if len(sys.argv) > 2 else 4096
    out = run(R, B)
    out["card"] = profiling.card()
    line = json.dumps(out)
    print(line)
    if len(sys.argv) > 3:
        Path(sys.argv[3]).write_text(line + "\n")


if __name__ == "__main__":
    main()
