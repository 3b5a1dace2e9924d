"""Where the PSF kernels' time goes, by knock-out builds, on one CUDA card;
and the A/B of the chain kernels against a parent tree.

    python -m mpc_sensorlessao_tpu_torch.benchmarks.bf16_knockouts \
        [R] [B] [out.json] [--designs D,...] [--parent DIR [--bitwise |
        --chains]]

Builds copies of ``csrc/`` in a temporary directory, each with one part
of a kernel knocked out (its results are then wrong: only the time is
read), and times every build's entry points of its design at R, B
(defaults 128, 4096: the main path's) with 31-px crops on the kernel
A/B's inputs (``kernel_variants.inputs``: B1, B2 and B4 on the B
scenarios, B3 on the 3 B total phases), in two turns, with CUDA events
(``profiling.cuda_time_ms``, 20 calls).  A part's cost is the full
build's time less its knock-out's; parts overlap, so they need not sum
to the whole.  ``--designs`` takes some of the four designs, the first
and third of which are the retired mma.sync engine (``psf_mma.cuh`` with
the field policy ``psf_sym3.cuh``) and build only from ``--parent DIR``:

  old, the mma.sync engine in bf16 (Precision::kBf16), timed on the
  parent's ``psf_div3_sym_thin_bf16`` (b4: B4 bf16 there, B1 bf16's old
  instantiation):
    sincosf        the field forming's sincosf (a cheap stand-in)
    fragments      the shared-memory fragment loads and their bf16
                   rounding (fragments made from addresses)
    rounding       the rounding alone (cvt.rn.bf16x2 -> a bit mix)
    mma            the mma.sync instructions (a bit mix in their place)
    barriers       the two __syncthreads of each of its steps
  new, the wgmma engine ``psf_wgmma.cuh`` in bf16, timed on its three
  policies' entries ``psf_div3_sym_bf16`` (b1), ``psf_div_bf16`` (b2) and
  ``psf_crop_bf16`` (b3):
    sincosf        as above, in each policy's forming
    forming        the whole field forming (T left as it is)
    stage1         stage 1's wgmma
    loads          the TMA copies (the stages arrive empty)
    skeleton       forming and loads both out: wgmma, waits, epilogues
  f32old, the mma.sync engine in 3xTF32, timed on the parent's
  ``psf_div3_sym_thin`` (b4f: B4 float32 there, the old design of B1-B4
  float32):
    sincosf        as above
    splits         the TF32 hi/lo splits (a bit mix in their place)
    fragments      the shared-memory fragment loads
    mma            the mma.sync instructions
    barriers       as above
    gstore         the store of each strip's stage-1 rows to shared
                   memory (behind a condition never true)
  f32new, the wgmma engine in 3xTF32 (``block_tf32``), timed on its
  three policies' float32 entries ``psf_div3_sym`` (b1f), ``psf_div``
  (b2f) and ``psf_crop`` (b3f):
    sincosf, forming, stage1, loads, skeleton   as for new
    splits         the TF32 hi/lo splits of the forming
    stage2         stage 2's wgmma (the fragments kept live)
    stages3        at most 3 ring stages: B1's 4 cut to the 3 that B2's
                   and B3's larger stages leave room for (no change for
                   those two; a negative cost is time that 3 stages lose)

Without ``--parent`` the designs are new and f32new, on the current
``csrc/``, where every kernel runs the wgmma engine (B4 on B1's policy:
its timings would be B1's); asking for old or f32old there is refused.
``--parent DIR`` copies DIR -- the ``csrc/`` of a checkout whose B4
still runs the mma.sync engine, for example a ``git archive`` of commit
19f54fa (``OLD_ENGINE_COMMIT``) -- and times the old and f32old builds
on its b4 and b4f.  With ``--bitwise`` it times nothing: it builds each
library whole from DIR and from ``csrc/``, runs the entries of b1, b2,
b3 (bf16) and b1f, b2f, b3f (float32) once each on the same inputs and
reports ``<tag>_bits_equal`` (the two outputs hold the same bits) and
``<tag>_max_abs_diff``.  With ``--chains`` it times the chain kernels
B5a and B5b (``CHAIN_LIBS``) built whole from DIR -- for B5b's cosf link,
a ``git archive`` of 47c9e2e, the last commit that holds it -- and from
``csrc/`` on the device-peaks run's input (``device_peaks.KERNEL_SHAPE``
of 0.7) at depths k1 and k2, in turns parent, change, change, parent
(``<lib>_<side>_k<k>_ms``, one time a turn), and reports each library's
``<lib>_max_abs_diff_k<k>`` between the two builds on U(-3, 3) at k = 1
and k2; R and B are not read.

Prints one JSON line -- ``<build>_<entry>_ms`` (each build's two times,
e.g. ``old_full_b4_ms``), ``<build>_<entry>_cost_ms`` (a part's cost,
from each build's faster turn, e.g. ``new_sincosf_b2_cost_ms``), ``R``,
``B``, ``w``, ``csrc``, ``card`` -- and writes it to ``out.json`` where
given.  Raises without a CUDA device.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from ..ops import cuda_build, psf_kernels
from ..utils import profiling
from . import device_peaks, kernel_variants

# entry tag -> (library, entry point): the bf16 entries, then (tags
# ending in "f") the float32 ones
ENTRIES = {
    "b1": ("psf_div3_sym", "psf_div3_sym_bf16"),
    "b2": ("psf_div", "psf_div_bf16"),
    "b3": ("psf_crop", "psf_crop_bf16"),
    "b4": ("psf_div3_sym_thin", "psf_div3_sym_thin_bf16"),
    "b1f": ("psf_div3_sym", "psf_div3_sym"),
    "b2f": ("psf_div", "psf_div"),
    "b3f": ("psf_crop", "psf_crop"),
    "b4f": ("psf_div3_sym_thin", "psf_div3_sym_thin"),
}
# the entries each design's builds are timed on, in the current csrc/
DESIGN_ENTRIES = {"new": ("b1", "b2", "b3"), "f32new": ("b1f", "b2f", "b3f")}
# the designs of the retired mma.sync engine and their entries, in a
# parent checkout (--parent) whose B4 still runs it
PARENT_ENTRIES = {"old": ("b4",), "f32old": ("b4f",)}
# the last commit whose csrc/ holds the mma.sync engine
OLD_ENGINE_COMMIT = "19f54fa"
# the entries --bitwise holds to the parent's: those on the wgmma engine
# in both trees
BITWISE_TAGS = ("b1", "b2", "b3", "b1f", "b2f", "b3f")
# the chain kernels --chains times against the parent's (B5b, B5a)
CHAIN_LIBS = ("transc_cos", "transc_sincos")
CHAIN_TURNS = ("parent", "change", "change", "parent")

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
_MMA_TF32 = """  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));"""
# the mma.sync engine's fragment loads from shared memory (a parent's
# psf_mma.cuh), made from
# addresses instead (either precision)
_OLD_LOADS = [
    ("psf_mma.cuh",
     "v[V * r + e] = p[(r % 2) * 8 * kStride + 4 * (e + V * (r / 2))];",
     f"v[V * r + e] = make_float2(__uint_as_float({_SHARED} + 8 * r + "
     "e), 1.f);"),
    ("psf_mma.cuh",
     "for (int e = 0; e < V; ++e) v[V * r + e] = p[4 * (e + V * r) * "
     "k_stride];",
     "for (int e = 0; e < V; ++e) v[V * r + e] = make_float2("
     f"__uint_as_float({_SHARED} + k_stride * r + e), 1.f);")]
# the two __syncthreads of each of its steps
_OLD_BARRIERS = [
    ("psf_mma.cuh", "    // fbuf ready; raw and the other ring slot are "
     "free\n    __syncthreads();", ""),
    ("psf_mma.cuh", '    asm volatile("cp.async.wait_group 0;" ::: '
     '"memory");\n    __syncthreads();\n  }',
     '    asm volatile("cp.async.wait_group 0;" ::: "memory");\n  }')]
# the store of a strip's stage-1 rows G to shared memory (kept behind a
# condition the compiler cannot decide, so that G stays computed)
_G_STORE = """        row[0] = make_float4(g_re[j][0], g_im[j][0], g_re[j][1], g_im[j][1]);
        row[4 * kStride] =
            make_float4(g_re[j][2], g_im[j][2], g_re[j][3], g_im[j][3]);"""
_FORM = "          P::form(st, st + own, tb, fy, fxg);\n"
_FORM_TF32 = "          P::form(mp, mp + own, tb, fy, fxg);\n"
_NO_LOADS = [
    ("psf_wgmma.cuh", "mbar_expect_tx(&full[stage], kStageBytes);\n"
     "#pragma unroll", "mbar_expect_tx(&full[stage], 0);\n#pragma unroll"),
    ("psf_wgmma.cuh",
     "int c0, int c1, int c2, uint64_t* b) {\n  asm volatile(",
     "int c0, int c1, int c2, uint64_t* b) {\n  return;\n  asm volatile("),
]
_NO_LOADS_TF32 = [
    ("psf_wgmma.cuh", "mbar_expect_tx(&full[stage], kStageBytes);\n"
     "              bulk_copy(dst, a.rows + kc * kOpTile, kOpTile, "
     "&full[stage]);", "mbar_expect_tx(&full[stage], 0);"),
    _NO_LOADS[1]]

# the sincosf of the wgmma engine's three policies' bf16 forming (sym3's
# and crop's also of their 3xTF32 forming)
_NEW_SINCOSF = [
    ("psf_wgmma_sym3.cuh", "sincosf(ph[e], &s, &c);",
     "s = ph[e]; c = 1.f - ph[e];"),
    ("psf_div.cu", "sincosf(ph[e], &s, &c);",
     "s = ph[e]; c = 1.f - ph[e];"),
    ("psf_crop.cu", "sincosf(ph[j * kMapTile + e], &s, &c);",
     "s = ph[j * kMapTile + e]; c = 1.f - s;")]

# build -> [(file, text, replacement)]; the old and f32old builds patch a
# parent's csrc/ (PARENT_ENTRIES)
BUILDS = {
    "old_full": [],
    "old_sincosf": [
        ("psf_sym3.cuh", "sincosf(m[0], &s, &c);",
         "s = m[0]; c = 1.f - m[0];")],
    "old_fragments": [("psf_mma.cuh", _FRAG, _MIX)] + _OLD_LOADS,
    "old_rounding": [("psf_mma.cuh", _FRAG, _MIX)],
    "old_mma": [
        ("psf_mma.cuh", _MMA_BF16,
         "  c[0] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] ^ b[0] ^ "
         "b[1]);")],
    "old_barriers": _OLD_BARRIERS,
    "new_full": [],
    "new_sincosf": _NEW_SINCOSF,
    "new_forming": [("psf_wgmma.cuh", _FORM, "")],
    "new_stage1": [
        ("psf_wgmma.cuh",
         "            wgmma_n96(S, a1 + slice(4 * kc + j), bt + j * kStep,\n"
         "                      kc > 0 || j > 0);",
         "            S[j] += 1.f;")],
    "new_loads": _NO_LOADS,
    "new_skeleton": [("psf_wgmma.cuh", _FORM, "")] + _NO_LOADS,
    "f32old_full": [],
    "f32old_sincosf": [
        ("psf_sym3.cuh", "sincosf(m[0], &s, &c);",
         "s = m[0]; c = 1.f - m[0];")],
    "f32old_splits": [
        ("psf_mma.cuh",
         "  hi = tf32_rna(__float_as_uint(x));\n"
         "  lo = tf32_rna(__float_as_uint(x - __uint_as_float(hi)));",
         "  hi = __float_as_uint(x);\n  lo = hi ^ 0x1000u;")],
    "f32old_fragments": _OLD_LOADS,
    "f32old_mma": [
        ("psf_mma.cuh", _MMA_TF32,
         "  c[0] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3] ^ b[0] ^ "
         "b[1]);")],
    "f32old_barriers": _OLD_BARRIERS,
    "f32old_gstore": [("psf_mma.cuh", _G_STORE,
                       "        if (scale < 0.f) {\n" + _G_STORE + "\n"
                       "        }")],
    "f32new_full": [],
    "f32new_sincosf": [
        _NEW_SINCOSF[0],
        ("psf_div.cu", "sincosf(ph[e], &s[h], &c[h]);",
         "s[h] = ph[e]; c[h] = 1.f - ph[e];"),
        _NEW_SINCOSF[2]],
    "f32new_splits": [
        ("psf_wgmma.cuh",
         "  for (int h = 0; h < 4; ++h) split(v[h], hi[h], lo[h]);",
         "  for (int h = 0; h < 4; ++h) {\n"
         "    hi[h] = __float_as_uint(v[h]);\n"
         "    lo[h] = hi[h] ^ 0x1000u;\n  }")],
    "f32new_forming": [("psf_wgmma.cuh", _FORM_TF32, "")],
    "f32new_stage1": [
        ("psf_wgmma.cuh",
         "            wgmma_tf32_n96(C, ak + kOpLo, bk, 1);          // lo * hi\n"
         "            wgmma_tf32_n96(C, ak, bk + kTLo, 1);           // hi * lo\n"
         "            wgmma_tf32_n96(S, ak, bk, 1);                  // hi * hi",
         "            S[j] += 1.f;\n            C[j] += 1.f;")],
    "f32new_stage2": [
        ("psf_wgmma.cuh",
         "            wgmma_rs_tf32_n64(Pd, lo[d][h], bh, 1);        // lo * hi\n"
         "            wgmma_rs_tf32_n64(Pd, hi[d][h], bh + kColLo, 1);   // hi * lo\n"
         "            wgmma_rs_tf32_n64(Pd, hi[d][h], bh, 1);        // hi * hi",
         "            Pd[h] += __uint_as_float(hi[d][h][0] ^ lo[d][h][1] ^ "
         "hi[d][h][2] ^ lo[d][h][3]);")],
    "f32new_loads": _NO_LOADS_TF32,
    "f32new_skeleton": [("psf_wgmma.cuh", _FORM_TF32, "")] + _NO_LOADS_TF32,
    "f32new_stages3": [
        ("psf_wgmma.cuh",
         "return static_cast<int>(fit < kMaxStages ? fit : kMaxStages);",
         "return static_cast<int>(fit < 3 ? fit : 3);")],
}


def parent_only(design: str) -> str:
    """Why ``design`` cannot build from the current csrc/."""
    return (f"the {design} design is the retired mma.sync engine "
            "(psf_mma.cuh): it builds only from --parent DIR, the csrc/ of "
            "a checkout that still holds it, e.g. a git archive of "
            f"{OLD_ENGINE_COMMIT}")


def patched_sources(build: str, root: Path,
                    csrc: Path = cuda_build.CSRC,
                    parent: bool = False) -> Path:
    """A copy of ``csrc`` under ``root`` with ``build``'s knock-outs;
    raises if ``build`` is of a PARENT_ENTRIES design and ``csrc`` is not
    a ``parent`` checkout's, or if a knocked-out text is not in the
    sources once."""
    design = build.split("_", 1)[0]
    if design in PARENT_ENTRIES and not parent:
        raise ValueError(f"{build}: {parent_only(design)}")
    dest = root / build
    shutil.copytree(csrc, dest)
    for name, text, new in BUILDS[build]:
        src = (dest / name).read_text()
        if src.count(text) != 1:
            raise ValueError(f"{build}: {name} does not hold its knock-out "
                             f"text once: {text[:60]!r}")
        (dest / name).write_text(src.replace(text, new))
    return dest


def _build(build: str, lib: str, src: Path) -> Path:
    out = src.parent / f"lib{lib}_{build}.so"
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                           "-o", str(out), str(src / f"{lib}.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {build} {lib}:\n{proc.stderr}")
    return out


def _arguments(tag: str, inp: dict):
    """(phase, other maps, counts, output shape) of entry ``tag`` on the
    kernel A/B's inputs, as psf_kernels' wrappers pass them."""
    p, pup = inp["phase"], inp["pupil"]
    B, w = p.shape[0], inp["dft_op"].shape[0]
    if tag.rstrip("f") in ("b1", "b4"):
        maps = psf_kernels._sym3_maps(p, pup, inp["cos_a"], inp["sin_a"])
        return p, [m for _, m, _ in maps], (), (B, 3, w, w)
    if tag.rstrip("f") == "b2":
        return (p, [(pup * inp["div_cos"]).contiguous(),
                    (pup * inp["div_sin"]).contiguous()], (3,), (B, 3, w, w))
    return inp["total"], [pup], (), (3 * B, w, w)


def _caller(path: Path, tag: str, inp: dict):
    """A call of entry ``tag`` in the library at ``path``, as
    psf_kernels._launch makes it."""
    entry = ENTRIES[tag][1]
    phase, maps, counts, shape = _arguments(tag, inp)
    op = inp["dft_op"]
    B, R, w = phase.shape[0], phase.shape[-1], op.shape[0]
    a_ri = torch.view_as_real(op).permute(2, 0, 1).contiguous()
    out = torch.empty(shape, device=phase.device)
    scratch = torch.empty(psf_kernels._operator_scratch(R, w),
                          device=phase.device)
    tensors = (phase, *maps, a_ri[0], a_ri[1], scratch, out)
    ints = (B, *counts, R, w)
    fn = getattr(ctypes.CDLL(str(path)), entry)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * len(tensors)
                   + [ctypes.c_int] * len(ints)
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    ptrs = [t.data_ptr() for t in tensors]

    def call():
        err = fn(*ptrs, *ints, kernel_variants.SCALE, phase.device.index,
                 torch.cuda.current_stream(phase.device).cuda_stream)
        if err:
            raise RuntimeError(f"{path.name} {entry} failed: {err}")
    call.tensors = tensors      # alive while ptrs are used
    return call


def run(R: int = 128, B: int = 4096, parent: Path | None = None,
        designs: tuple | None = None) -> dict:
    """Each build of ``designs`` (default: all of DESIGN_ENTRIES, or of
    PARENT_ENTRIES with ``parent``) timed on its design's entries."""
    if not torch.cuda.is_available():
        raise RuntimeError("the knock-out split needs a CUDA device")
    csrc = cuda_build.CSRC if parent is None else Path(parent)
    entries = {d: tags for d, tags in
               (DESIGN_ENTRIES if parent is None else PARENT_ENTRIES).items()
               if designs is None or d in designs}
    builds = [b for b in BUILDS if b.split("_", 1)[0] in entries]
    inp = kernel_variants.inputs(R, B, "cuda")
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        srcs = {b: patched_sources(b, root, csrc, parent is not None)
                for b in builds}
        jobs = [(b, tag) for b in builds for tag in entries[b.split("_")[0]]]
        with concurrent.futures.ThreadPoolExecutor(16) as pool:
            paths = dict(zip(jobs, pool.map(
                lambda j: _build(j[0], ENTRIES[j[1]][0], srcs[j[0]]),
                jobs)))
        calls = {j: _caller(paths[j], j[1], inp) for j in jobs}
        times = {j: [] for j in jobs}
        for _ in range(2):
            for j, call in calls.items():
                times[j].append(profiling.cuda_time_ms(call, 20))
    out = {"R": R, "B": B, "w": kernel_variants.CROP, "csrc": str(csrc)}
    for (b, tag), t in times.items():
        out[f"{b}_{tag}_ms"] = t
    for (b, tag), t in times.items():
        design, part = b.split("_", 1)
        if part != "full":
            full = min(times[(f"{design}_full", tag)])
            out[f"{b}_{tag}_cost_ms"] = full - min(t)
    return out


def bitwise(parent: Path, R: int = 128, B: int = 4096,
            tags: tuple = BITWISE_TAGS) -> dict:
    """Whether each entry of ``tags`` built whole from ``parent`` and from
    csrc/ gives the same bits on the A/B's inputs at R, B."""
    if not torch.cuda.is_available():
        raise RuntimeError("the bitwise comparison needs a CUDA device")
    inp = kernel_variants.inputs(R, B, "cuda")
    out = {"R": R, "B": B, "w": kernel_variants.CROP, "csrc": str(parent)}
    with tempfile.TemporaryDirectory() as tmp:
        paths = _build_sides(parent, sorted({ENTRIES[tag][0]
                                             for tag in tags}), tmp)
        for tag in tags:
            got = []
            for side in ("parent", "change"):
                call = _caller(paths[(side, ENTRIES[tag][0])], tag, inp)
                call()
                torch.cuda.synchronize()
                got.append(call.tensors[-1].clone())
            out[f"{tag}_bits_equal"] = torch.equal(got[0].view(torch.int32),
                                                   got[1].view(torch.int32))
            out[f"{tag}_max_abs_diff"] = float((got[0] - got[1]).abs().max())
    return out


def _build_sides(parent: Path, libs, tmp: str) -> dict:
    """{(side, lib): library} of each of ``libs`` built whole from
    ``parent`` and from csrc/, all at once."""
    sides = {"parent": Path(parent), "change": cuda_build.CSRC}
    jobs = [(side, lib) for side in sides for lib in libs]

    def build(job):
        side, lib = job
        dest = Path(tmp) / f"{side}_{lib}"
        shutil.copytree(sides[side], dest)
        return _build(side, lib, dest)

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        return dict(zip(jobs, pool.map(build, jobs)))


def _chain_caller(path: Path, lib: str, x: torch.Tensor, k: int):
    """A call of chain kernel ``lib`` in the library at ``path`` on x at
    depth k, as device_peaks._launch makes it; the output is
    ``call.out``."""
    fn = getattr(ctypes.CDLL(str(path)), lib)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = torch.empty_like(x)

    def call():
        err = fn(x.data_ptr(), out.data_ptr(), x.numel(), k,
                 x.device.index, torch.cuda.current_stream(x.device)
                 .cuda_stream)
        if err:
            raise RuntimeError(f"{path.name} {lib} failed: {err}")
    call.out = out
    return call


def chains(parent: Path, reps: int = 20) -> dict:
    """B5a and B5b built from ``parent`` and from csrc/, timed in
    CHAIN_TURNS at depths K1 and K2, and their outputs' largest
    difference on U(-3, 3)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the chain A/B needs a CUDA device")
    shape, ks = device_peaks.KERNEL_SHAPE, (device_peaks.K1, device_peaks.K2)
    x = torch.full(shape, 0.7, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    u = torch.rand(shape, generator=gen, device="cuda") * 6 - 3
    out = {"shape": list(shape), "csrc": str(parent),
           "turns": list(CHAIN_TURNS)}
    with tempfile.TemporaryDirectory() as tmp:
        paths = _build_sides(parent, CHAIN_LIBS, tmp)
        for lib in CHAIN_LIBS:
            for k in (1, ks[1]):
                got = []
                for side in ("parent", "change"):
                    call = _chain_caller(paths[(side, lib)], lib, u, k)
                    call()
                    got.append(call.out)
                torch.cuda.synchronize()
                out[f"{lib}_max_abs_diff_k{k}"] = float(
                    (got[0] - got[1]).abs().max())
        calls = {(side, lib, k): _chain_caller(paths[(side, lib)], lib, x, k)
                 for side in ("parent", "change") for lib in CHAIN_LIBS
                 for k in ks}
        for side in CHAIN_TURNS:
            for lib in CHAIN_LIBS:
                for k in ks:
                    out.setdefault(f"{lib}_{side}_k{k}_ms", []).append(
                        profiling.cuda_time_ms(calls[(side, lib, k)], reps))
    return out


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("R", nargs="?", type=int, default=128)
    ap.add_argument("B", nargs="?", type=int, default=4096)
    ap.add_argument("out", nargs="?")
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--bitwise", action="store_true")
    ap.add_argument("--chains", action="store_true")
    ap.add_argument("--designs", help="comma-separated designs to time "
                    "(default: every design of the sources)")
    args = ap.parse_args(argv)
    if (args.bitwise or args.chains) and args.parent is None:
        ap.error("--bitwise and --chains compare with a --parent DIR")
    if args.bitwise and args.chains:
        ap.error("--bitwise and --chains are two runs")
    for design in (args.designs or "").split(","):
        if design in PARENT_ENTRIES and args.parent is None:
            ap.error(parent_only(design))
    if args.chains:
        out = chains(args.parent)
    elif args.bitwise:
        out = bitwise(args.parent, args.R, args.B)
    else:
        out = run(args.R, args.B, args.parent,
                  args.designs and tuple(args.designs.split(",")))
    out["card"] = profiling.card()
    line = json.dumps(out)
    print(line)
    if args.out:
        Path(args.out).write_text(line + "\n")


if __name__ == "__main__":
    main()
