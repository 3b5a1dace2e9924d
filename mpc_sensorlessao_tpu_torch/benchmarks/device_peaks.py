"""Measured ceilings of one CUDA card for the roofline (port of
``benchmarks/device_peaks.py``), and kernels B5a and B5b.

    python -m mpc_sensorlessao_tpu_torch.benchmarks.device_peaks [out.json]

Measures, on CUDA device 0, each time the median of repeats of CUDA
events around many calls (``profiling.cuda_time_ms``):

  matmul_f32     (4096, 4096) @ (4096, 4096) float32, TF32 off: the FP32
                 rate outside the tensor cores, the ceiling of B1-B4
  matmul_tf32    the same product with TF32 on (restored afterwards)
  matmul_bf16    the same product in bf16
  hbm            x.add_(1.0) over 2^28 floats, reads plus writes
  transc_cos     torch chains of k cos (2^25 elements), and of
  transc_exp     k exp(-v*v), each link its own kernels
  transc_cos_kernel     kernel B5b, k chained cos on (4096, 4096)
  transc_sincos_kernel  kernel B5a, k chained cos + 0.5 sin

Transcendental rates use the SLOPE method: rate = (k2 - k1) M / (t_k2 -
t_k1), for depths k1 = 8 and k2 = 32 over M elements.  The difference in
depth cancels the read and write of the array and the fixed cost of a
launch.  (In the torch chains every link is a kernel that reads and
writes the array, so their slope is the rate of eager PyTorch, bound by
memory; the kernels keep the chain in registers.)

Prints one JSON report -- one entry per measurement, ``peaks``,
``device`` (``torch.cuda.get_device_name``) and ``card`` (name and power
limit as nvidia-smi gives them) -- and writes it to ``out.json`` when a
path is given.  Raises without a CUDA device.

Kernels B5a ``transc_sincos_chain`` (csrc/transc_sincos.cu) and B5b
``transc_cos_chain`` (csrc/transc_cos.cu) launch their hand-written
kernel on a CUDA tensor (counted in ``<wrapper>.launches``) or raise; on
a CPU tensor they run their plain PyTorch version ``<wrapper>_ref``.
Their bound comes from the recorded instructions of one full-precision
link (``LINK_INSTRUCTIONS``); ``link_instructions`` reads a built link
from its SASS and ``pipe_ms`` times its pipes; ``cos_sweep`` holds B5b
on every float32 input to the float64 cosine.
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import cuda_build
from ..utils import profiling

N_MATMUL = 4096
M_HBM = 1 << 28
M_TRANSC = 1 << 25
KERNEL_SHAPE = (4096, 4096)
K1, K2 = 8, 32
REPS = 10


def transc_sincos_chain_ref(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of kernel B5a: k links of
    v = cos(v) + 0.5 sin(v)."""
    v = x
    for _ in range(k):
        v = torch.cos(v) + 0.5 * torch.sin(v)
    return v.clone() if k == 0 else v


def transc_cos_chain_ref(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch version of kernel B5b: k links of v = cos(v)."""
    v = x
    for _ in range(k):
        v = torch.cos(v)
    return v.clone() if k == 0 else v


def _launch(name: str, x: torch.Tensor, k: int) -> torch.Tensor:
    """Launch kernel library ``name`` on PyTorch's current stream: its C
    entry point takes (x, out, n, k, device, stream)."""
    if x.device.type != "cuda":
        raise ValueError(f"kernel {name} runs on CUDA tensors, got "
                         f"{x.device}")
    out = torch.empty_like(x)
    launch = cuda_build.function(
        name, [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
               ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    launch(x.data_ptr(), out.data_ptr(), x.numel(), k, x.device.index,
           torch.cuda.current_stream(x.device).cuda_stream)
    return out


def _check(x: torch.Tensor, k: int) -> None:
    """The inputs both kernels take: float32 (rows, cols), contiguous,
    k >= 0 -- checked on every device, so the CPU path takes what the
    card takes."""
    if x.dtype != torch.float32:
        raise TypeError(f"x must be float32, got {x.dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be (rows, cols), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if k < 0:
        raise ValueError(f"chain depth k must be >= 0, got {k}")


def transc_sincos_chain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Kernel B5a: k chained links v = cos(v) + 0.5 sin(v) on a float32
    (rows, cols) array."""
    _check(x, k)
    if x.device.type == "cpu":
        return transc_sincos_chain_ref(x, k)
    out = _launch("transc_sincos", x, k)
    transc_sincos_chain.launches += 1
    return out


def transc_cos_chain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Kernel B5b: k chained links v = cos(v) on a float32 (rows, cols)
    array."""
    _check(x, k)
    if x.device.type == "cpu":
        return transc_cos_chain_ref(x, k)
    out = _launch("transc_cos", x, k)
    transc_cos_chain.launches += 1
    return out


transc_sincos_chain.launches = 0
transc_cos_chain.launches = 0

# B5b's reduction limit (csrc/transc_cos.cu kBig): from |v| = 105615 on,
# and for infinities, a link is cosf's own
COS_BIG = 105615.0
SWEEP_CHUNK = 1 << 28


def _ulp_error(y: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """|y - ref| in float32 ulps of ref (float64): the float32 spacing of
    ref's binade, 2^-149 at least."""
    _, e = torch.frexp(ref)
    ulp = torch.ldexp(torch.ones_like(ref), e.clamp(min=-125) - 24)
    return (y.double() - ref).abs() / ulp


def cos_sweep(chunk: int = SWEEP_CHUNK) -> dict:
    """Kernel B5b at k = 1 on every float32 bit pattern, ``chunk``
    patterns a launch, on CUDA device 0.

    Returns ``patterns``; ``max_ulp`` (and its input ``max_ulp_at``) of
    the kernel over the finite inputs against torch.cos of the float64
    input, ``plain_max_ulp`` the same of the plain torch.cos; and counts
    that must be 0: ``finite_misses`` (finite inputs whose result is not
    finite), ``big_mismatches`` (|v| >= COS_BIG or infinite, whose result
    must be torch.cos's float32 cosf bit for bit, NaN equal to NaN),
    ``nan_misses`` (NaN or infinite inputs whose result is not NaN) and
    ``zero_misses`` (+-0 whose result is not 1)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the sweep needs a CUDA device")
    side = 1 << (chunk.bit_length() - 1) // 2
    out = {"patterns": 0, "max_ulp": 0.0, "max_ulp_at": None,
           "plain_max_ulp": 0.0, "finite_misses": 0, "big_mismatches": 0,
           "nan_misses": 0, "zero_misses": 0}
    for lo in range(-(1 << 31), 1 << 31, chunk):
        bits = torch.arange(lo, lo + chunk, device="cuda",
                            dtype=torch.int64).to(torch.int32)
        x = bits.view(torch.float32).view(-1, side)
        y = transc_cos_chain(x, 1)
        plain = torch.cos(x)
        finite = torch.isfinite(x)
        ref = torch.cos(x.double())
        for name, z in (("max_ulp", y), ("plain_max_ulp", plain)):
            err = _ulp_error(z, ref)
            if z is y:
                out["finite_misses"] += int((finite & ~err.isfinite()).sum())
            err = torch.where(finite & err.isfinite(), err, 0.0).view(-1)
            i = int(err.argmax())
            if float(err[i]) > out[name]:
                out[name] = float(err[i])
                if z is y:
                    out["max_ulp_at"] = float(x.view(-1)[i])
        del ref, err
        same = (y.view(torch.int32) == plain.view(torch.int32)) | (
            y.isnan() & plain.isnan())
        big = x.abs() >= COS_BIG
        out["big_mismatches"] += int((big & ~same).sum())
        out["nan_misses"] += int((~finite & ~y.isnan()).sum())
        out["zero_misses"] += int(((x == 0) & (y != 1.0)).sum())
        out["patterns"] += x.numel()
    return out


# Instructions per element and link of one full-precision link of each
# chain, counted with ``link_instructions`` in the sm_90a SASS of
# csrc/transc_sincos.cu (libdevice's sincosf) and of B5b's first build
# (libdevice's cosf) for the H100 (PERF.md §6): "fp32" the FP32
# instructions (FP32_OPCODES), "issued" every instruction.  They are the
# yardstick: the bound of a call is computed from these recorded counts,
# so it does not move with the build.
LINK_INSTRUCTIONS = {
    "transc_sincos": {"fp32": 19, "issued": 32},
    "transc_cos": {"fp32": 15, "issued": 26.5},
}
# The links as built now: B5a's is the yardstick's; B5b's own cos link
# (csrc/transc_cos.cu, PERF.md §6) does cosf's FP32 work in fewer
# issue slots.  tests/test_torch_cuda.py checks on the card that the
# built kernels need no more than this and use no MUFU.
BUILT_LINK_INSTRUCTIONS = {
    "transc_sincos": LINK_INSTRUCTIONS["transc_sincos"],
    "transc_cos": {"fp32": 15, "issued": 20.25},
}
# The opcode mix of the cosf link loop (4 elements) in B5b's first build,
# by ``link_instructions``: the yardstick's pipes (``pipe_ms``)
COSF_LINK = {"elements": 4, "by_opcode": {
    "FFMA": 36, "FMUL": 8, "FSEL": 12, "FSETP": 4, "IMAD": 10, "LOP3": 8,
    "VIADD": 5, "ISETP": 1, "F2I": 4, "I2FP": 4, "BRA": 5, "BSSY": 4,
    "BSYNC": 4, "ULDC": 1}}
# FP32 instructions of the SASS (conversions such as F2I go to another
# pipe and are not counted)
FP32_OPCODES = ("FFMA", "FMUL", "FADD", "FMNMX", "FSEL", "FSETP", "FSET",
                "FRND")
# The pipes a link's instructions issue to on the H100 (sm_90), with the
# lanes an SM has for each a clock (CUDA C++ Programming Guide, throughput
# of the native arithmetic instructions, compute capability 9.0): FP32
# add, multiply and FMA, and the integer multiply-add (IMAD, also the
# compiler's moves and shifts by multiplication), on the 128-lane FMA
# pipe; integer add, logic, shift and compare, and FP32 compare, min/max
# and select, on the 64-lane ALU; conversions and MUFU on 16.  Branches,
# convergence barriers and uniform-datapath loads use an issue slot and
# none of these.  VIADD and I2FP, Hopper forms the guide does not name,
# are taken as an integer add and a conversion.
PIPE_LANES = {"fma": 128, "alu": 64, "conversion": 16}
PIPE_OPCODES = {
    "fma": ("FFMA", "FADD", "FMUL", "IMAD", "IMUL"),
    "alu": ("FMNMX", "FSEL", "FSETP", "FSET", "LOP3", "IADD3", "VIADD",
            "SHF", "LEA", "ISETP", "SEL", "IMNMX", "PLOP3", "MOV"),
    "conversion": ("F2I", "I2F", "I2FP", "F2F", "FRND", "MUFU"),
}
_SASS_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def sass(name: str) -> str:
    """``cuobjdump -sass`` of the built library of csrc/<name>.cu."""
    cuobjdump = Path(cuda_build.nvcc_path()).parent / "cuobjdump"
    return subprocess.run(
        [str(cuobjdump), "-sass", str(cuda_build.build(name)[0])],
        capture_output=True, text=True, check=True, timeout=120).stdout


def sass_functions(sass_text: str) -> dict:
    """{mangled function name: its SASS} of a ``sass`` listing."""
    parts = re.split(r"^\s*Function : (\S+)\s*$", sass_text, flags=re.M)
    return dict(zip(parts[1::2], parts[2::2]))


def _check_elements(ins: list, at: int, operand: str) -> int:
    """The elements whose |v| ``operand`` of the instruction at address
    ``at`` holds: one for ``|R|``; for a register, the |R| leaves of the
    FMNMX tree that last wrote it (the max of the elements' |v|)."""
    if operand.startswith("|"):
        return 1
    write = next(((a, t) for a, t in reversed(ins) if a < at and
                  re.match(rf"\w+(?:\.\w+)* {operand},", t)), (0, ""))
    if not write[1].startswith("FMNMX"):
        return 1
    return sum(_check_elements(ins, write[0], x.strip())
               for x in write[1].split(",")[1:3])


def link_instructions(sass_text: str) -> dict:
    """Instructions per element and link of a chain kernel's SASS.

    The link loop is the innermost backward branch around the range
    checks of the range reduction (``FSETP.GE``, against 105615).  Each
    check's branch skips, for every |v| < 105615 (all the chain's values),
    the slow path of the reduction; those instructions are not counted,
    nor the checks inside them.  A check tests one element's |v| (B5a:
    one check per element the thread carries) or the max of several, made
    by FMNMX (B5b: one check for all of them); it counts for the
    elements it tests.  Returns ``issued`` (every instruction, each one
    issue slot of a warp scheduler), ``fp32`` (those in ``FP32_OPCODES``)
    -- both per element and link -- the element count and the counts by
    opcode.
    """
    ins = [(int(a, 16), t) for a, t in _SASS_INSTR.findall(sass_text)]
    checks = [(a, *re.search(r"FSETP\.GE\.AND (P\d), PT, (\|?R\d+\|?)",
                             t).groups())
              for a, t in ins if t.startswith("FSETP.GE.AND")
              and "105615" in t]
    loops = []
    for a, t in ins:
        m = re.match(r"(?:@!?P\d\s+)?BRA (0x[0-9a-f]+)", t)
        if m and int(m.group(1), 16) < a:
            lo = int(m.group(1), 16)
            if any(lo <= c < a for c, *_ in checks):
                loops.append((a - lo, lo, a))
    if not loops:
        raise ValueError("no link loop found in the SASS")
    _, lo, hi = min(loops)
    skips, n = [], 0
    for c, p, operand in checks:
        if not lo <= c < hi or any(b < c < e for b, e in skips):
            continue
        branch = next(((a, int(t.split()[-1], 16)) for a, t in ins
                       if a > c and re.match(rf"@!{p}\s+BRA 0x", t)), None)
        if branch is None:
            raise ValueError(f"no slow-path branch after the check at {c:#x}")
        skips.append(branch)
        n += _check_elements(ins, c, operand)
    by_op: dict[str, int] = {}
    for a, t in ins:
        if lo <= a <= hi and not any(b < a < e for b, e in skips):
            op = t.split()[1 if t.startswith("@") else 0].split(".")[0]
            by_op[op] = by_op.get(op, 0) + 1
    return {"elements": n, "issued": sum(by_op.values()) / n,
            "fp32": sum(by_op.get(o, 0) for o in FP32_OPCODES) / n,
            "by_opcode": by_op}


def _sm_clocks_per_s() -> tuple[int, float]:
    """(SMs, maximum SM clock in Hz) of CUDA device 0."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_hz = float(profiling.nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    return sms, clock_hz


def chain_bound(name: str, shape: tuple, k: int) -> dict:
    """Least time of one call of chain kernel ``name`` on a float32
    ``shape`` at depth k on CUDA device 0: the larger of its bytes (the
    array read once and written once) over the published HBM rate, and
    its FP32 instructions (``LINK_INSTRUCTIONS`` x k x elements) over the
    SMs' 128 FP32 lanes at the card's maximum SM clock.  Also gives the
    issue-slot time: every instruction of the link over the 4 x 32
    instructions an SM issues per clock."""
    m = math.prod(shape)
    per = LINK_INSTRUCTIONS[name]
    sms, clock_hz = _sm_clocks_per_s()
    lanes = sms * 128 * clock_hz
    kind = profiling.device_kind()
    t_bytes = 8.0 * m / profiling.DEVICE_PEAKS[kind]["hbm_bytes_per_s"]
    t_ops = per["fp32"] * k * m / lanes
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "ops_ms": 1e3 * t_ops, "bytes_ms": 1e3 * t_bytes,
            "issue_ms": 1e3 * per["issued"] * k * m / lanes,
            "sms": sms, "max_sm_clock_hz": clock_hz, **per}


def pipe_ms(link: dict, shape: tuple, k: int) -> dict:
    """Busy time of each pipe of PIPE_LANES, and the issue time (every
    instruction over the 4 x 32 an SM issues a clock), of one call at
    depth k on a float32 ``shape`` on CUDA device 0, for a link of opcode
    mix ``link`` (``link_instructions``' ``by_opcode`` over ``elements``)
    at the card's maximum SM clock; ``per_element`` gives each pipe's
    instructions per element and link, and ``other`` those of none."""
    sms, clock_hz = _sm_clocks_per_s()
    per = {pipe: sum(link["by_opcode"].get(o, 0) for o in ops)
           / link["elements"] for pipe, ops in PIPE_OPCODES.items()}
    issued = sum(link["by_opcode"].values()) / link["elements"]
    per["other"] = issued - sum(per.values())
    ms = 1e3 * k * math.prod(shape) / (sms * clock_hz)
    return {**{f"{pipe}_ms": per[pipe] * ms / lanes
               for pipe, lanes in PIPE_LANES.items()},
            "issue_ms": issued * ms / 128, "per_element": per}


def matmul_peak(dtype: torch.dtype, tf32: bool = False,
                n: int = N_MATMUL) -> dict:
    """Sustained FLOP/s of one dense (n, n) @ (n, n) product.  ``tf32``
    turns TF32 on for this measurement alone and restores the setting
    it found."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn((n, n), generator=gen, device="cuda").to(dtype)
    b = torch.randn((n, n), generator=gen, device="cuda").to(dtype)
    prior = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        ms = profiling.cuda_time_ms(lambda: a @ b, REPS)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prior
    return {"n": n, "dtype": str(dtype), "tf32": tf32, "ms": ms,
            "tflops": 2.0 * n ** 3 / (ms * 1e-3) / 1e12}


def hbm_peak() -> dict:
    """Streaming bytes/s of x.add_(1.0): M_HBM floats read and
    written."""
    m = M_HBM
    x = torch.zeros((m,), device="cuda")
    ms = profiling.cuda_time_ms(lambda: x.add_(1.0), REPS)
    return {"elements": m, "ms": ms,
            "gbps": 2.0 * 4.0 * m / (ms * 1e-3) / 1e9}


def slope(run, m: int, per_link: float) -> dict:
    """Transcendentals/s of a chain ``run(k)`` over m elements with
    ``per_link`` transcendentals per element and link, by the slope
    between depths K1 and K2."""
    k1, k2 = K1, K2
    t1 = profiling.cuda_time_ms(lambda: run(k1), REPS)
    t2 = profiling.cuda_time_ms(lambda: run(k2), REPS)
    per = (t2 - t1) * 1e-3 / (per_link * (k2 - k1) * m)
    return {"elements": m, "k1": k1, "k2": k2, "t_k1_ms": t1,
            "t_k2_ms": t2, "gtransc_per_s": 1.0 / per / 1e9}


def _torch_chain(op: str, m: int):
    x = torch.full((m,), 0.7, device="cuda")
    fn = {"cos": torch.cos, "exp": lambda v: torch.exp(-v * v)}[op]

    def run(k):
        v = x
        for _ in range(k):
            v = fn(v)
        return v
    return run


def run() -> dict:
    """Every measurement on CUDA device 0; the report main prints."""
    if not torch.cuda.is_available():
        raise RuntimeError("the device peaks need a CUDA device")
    x = torch.full(KERNEL_SHAPE, 0.7, device="cuda")
    m_kernel = x.numel()
    report = {
        "what": ("Measured ceilings of one CUDA card: CUDA-event medians; "
                 "transcendental rates by chain-depth slope, which "
                 "cancels memory traffic and launch cost."),
        "device": torch.cuda.get_device_name(0),
        "card": profiling.card(),
        "matmul_f32": matmul_peak(torch.float32),
        "matmul_tf32": matmul_peak(torch.float32, tf32=True),
        "matmul_bf16": matmul_peak(torch.bfloat16),
        "hbm": hbm_peak(),
        "transc_cos": slope(_torch_chain("cos", M_TRANSC), M_TRANSC, 1.0),
        "transc_exp": slope(_torch_chain("exp", M_TRANSC), M_TRANSC, 1.0),
        "transc_cos_kernel": slope(lambda k: transc_cos_chain(x, k),
                                   m_kernel, 1.0),
        "transc_sincos_kernel": slope(lambda k: transc_sincos_chain(x, k),
                                      m_kernel, 2.0),
    }
    best = max(("transc_cos", "transc_cos_kernel", "transc_sincos_kernel"),
               key=lambda key: report[key]["gtransc_per_s"])
    report["peaks"] = {
        "f32_flops": report["matmul_f32"]["tflops"] * 1e12,
        "tf32_flops": report["matmul_tf32"]["tflops"] * 1e12,
        "bf16_flops": report["matmul_bf16"]["tflops"] * 1e12,
        "hbm_bytes_per_s": report["hbm"]["gbps"] * 1e9,
        # the best transcendental rate measured: the measurement kernels
        # take cos and sin of one argument, which share a range reduction
        "transc_per_s": report[best]["gtransc_per_s"] * 1e9,
        "transc_per_s_from": best,
        "transc_torch_per_s": report["transc_cos"]["gtransc_per_s"] * 1e9,
        "provenance": ("measured on this card by "
                       "mpc_sensorlessao_tpu_torch/benchmarks/"
                       "device_peaks.py"),
    }
    return report


def main() -> None:
    report = run()
    if len(sys.argv) > 1:
        with open(sys.argv[1], "w") as f:
            json.dump(report, f, indent=2)
            f.write("\n")
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
