"""Measurement kernels for the card: 32-bit operation rates and Montgomery
product bodies (csrc/probe.cu). No part of the proving path.

``rate_chain`` replaces the TPU probe ``scripts/probe_vpu_ops.py:49``: every
thread runs 8 independent chains of K dependent steps of one operation
(``RATE_OPS``), so a launch takes steps / rate. ``cios_chain`` replaces
``scripts/probe_cios.py:98``: K chained Montgomery products x <- x * b per
lane in two bodies (``CIOS_VARIANTS``), at every built field width.

Beside each stands its plain PyTorch version (int64 arithmetic masked to
32 bits; the plain Montgomery product), taken for CPU tensors and used to
check the kernels' final values on the card. ``scripts/probe_h100.py``
prints the tables.

``sass_loops`` reads the machine code of the built probe kernels
(``cuobjdump -sass``) and counts the instructions of each kernel's main
loop, so that a rate can be read as the rate of an instruction: a step that
compiles to one instruction runs at that instruction's rate, one that
compiles to three does not.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

from .ops import cuda_lib
from .ops.cuda_fp import mont_mul_plain

CHAINS = 8                       # independent chains per thread (probe.cu)
RATE_OPS = ("mul_lo", "mad_lo", "mad_hi", "mad_wide", "add64", "shift_and",
            "mul_f32")           # in the order of enum RateOp
CIOS_VARIANTS = ("cios", "sos")  # field.cuh's body; separated operand scanning
LAUNCHES = {f"probe_rate_{op}": 0 for op in RATE_OPS}
LAUNCHES.update({f"probe_cios_{v}_n{2 * nw}": 0 for v in CIOS_VARIANTS
                 for nw in cuda_lib.WIDTHS})

_M32 = 0xFFFFFFFF


def _mul_hi(x, y):
    """High 32 bits of the 64-bit product of two int64 tensors < 2^32."""
    xl, xh = x & 0xFFFF, x >> 16
    yl, yh = y & 0xFFFF, y >> 16
    mid = xh * yl + xl * yh + ((xl * yl) >> 16)
    return xh * yh + (mid >> 16)


def rate_chain_plain(op: str, a: torch.Tensor, b: torch.Tensor, K: int):
    """K steps of the chain ``op`` on every element, as int32 bit patterns
    (mul_f32: float32 in, float32 out)."""
    if op == "mul_f32":
        x = a.clone()
        for _ in range(K):
            x = x * b
        return x
    x = a.to(torch.int64) & _M32
    y = b.to(torch.int64) & _M32
    hi = torch.zeros_like(x)
    for _ in range(K):
        if op == "mul_lo":
            x = (x * y) & _M32
        elif op == "mad_lo":
            x = (x * y + y) & _M32
        elif op == "mad_hi":
            x = (_mul_hi(x, y) + y) & _M32
        elif op == "mad_wide":
            lo = ((x * y) & _M32) + x             # w = lo(w) * y + w
            x, hi = lo & _M32, (_mul_hi(x, y) + hi + (lo >> 32)) & _M32
        elif op == "add64":
            lo = x + y
            x, hi = lo & _M32, (hi + y + (lo >> 32)) & _M32
        elif op == "shift_and":
            x = ((x >> 1) & y) ^ y
        else:
            raise ValueError(f"unknown rate op {op!r}; available: {RATE_OPS}")
    if op in ("mad_wide", "add64"):
        x = x ^ hi
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def rate_chain(op: str, a: torch.Tensor, b: torch.Tensor, K: int):
    """a, b: (CHAINS, T) int32 bit patterns (float32 for ``mul_f32``), chain
    c of thread t at [c, t]. Returns the chains' values after K steps. One
    launch on the card; the plain version for CPU tensors."""
    if op not in RATE_OPS:
        raise ValueError(f"unknown rate op {op!r}; available: {RATE_OPS}")
    want = torch.float32 if op == "mul_f32" else torch.int32
    if a.dtype != want or b.dtype != want or a.shape != b.shape \
            or a.dim() != 2 or a.shape[0] != CHAINS:
        raise ValueError(f"rate_chain({op}) takes two ({CHAINS}, T) "
                         f"{want} tensors")
    if not a.is_cuda:
        return rate_chain_plain(op, a, b, K)
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    code = cuda_lib.lib("probe").lsn_probe_rate(
        RATE_OPS.index(op), a.data_ptr(), b.data_ptr(), out.data_ptr(),
        a.shape[1], K, cuda_lib.stream_ptr(a))
    cuda_lib.check(code, f"probe_rate[{op}]")
    LAUNCHES[f"probe_rate_{op}"] += 1
    return out


def cios_chain_plain(fk, a: torch.Tensor, b: torch.Tensor, K: int):
    x = a
    for _ in range(K):
        x = mont_mul_plain(fk, x, b)
    return x


def cios_chain(fk, variant: str, a: torch.Tensor, b: torch.Tensor, K: int):
    """x <- x * b (Montgomery) K times per lane, a and b canonical (N, L)
    int32 limbs of the field kernel ``fk``; ``variant`` picks the body."""
    if variant not in CIOS_VARIANTS:
        raise ValueError(f"unknown CIOS variant {variant!r}; "
                         f"available: {CIOS_VARIANTS}")
    if a.dtype != torch.int32 or b.dtype != torch.int32 \
            or a.shape != b.shape or a.dim() != 2 or a.shape[0] != fk.N:
        raise ValueError("cios_chain takes two (N, L) int32 limb tensors")
    if not a.is_cuda:
        return cios_chain_plain(fk, a, b, K)
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty_like(a)
    code = cuda_lib.lib("probe").lsn_probe_cios(
        fk.nw, CIOS_VARIANTS.index(variant), a.data_ptr(), b.data_ptr(),
        out.data_ptr(), a.shape[1], K, ctypes.addressof(fk.mod),
        cuda_lib.stream_ptr(a))
    cuda_lib.check(code, f"probe_cios[{variant}]")
    LAUNCHES[f"probe_cios_{variant}_n{fk.N}"] += 1
    return out


# ----------------------------------------------------------- measurements

def _cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _rate_inputs(op: str, T: int, gen):
    if op == "mul_f32":                       # stays finite for any K here
        a = torch.rand((CHAINS, T), generator=gen, device="cuda") + 0.5
        b = torch.ones((CHAINS, T), device="cuda")
        b[:, ::2] = 1.0 + 2.0 ** -12
        b[:, 1::2] = 1.0 - 2.0 ** -12
        return a, b
    mk = lambda: torch.randint(-(1 << 31), 1 << 31, (CHAINS, T),
                               generator=gen, device="cuda",
                               dtype=torch.int64).to(torch.int32)
    return mk(), mk()


def measure_rates(T: int = 132 * 2048, K: int = 4096, seed: int = 7) -> list:
    """One row per operation, over T threads x CHAINS chains x K steps:
    whether the kernel's final values equal the plain chain's, the time of
    a launch, G steps/s, and the plain chain's time. Needs the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for op in RATE_OPS:
        a, b = _rate_inputs(op, T, gen)
        got = rate_chain(op, a, b, K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = rate_chain_plain(op, a, b, K)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        ms = _cuda_ms(lambda: rate_chain(op, a, b, K), 5)
        rows.append({"op": op, "exact": bool(torch.equal(got, want)),
                     "threads": T, "K": K, "steps": CHAINS * T * K, "ms": ms,
                     "gsteps_per_s": CHAINS * T * K / ms / 1e6,
                     "plain_ms": plain_ms})
    return rows


def measure_cios(fks, L: int = 1 << 20, K: int = 64, seed: int = 8) -> list:
    """One row per (field kernel, variant), over L lanes x K chained
    products: exact against the plain chain, the time of a launch, G
    Montgomery products/s and the plain chain's time. ``fks``: FpKernels
    on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = []
    for fk in fks:
        top = fk.p >> (16 * (fk.N - 1))

        def rand():
            lo = torch.randint(0, 1 << 16, (fk.N - 1, L), generator=gen,
                               device="cuda", dtype=torch.int32)
            hi = torch.randint(0, top, (1, L), generator=gen, device="cuda",
                               dtype=torch.int32)
            return torch.cat([lo, hi], dim=0)
        a, b = rand(), rand()
        a[:, :3] = fk.encode([0, 1, fk.p - 1], mont=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = cios_chain_plain(fk, a, b, K)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        for variant in CIOS_VARIANTS:
            got = cios_chain(fk, variant, a, b, K)
            ms = _cuda_ms(lambda: cios_chain(fk, variant, a, b, K), 5)
            rows.append({"N": fk.N, "bits": fk.p.bit_length(),
                         "variant": variant,
                         "exact": bool(torch.equal(got, want)), "lanes": L,
                         "K": K, "ms": ms,
                         "gproducts_per_s": L * K / ms / 1e6,
                         "wide_mads_per_product": 2 * fk.nw ** 2 + fk.nw,
                         "plain_ms": plain_ms})
    return rows


# ------------------------------------------------------------ machine code

def _cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = Path(cuda_lib.nvcc_path()).with_name("cuobjdump")
    if cand.exists():
        return str(cand)
    raise RuntimeError("cuobjdump not found beside nvcc")


def _kernel_label(mangled: str):
    m = re.search(r"rate_kernelILi(\d+)E", mangled)
    if m:
        return f"probe_rate_{RATE_OPS[int(m.group(1))]}"
    m = re.search(r"cios_kernelILi(\d+)ELi(\d+)E", mangled)
    if m:
        return f"probe_cios_{CIOS_VARIANTS[int(m.group(2))]}_n{2 * int(m.group(1))}"
    return None


def main_loop(sass: str) -> dict:
    """Opcode counts of the longest loop (a backward branch and everything
    between it and its target) of one function's ``cuobjdump -sass`` text."""
    ins = [(int(m.group(1), 16), m.group(2), m.group(3)) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[0-9T]+\s+)?([A-Z][A-Z0-9_.]*)"
        r"([^;]*);", sass)]
    best = (0, 0)
    for addr, opc, rest in ins:
        m = re.search(r"0x([0-9a-f]+)", rest) if opc.startswith("BRA") else None
        if m and int(m.group(1), 16) <= addr and \
                addr - int(m.group(1), 16) > best[1] - best[0]:
            best = (int(m.group(1), 16), addr)
    counts: dict = {}
    for addr, opc, _ in ins:
        if best[0] <= addr <= best[1] and best[1] > 0:
            counts[opc] = counts.get(opc, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def sass_loops(dump_to=None) -> dict:
    """Kernel name (the launch-counter key) -> opcode counts of its main
    loop, from the built probe library. ``dump_to``: a file that gets the
    whole ``cuobjdump -sass`` text. Needs the CUDA toolkit."""
    cuda_lib.build_all()
    so = cuda_lib.library_path("probe")
    text = subprocess.run([_cuobjdump(), "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout
    if dump_to is not None:
        Path(dump_to).parent.mkdir(parents=True, exist_ok=True)
        Path(dump_to).write_text(text)
    loops = {}
    for part in re.split(r"\n\s*Function : ", text)[1:]:
        label = _kernel_label(part.split("\n", 1)[0])
        if label:
            loops[label] = main_loop(part)
    return loops
