"""Build and load the port's CUDA kernels; device resolution.

Each ``csrc/*.cu`` source compiles with nvcc into one shared library with
a plain C interface (``sm_90a``), loaded with ctypes. The kernels are
templates over the field width. fp.cu's product is built for the limb
counts in ``FIELD_LIMBS`` (12, 16, 19, 24 and 48 16-bit limbs: 6, 8, 10,
12 and 24 32-bit words, ``words_of``; 19 limbs take 10 words, the top
half-word zero); the group kernels (ec.cu, bucket.cu) for ``GROUP_WIDTHS``
over Fp (8 words for a 16-limb modulus, 12 for a 24-limb one, 24 for a
48-limb one) and only at ``FP2_WIDTHS`` over Fp2 (curves with an
a-coefficient run no group kernel), and the CIOS probe (``probe.cu``) at
``PROBE_WIDTHS`` (its product-latency bodies at every group width); the C
entries take the width as their first argument (limbs for fp.cu, words for
the others; ``probe_layout`` moves plain 32-bit words and knows no field). The
libraries are built at first use from the sources in the checkout, into
``libsnark_tpu_torch/build/`` (listed in .gitignore), one nvcc process per
source, all started together.
File names carry a hash of the sources, so an edited kernel is never served
from a stale build.

Every C entry returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero code. Pointers and the stream go through ``ctypes.c_void_p``
(``argtypes`` are set for every entry, so 64-bit pointers are never cut).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
FIELD_LIMBS = (12, 16, 19, 24, 48)  # 16-bit limbs that fp.cu's product takes
WIDE_LIMBS = (12, 16, 19, 24)   # ... and its product with a wide operand
GROUP_WIDTHS = (8, 12, 24)  # words of the group kernels over Fp
FP2_WIDTHS = (8, 12)      # the widths of the group kernels over Fp2 too
PROBE_WIDTHS = (6, 8, 12)  # csrc/probe.cu's widths (at 24: the latency
                           # probe; at 10 words, 19 limbs: fp_mul_half)
SOURCES = ("fp", "ec", "bucket", "probe", "probe_layout")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile", "0"]   # a source's kernels optimise in parallel

_VP = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_U = ctypes.c_uint
_ARGTYPES = {
    "fp": {"lsn_mont_mul": [_I, _VP, _VP, _VP, _LL, _VP, _VP],
           "lsn_fp_addsub": [_I, _I, _VP, _VP, _VP, _LL, _VP, _VP],
           "lsn_mul_wide": [_I, _VP, _I, _VP, _LL, _VP, _LL, _VP, _VP]},
    "ec": {
        "lsn_ec_dbl": [_I, _I, _VP, _VP, _VP, _VP, _VP, _VP, _LL, _I, _VP,
                       _VP],
        "lsn_ec_add": [_I, _I] + [_VP] * 9 + [_LL, _VP, _VP],
        "lsn_ec_madd": [_I, _I] + [_VP] * 10 + [_LL, _VP, _VP],
        "lsn_ec_aadd": [_I, _I] + [_VP] * 9 + [_LL, _VP, _VP],
        "lsn_ec_madd_windows": [_I, _I, _VP, _VP, _I, _I, _I, _VP, _VP, _VP,
                                _LL, _VP, _VP],
        "lsn_ec_aadd_rows": [_I, _I] + [_VP] * 4 + [_I] * 7 + [_VP] * 3
            + [_LL, _VP, _VP],
    },
    "bucket": {
        "lsn_bucket_reduce": [_I, _I, _VP, _LL, _VP, _VP, _VP, _VP, _LL, _VP,
                              _VP, _VP, _VP, _VP],
        "lsn_horner": [_I, _I, _VP, _VP, _VP, _LL, _I, _VP, _VP, _VP, _VP,
                       _VP],
        "lsn_dbl_chain": [_I, _I, _VP, _VP, _VP, _I, _I, _VP, _VP, _VP, _VP,
                          _VP],
    },
    "probe": {
        "lsn_probe_rate": [_I, _VP, _VP, _VP, _LL, _I, _VP],
        "lsn_probe_cios": [_I, _I, _VP, _VP, _VP, _LL, _I, _VP, _VP],
        "lsn_probe_dep_mad": [_U, _VP, _I, _VP],
    },
    "probe_layout": {
        "lsn_layout_row_copy": [_VP, _VP, _VP, _I, _I, _LL, _LL, _I, _VP],
        "lsn_layout_transpose": [_VP, _VP, _I, _I, _I, _VP],
        "lsn_layout_reshape_merge_minor": [_VP, _VP, _I, _I, _I, _I] + [_U] * 4
            + [_VP],
        "lsn_layout_reshape_merge_major": [_VP, _VP, _I, _I, _I, _I] + [_U] * 4
            + [_VP],
        "lsn_layout_squeeze": [_VP, _VP, _I, _I, _I, _I] + [_U] * 4
            + [_VP],
        "lsn_layout_roll_minor": [_VP, _VP, _LL, _I, _I, _VP],
        "lsn_layout_roll_middle": [_VP, _VP, _I, _I, _I, _VP],
        "lsn_layout_cond": [_VP, _VP, _I, _VP],
        "lsn_layout_window_copy": [_VP, _VP, _LL, _I, _I, _I, _VP],
        "lsn_layout_loop_dyn": [_VP, _VP, _LL, _VP],
        "lsn_layout_dynslice_sum": [_VP, _VP, _I, _I, _I, _VP],
        "lsn_layout_empty": [_VP],
    },
}

_lock = threading.Lock()
_libs: dict = {}
build_seconds = None      # wall time of the last build (None: not built)
build_logs: dict = {}     # library name -> nvcc/ptxas output of the last build


def resolve_device(device="cuda") -> torch.device:
    """The entry points' device: the card unless the caller asks for the
    CPU. Raises when a CUDA device is asked for and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:12]


def library_path(src: str) -> Path:
    """Where the library of ``csrc/<src>.cu`` is (or will be) built."""
    return BUILD_DIR / f"lib{src}-{_digest()}.so"


def build_all() -> dict:
    """Compile every library (in parallel) and load them."""
    global build_seconds
    with _lock:
        if len(_libs) == len(SOURCES):
            return _libs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        procs = {}
        for src in SOURCES:
            so = library_path(src)
            if so.exists():
                continue
            tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{src}.cu")]
            procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True), tmp, so)
        failed = []
        for src, (proc, tmp, so) in procs.items():
            out, _ = proc.communicate()
            build_logs[src] = out
            if proc.returncode != 0:
                failed.append(f"{src}:\n{out}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        build_seconds = time.perf_counter() - t0
        for src in SOURCES:
            lib = ctypes.CDLL(str(library_path(src)))
            for fn, argtypes in _ARGTYPES[src].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[src] = lib
        return _libs


def ptxas_summary(logs: dict = None) -> list:
    """One line per kernel of the last build (``build_logs``): registers,
    stack frame, spill stores / loads, from ``-Xptxas -v``."""
    lines = []
    for unit, text in (build_logs if logs is None else logs).items():
        entry, frame = None, ("?", "?", "?")
        for line in text.splitlines():
            if "Compiling entry function" in line:
                # name<template integers>: <NW, ext>, <NW>, <NW, variant>
                # or <op> as the kernel declares them
                entry = re.sub(r".*'_Z\d+([a-z_]+).*", r"\1", line.strip())
                targs = re.search(r"'_Z\d+[a-z_]+I((?:Li\d+E)+)E", line)
                if targs:
                    entry += "<" + ", ".join(
                        re.findall(r"Li(\d+)E", targs.group(1))) + ">"
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m:
                frame = m.groups()
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                lines.append(
                    f"ptxas[{unit}] {entry}: {m.group(1)} registers, "
                    f"stack {frame[0]} B, spill stores/loads "
                    f"{frame[1]}/{frame[2]} B")
                entry = None
    return lines


def lib(src: str):
    """The loaded library of one source (built at first use)."""
    return build_all()[src]


def check(code: int, what: str):
    if code != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: error {code}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def words_of(num_limbs: int) -> int:
    """32-bit words of a field with ``num_limbs`` 16-bit limbs: the kernels
    pair limbs into words, an odd count leaving the top half-word zero (19
    limbs: 10 words). A width that csrc does not instantiate is refused."""
    if num_limbs not in FIELD_LIMBS:
        raise ValueError(f"no kernels built for {num_limbs} limbs "
                         f"(16-bit limbs: {FIELD_LIMBS})")
    return -(-num_limbs // 2)


@functools.lru_cache(maxsize=None)
def mod_type(nw: int):
    """ctypes mirror of ``struct Mod<NW>`` in csrc/field.cuh."""
    return type(f"Mod{nw}", (ctypes.Structure,), {"_fields_": [
        ("p", ctypes.c_uint32 * nw), ("one", ctypes.c_uint32 * nw),
        ("n0inv", ctypes.c_uint32), ("beta_small", ctypes.c_int32),
        ("beta_neg", ctypes.c_int32)]})


def make_mod(p: int, num_limbs: int, beta_small: int = 0,
             beta_neg: bool = False):
    """The kernels' constants for modulus p over ``num_limbs`` 16-bit
    limbs: R = 2^(16 num_limbs), as in the JAX package (2^(32 NW) at an
    even limb count; at an odd one the product's last round is a half word
    and takes -p^-1 mod 2^16, the low half of n0inv)."""
    nw = words_of(num_limbs)
    if not p < 1 << (16 * num_limbs - 1):
        raise ValueError("the kernels' Montgomery product needs a modulus "
                         "below R/2 = 2^(16 num_limbs - 1)")
    words = lambda x: (ctypes.c_uint32 * nw)(
        *[(x >> (32 * k)) & 0xFFFFFFFF for k in range(nw)])
    n0inv = (-pow(p, -1, 1 << 32)) % (1 << 32)
    one_mont = (1 << (16 * num_limbs)) % p
    return mod_type(nw)(words(p), words(one_mont), n0inv, beta_small,
                        int(beta_neg))
