"""Native host code of the port, compiled with g++ at first use.

``limbcodec()`` is the big-integer <-> packed-limb codec
(``limbcodec.cpp``, a CPython extension): ``encode(xs, n)`` turns a
sequence of non-negative ints below 2^(16 n) into the (n, len(xs)) uint32
limbs of ``ops/limbs.py``'s layout, limb-major, as a bytearray; ``encode(xs, n,
p)`` first reduces mod p each int that is negative or at least p (and
packs an int below 2^63 straight from its machine word);
``decode(buf, n, m)`` turns such a buffer back into m ints. It reads and
writes each integer's bytes through CPython's own conversion, where the
Python form builds a bytes object per element.

The extension is built into ``libsnark_tpu_torch/build/`` (git-ignored)
under a name that carries a hash of its source, by g++ into a temporary
file that ``os.replace`` moves into place, so processes that build it at
once (test workers) never load a partial file. A failed build raises:
there is no silent fallback to Python.
"""
from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sysconfig
import threading
from pathlib import Path

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "limbcodec.cpp"
BUILD_DIR = HERE.parent / "build"
CXX = "g++"

_lock = threading.Lock()
_codec = None


def _library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return BUILD_DIR / f"_limbcodec-{digest}{suffix}"


def build(so: Path, cxx: str = CXX) -> Path:
    """Compile ``limbcodec.cpp`` into ``so`` (through a temporary file);
    raises RuntimeError with the compiler's output if it fails."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, "-O2", "-shared", "-fPIC", "-std=c++17",
           f"-I{sysconfig.get_paths()['include']}", str(SOURCE), "-o",
           str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"the limb codec cannot be built: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"the limb codec failed to build ({' '.join(cmd)}):"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def limbcodec():
    """The codec module, built at the first call and loaded once."""
    global _codec
    with _lock:
        if _codec is None:
            so = _library_path()
            if not so.exists():
                build(so)
            spec = importlib.util.spec_from_file_location("_limbcodec", so)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _codec = mod
        return _codec
