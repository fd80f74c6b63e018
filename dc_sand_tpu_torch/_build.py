"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles every source in ``csrc/`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with :mod:`ctypes`.  The build
runs at first use, into ``build/torch_kernels/`` beside the package, keyed
by a hash of the sources and flags, so an edited source rebuilds and an
unchanged one is loaded as it is.  It compiles only the sources in this
repository.  ``--use_fast_math`` is deliberately absent: it would turn
``sincosf`` into the approximate ``__sinf``/``__cosf`` and allow FMA
contraction that the F-engine's float order rules out.

Each C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["library", "build_log", "check", "build_dir", "NVCC_FLAGS"]

_CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry point -> argument types (pointers and the stream as c_void_p)
_SIGNATURES = {
    "dcs_fengine": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                    ctypes.c_float, _P],
    "dcs_cmac": [_P, _P, _I, _I, _I, _I, _P],
}


def build_dir() -> Path:
    return Path(__file__).resolve().parent.parent / "build" / "torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot be built")


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; bind its entry points."""
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    out_dir = build_dir()
    so = out_dir / f"libdcs_kernels_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        so.with_suffix(".log").write_text(res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_log() -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) of
    the build :func:`library` loaded."""
    library()
    logs = sorted(build_dir().glob("libdcs_kernels_*.log"),
                  key=lambda p: p.stat().st_mtime)
    return logs[-1].read_text() if logs else ""


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
