"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles each source in ``csrc/`` for ``sm_90a`` into a shared
library of its own with a plain C interface, loaded with :mod:`ctypes`.
The builds run at first use, all started together (one ``nvcc`` process
per source), into ``build/torch_kernels/`` beside the package, each keyed
by a hash of its source and the flags, so an edited source rebuilds and an
unchanged one is loaded as it is.  It compiles only the sources in this
repository.  ``--use_fast_math`` is deliberately absent: it would turn
``sincosf`` into the approximate ``__sinf``/``__cosf``, whose error at the
F-engine's phasor angles would flip too many int8 values.

Each C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on anything but 0.

The host library of the ingest (``csrc/ingest.cpp``, no CUDA) builds the
same way with ``g++`` (:func:`ingest_library`) into ``build/torch_ingest/``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import types
from pathlib import Path

__all__ = ["library", "build_log", "check", "build_dir", "NVCC_FLAGS",
           "Pairs", "RingFlags", "MAX_PEERS", "ingest_library",
           "GXX_FLAGS"]

_CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_D = ctypes.c_double

MAX_PEERS = 16   # csrc/remote_dma.cu: DCS_MAX_PEERS


class Pairs(ctypes.Structure):
    """``DcsPairs`` of ``csrc/remote_dma.cu``: the (source, destination)
    block pointers of one peer-copy launch, passed by value."""
    _fields_ = [("src", ctypes.c_void_p * MAX_PEERS),
                ("dst", ctypes.c_void_p * MAX_PEERS)]


class RingFlags(ctypes.Structure):
    """``DcsRingFlags`` of ``csrc/remote_dma.cu``: K7a's signals of one
    launch, passed by value: per pair the receiver's SENT word (None: no
    flag), the sending card's counters and the round's number."""
    _fields_ = [("flag", ctypes.c_void_p * MAX_PEERS),
                ("count", ctypes.c_void_p),
                ("value", ctypes.c_uint)]


# source stem -> its C entry points -> argument types (pointers and the
# stream as c_void_p, byte counts as c_longlong)
_SIGNATURES = {
    "fengine": {"dcs_fengine": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                _I, _I, _I, _I, _I, _I, _I, _P],
                "dcs_fengine_grid": [_I, _I, _I, _I, _I, _I,
                                     ctypes.POINTER(_I)],
                "dcs_fengine_operand": [_P, _P, _I, _I, _I, _I, _P]},
    "cmac": {"dcs_cmac": [_P, _P, _I, _I, _I, _I, _P]},
    "beamform": {"dcs_beamform": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                                  _P]},
    "pfb": {"dcs_pfb": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]},
    "remote_dma": {"dcs_all_to_all": [Pairs, _I, _L, _L, _L, _P],
                   "dcs_ring": [Pairs, _I, _L, RingFlags, _P],
                   "dcs_enable_peer": [_I],
                   "dcs_device_pointer": [_P, ctypes.POINTER(_P)],
                   "dcs_memops_probe": [_I, ctypes.POINTER(_I),
                                        ctypes.POINTER(_I), _P, _P],
                   "dcs_flags_alloc": [_L, ctypes.POINTER(_P), _P],
                   "dcs_free": [_P],
                   "dcs_ipc_handle": [_P, _P, ctypes.POINTER(_L)],
                   "dcs_ipc_open": [_P, ctypes.POINTER(_P)],
                   "dcs_ipc_close": [_P],
                   "dcs_signal": [_P, _P, _I, ctypes.c_uint],
                   "dcs_wait": [_P, _P, _I, ctypes.c_uint]},
    "probes": {"dcs_read_probe": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
               "dcs_write_probe": [_P, _I, _I, _I, _I, _I, _P]},
    "coarse": {"dcs_coarse_gather": [_P, _L, _L, _P, _L, _L, _P, _I, _P, _L,
                                     _P, _L, _I, _P]},
    "delays": {"dcs_delay_terms": [_P, _I, _D, _I, _I, _I, _P, _P, _P, _P]},
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


def _lib_path(src: Path) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(src.read_bytes())
    return build_dir() / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def library() -> types.SimpleNamespace:
    """Build what is missing (one ``nvcc`` per source, in parallel), load
    every library and bind its entry points; returns them as attributes
    (``library().dcs_cmac``)."""
    sources = [_CSRC / f"{stem}.cu" for stem in _SIGNATURES]
    missing = [(src, _lib_path(src)) for src in sources
               if not _lib_path(src).exists()]
    if missing:
        build_dir().mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        jobs = []
        for src, so in missing:
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
            jobs.append((cmd, so, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        failed = []
        for cmd, so, tmp, proc in jobs:
            out, err = proc.communicate()
            so.with_suffix(".log").write_text(out + err)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n"
                              f"{' '.join(cmd)}\n{err}")
            else:
                os.replace(tmp, so)
        if failed:
            raise RuntimeError("\n".join(failed))
    ns = types.SimpleNamespace(_libs=[])
    for src in sources:
        lib = ctypes.CDLL(str(_lib_path(src)))
        ns._libs.append(lib)
        for name, argtypes in _SIGNATURES[src.stem].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            setattr(ns, name, fn)
    return ns


@functools.lru_cache(maxsize=None)
def ingest_library() -> Path:
    """The ingest's host library, built from ``csrc/ingest.cpp`` with
    ``g++`` if missing: ``build/torch_ingest/libingest_<hash>.so``, keyed by
    the source and the flags, written under a temporary name of its
    process and thread and renamed, so that builders running at once
    never load a half-written file."""
    src = _CSRC / "ingest.cpp"
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    digest.update(src.read_bytes())
    out = build_dir().parent / "torch_ingest"
    so = out / f"libingest_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        out.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(src), "-lpthread"]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stderr}")
        os.replace(tmp, so)
    return so


def build_log() -> str:
    """nvcc's output (``-Xptxas -v``: registers, shared memory, spills) of
    each library :func:`library` loaded."""
    library()
    logs = [_lib_path(_CSRC / f"{stem}.cu").with_suffix(".log")
            for stem in _SIGNATURES]
    return "".join(log.read_text() for log in logs if log.exists())


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
