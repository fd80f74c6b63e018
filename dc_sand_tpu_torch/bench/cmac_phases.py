"""Where the CMAC kernel (K2/K3) spends its time, on the card.

``python -m dc_sand_tpu_torch.bench.cmac_phases [--chans K --ap AP
--spectra B ...]`` (default: the fx64 chunk, K 4096, ap 128, B 2048) prints one JSON line: the kernel's time with ``keep`` 1 and
0 (CUDA events over back-to-back launches of
:func:`~dc_sand_tpu_torch.ops.xcorr.xcorr_accumulate_a2`) at each
``--spectra``, each beside its bound, and the split of the kernel's time
between its phases at the first.  The split comes from a second build of
``csrc/cmac.cu`` with ``-DDCS_CMAC_PHASES`` (into ``build/torch_kernels/``, beside the port's
own), in which one thread of every role adds the ``clock64`` ticks of
each phase to a device counter; ``dcs_cmac_phase_names`` names them, and
the shares are of the summed ticks of a role.  Without a card it exits 1
and prints no JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
import sys

import torch

from dc_sand_tpu_torch import _build
from dc_sand_tpu_torch.bench.harness import bound_ms, card, time_cuda
from dc_sand_tpu_torch.ops.xcorr import xcorr_accumulate_a2

__all__ = ["phases_library", "phase_split", "cmac_bound", "main"]


def phases_library() -> ctypes.CDLL:
    """``csrc/cmac.cu`` built with ``-DDCS_CMAC_PHASES``."""
    src = _build._CSRC / "cmac.cu"
    flags = (*_build.NVCC_FLAGS, "-DDCS_CMAC_PHASES")
    digest = hashlib.sha256(" ".join(flags).encode() + src.read_bytes())
    so = _build.build_dir() / f"libcmac_phases_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        _build.build_dir().mkdir(parents=True, exist_ok=True)
        res = subprocess.run([_build._nvcc(), *flags, "-o", str(so),
                              str(src)], capture_output=True, text=True)
        so.with_suffix(".log").write_text(res.stdout + res.stderr)
        if res.returncode:
            raise RuntimeError(f"nvcc failed:\n{res.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.dcs_cmac.argtypes = _build._SIGNATURES["cmac"]["dcs_cmac"]
    lib.dcs_cmac.restype = ctypes.c_int
    lib.dcs_cmac_phases.argtypes = [ctypes.c_void_p]
    lib.dcs_cmac_phases.restype = ctypes.c_int
    lib.dcs_cmac_phase_names.restype = ctypes.c_char_p
    return lib


def phase_split(lib: ctypes.CDLL, a2: torch.Tensor, acc: torch.Tensor,
                keep: int) -> dict:
    """One launch of the phases build on ``a2`` into ``acc``: each
    phase's share of its role's summed ticks (``role.phase`` names; a
    name without a role is the one role)."""
    names = lib.dcs_cmac_phase_names().decode().split(",")
    clocks = (ctypes.c_ulonglong * len(names))()
    _build.check(lib.dcs_cmac_phases(clocks), "dcs_cmac_phases")  # zero
    k, tap, b = a2.shape
    with torch.cuda.device(a2.device):
        _build.check(lib.dcs_cmac(
            a2.data_ptr(), acc.data_ptr(), k, tap // 2, b, keep,
            torch.cuda.current_stream(a2.device).cuda_stream),
            "dcs_cmac (phases build)")
    torch.cuda.synchronize(a2.device)
    _build.check(lib.dcs_cmac_phases(clocks), "dcs_cmac_phases")

    def role(name):
        return name.split(".")[0] if "." in name else ""

    totals = {}
    for name, c in zip(names, clocks):
        totals[role(name)] = totals.get(role(name), 0) + c
    return {name: c / totals[role(name)] for name, c in zip(names, clocks)
            if c}


def cmac_bound(k: int, ap: int, b: int, keep: int) -> tuple:
    """:func:`~dc_sand_tpu_torch.bench.harness.bound_ms` of one call: the
    operand read once, the accumulator written (and read when ``keep``),
    and the useful int8 operations, vr and vi of every (i, j): two
    length-B complex dot products' four real ones each."""
    acc_bytes = 4 * k * ap * ap
    return bound_ms(k * 2 * ap * b + acc_bytes * (1 + keep),
                    int8_ops=4 * ap * ap * b * k)


def main(argv=None) -> int:
    ap_ = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap_.add_argument("--chans", type=int, default=4096)
    ap_.add_argument("--ap", type=int, default=128)
    ap_.add_argument("--spectra", type=int, nargs="+", default=[2048])
    args = ap_.parse_args(argv)
    if not torch.cuda.is_available():
        print("cmac_phases: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    k, ap = args.chans, args.ap
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    acc = torch.randint(-2 ** 24, 2 ** 24, (k, ap, ap), generator=gen,
                        device=dev, dtype=torch.int32)
    runs = []
    for b in args.spectra:
        a2 = torch.randint(-127, 128, (k, 2 * ap, b), generator=gen,
                           device=dev, dtype=torch.int8)
        for keep in (1, 0):
            ms = time_cuda(lambda: xcorr_accumulate_a2(
                acc, a2, keep=keep, impl="cuda"), warmup=2, iters=10) * 1e3
            bound = cmac_bound(k, ap, b, keep)
            runs.append({"spectra": b, "keep": keep, "ms": ms,
                         "bound_ms": bound[0], "bound_by": bound[1],
                         "share_of_bound": bound[0] / ms})
    a2 = torch.randint(-127, 128, (k, 2 * ap, args.spectra[0]),
                       generator=gen, device=dev, dtype=torch.int8)
    lib = phases_library()
    split = {keep: phase_split(lib, a2, acc, keep) for keep in (1, 0)}
    print(json.dumps({
        "kernel": "cmac", "chans": k, "ap": ap, "runs": runs,
        "phase_share": {f"keep{keep}": s for keep, s in split.items()},
        "card": card()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
