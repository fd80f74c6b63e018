"""Where the fused F-engine kernel (K1) spends its time, on the card.

``python -m dc_sand_tpu_torch.bench.k1_phases [--streams S --spectra B
--chans K --taps T]`` (default: the fx64 chunk, 128 x 2048 x 4096, 16
taps) prints one JSON line: K1's time in both layouts (CUDA events over
back-to-back launches of :func:`~dc_sand_tpu_torch.ops.fengine_fused.fengine_fused`)
beside ``wire_to_operand`` of the wire output, the bound, and the split
of the kernel's time between its FIR, its FFT and its epilogue (in the
operand layout: its compute, the exchange of results through shared
memory and their gather and store), and how many of the operand layout's
8-CTA clusters fit on the card at once.  The split
comes from a second build of ``csrc/fengine.cu`` with ``-DDCS_K1_PHASES``
(into ``build/torch_kernels/``, beside the port's own), in which thread 0
of every CTA adds the ``clock64`` ticks of each phase to a device
counter; the shares are of the summed ticks.  Without a card it exits 1
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
from dc_sand_tpu_torch.bench.harness import (bound_ms, card, fengine_flops,
                                             time_cuda)
from dc_sand_tpu_torch.ops.fengine_fused import _tables, fengine_fused
from dc_sand_tpu_torch.ops.pfb import taps_pad_for
from dc_sand_tpu_torch.ops.xcorr import wire_to_operand
from dc_sand_tpu_torch.windows import pfb_window

__all__ = ["main"]

PHASES = ("fir", "fft", "epilogue", "exchange", "gather_store")


def _phases_library() -> ctypes.CDLL:
    """``csrc/fengine.cu`` built with ``-DDCS_K1_PHASES``."""
    src = _build._CSRC / "fengine.cu"
    flags = (*_build.NVCC_FLAGS, "-DDCS_K1_PHASES")
    digest = hashlib.sha256(" ".join(flags).encode() + src.read_bytes())
    so = _build.build_dir() / f"libfengine_phases_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        _build.build_dir().mkdir(parents=True, exist_ok=True)
        res = subprocess.run([_build._nvcc(), *flags, "-o", str(so),
                              str(src)], capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"nvcc failed:\n{res.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.dcs_fengine.argtypes = _build._SIGNATURES["fengine"]["dcs_fengine"]
    lib.dcs_fengine.restype = ctypes.c_int
    lib.dcs_fengine_phases.argtypes = [ctypes.c_void_p]
    lib.dcs_fengine_phases.restype = ctypes.c_int
    lib.dcs_fengine_clusters.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                         ctypes.c_void_p]
    lib.dcs_fengine_clusters.restype = ctypes.c_int
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--streams", type=int, default=128)
    ap.add_argument("--spectra", type=int, default=2048)
    ap.add_argument("--chans", type=int, default=4096)
    ap.add_argument("--taps", type=int, default=16)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1_phases: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    s, b, k, taps = args.streams, args.spectra, args.chans, args.taps
    m, tp = 2 * k, taps_pad_for(args.taps)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def noise(shape):
        return torch.randint(-60, 61, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    hist, chunk = noise((s, tp, m)), noise((s, b, m))
    fd = torch.rand((s, b), generator=gen, device=dev) - 0.5
    ph = torch.rand((s, b), generator=gen, device=dev) * 6 - 3
    gains = torch.full((k, 2), 0.05, device=dev)
    w = torch.as_tensor(pfb_window(taps, m), dtype=torch.float32,
                        device=dev).reshape(taps, m)
    kw = dict(history=hist, frac_delay=fd, phase=ph, gains=gains)
    ms = {layout: time_cuda(lambda: fengine_fused(
              chunk, w, taps, k, layout=layout, impl="cuda", **kw),
              warmup=1, iters=5) * 1e3 for layout in ("wire", "operand")}
    wire = fengine_fused(chunk, w, taps, k, impl="cuda", **kw)
    ms["wire_to_operand"] = time_cuda(lambda: wire_to_operand(wire),
                                      warmup=1, iters=5) * 1e3
    split_tw, pass_tw = _tables(m, dev)
    lib = _phases_library()
    clocks = (ctypes.c_ulonglong * len(PHASES))()
    share, outs = {}, {}
    for layout, shape in (("wire", (s, b, k, 2)), ("operand", (k, 2, s, b))):
        outs[layout] = out = torch.empty(shape, dtype=torch.int8, device=dev)
        lib.dcs_fengine_phases(clocks)             # zero the counters
        _build.check(lib.dcs_fengine(
            hist.data_ptr(), chunk.data_ptr(), w.data_ptr(),
            split_tw.data_ptr(), pass_tw.data_ptr(), fd.data_ptr(),
            ph.data_ptr(), gains.data_ptr(), out.data_ptr(), s, tp, b, b, m,
            taps, tp - taps + 1, int(layout == "operand"), b,
            torch.cuda.current_stream().cuda_stream),
            "dcs_fengine (phases build)")
        torch.cuda.synchronize()
        _build.check(lib.dcs_fengine_phases(clocks), "dcs_fengine_phases")
        share[layout] = {p: c / sum(clocks) for p, c in zip(PHASES, clocks)
                         if c}
    clusters, sms = ctypes.c_int(), ctypes.c_int()
    _build.check(lib.dcs_fengine_clusters(m, ctypes.byref(clusters),
                                          ctypes.byref(sms)),
                 "dcs_fengine_clusters")
    nbytes = sum(t.numel() * t.element_size()
                 for t in (hist, chunk, w, fd, ph, gains, wire))
    bound = bound_ms(nbytes, fengine_flops(s * b, m, taps, rotate=True,
                                           quant=True))
    print(json.dumps({
        "kernel": "fengine", "streams": s, "spectra": b, "chans": k,
        "taps": taps, "ms": ms, "bound_ms": bound[0], "bound_by": bound[1],
        "phase_share": share,
        "equal_layouts": bool(torch.equal(outs["operand"],
                                          wire_to_operand(outs["wire"]))),
        "operand_clusters": clusters.value, "cluster_size": 8,
        "sms": sms.value,
        "card": card()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
