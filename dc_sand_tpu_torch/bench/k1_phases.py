"""Where the fused F-engine kernel (K1) spends its time, on the card.

``python -m dc_sand_tpu_torch.bench.k1_phases [--streams S --spectra B
--chans K --taps T]`` (default: the fx64 chunk, 128 x 2048 x 4096, 16
taps; beam64's is ``--spectra 256``) prints one JSON line: K1's time in
both layouts (CUDA events over back-to-back launches of
:func:`~dc_sand_tpu_torch.ops.fengine_fused.fengine_fused`) beside
``wire_to_operand`` of the wire output, the bound, the grid of persistent
CTAs each layout launches (``grid_ctas``: its SMs in use, one CTA an SM)
and the card's SMs, the bytes the FIR reads from L2 as the design counts
them (:func:`~dc_sand_tpu_torch.ops.fengine_fused.k1_l2_bytes`), and the
split of the kernel's time between the FIR's wait for each column slice's
loads, the FIR's arithmetic and stores, the FFT and the epilogue (in the
operand layout: its compute, the exchange of results through shared
memory and their gather and store, the cluster's deferred barrier
included).  The split comes from a second build of ``csrc/fengine.cu``
with ``-DDCS_K1_PHASES`` (into ``build/torch_kernels/``, beside the port's
own), in which thread 0 of every CTA adds the ``clock64`` ticks of each
phase to a device counter and waits for a slice's loads before its first
multiply; the shares are of the summed ticks, and ``ticks_per_tile`` is
their sum over the tiles the CTAs ran.  At ``--chans 32768`` (M = 65536,
the cluster kernel ``fengine_wide_kernel``, whose operand layout is its
wire output transposed by ``fengine_wide_operand``, timed alone as
``operand_transpose``) the split is of the wire kernel: the FIR's wait,
the FIR, the two 2048-point FFTs, the epilogue with the phasor tables and
the store, the exchanges across the cluster over DSMEM (the radix-16 pass
and the int8 bins), and the waits at the cluster's barriers; a tile there
is one CTA's eighth of a cluster's tile.
Without a card it exits 1 and prints no JSON.
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
from dc_sand_tpu_torch.ops.fengine_fused import (K1_CLUSTER, K1_TILE,
                                                 WIDE_FFT_SIZE, _tables,
                                                 fengine_fused, k1_l2_bytes)
from dc_sand_tpu_torch.ops.pfb import taps_pad_for
from dc_sand_tpu_torch.ops.xcorr import wire_to_operand
from dc_sand_tpu_torch.windows import pfb_window

__all__ = ["main"]

PHASES = ("fir_wait", "fir", "fft", "epilogue", "exchange", "gather_store")
WIDE_PHASES = ("fir_wait", "fir", "fft", "epilogue", "exchange",
               "cluster_wait")


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
    return lib


def grid(s: int, b: int, m: int, layout: str) -> int:
    """The CTAs K1 launches for an int8 call with the phasor (0 below M =
    2048, where its CTAs are one-shot)."""
    out = ctypes.c_int()
    _build.check(_build.library().dcs_fengine_grid(
        s, b, m, int(layout == "operand"), 1, 0, ctypes.byref(out)),
        "dcs_fengine_grid")
    return out.value


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
    wide = m == WIDE_FFT_SIZE
    if wide:
        op = torch.empty((k, 2, s, b), dtype=torch.int8, device=dev)
        ms["operand_transpose"] = time_cuda(
            lambda: _build.check(_build.library().dcs_fengine_operand(
                wire.data_ptr(), op.data_ptr(), s, b, k, b,
                torch.cuda.current_stream().cuda_stream),
                "dcs_fengine_operand"), warmup=1, iters=5) * 1e3
    names = WIDE_PHASES if wide else PHASES
    split_tw, pass_tw = _tables(m, dev)
    lib = _phases_library()
    clocks = (ctypes.c_ulonglong * len(PHASES))()
    tiles = -(-b // K1_TILE)
    share, ticks, grids, outs = {}, {}, {}, {}
    # at M = 65536 the operand layout runs the wire kernel (then its
    # transpose): its split is the wire layout's
    layouts = (("wire", (s, b, k, 2)),) if wide else (
        ("wire", (s, b, k, 2)), ("operand", (k, 2, s, b)))
    for layout, shape in layouts:
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
        share[layout] = {p: c / sum(clocks) for p, c in zip(names, clocks)
                         if c}
        grids[layout] = grid(s, b, m, layout)
        # the operand layout's clusters also run the tiles that pad a
        # stream's last group of 8; at M = 65536 each of a cluster's 8
        # CTAs runs an eighth of every tile
        n_tiles = s * (-(-tiles // K1_CLUSTER) * K1_CLUSTER
                       if layout == "operand" and grids[layout] else
                       tiles * K1_CLUSTER if wide else tiles)
        ticks[layout] = sum(clocks) / n_tiles
    nbytes = sum(t.numel() * t.element_size()
                 for t in (hist, chunk, w, fd, ph, gains, wire))
    bound = bound_ms(nbytes, fengine_flops(s * b, m, taps, rotate=True,
                                           quant=True))
    print(json.dumps({
        "kernel": "fengine", "streams": s, "spectra": b, "chans": k,
        "taps": taps, "ms": ms, "bound_ms": bound[0], "bound_by": bound[1],
        "phase_share": share, "ticks_per_tile": ticks,
        "equal_layouts": bool(torch.equal(
            fengine_fused(chunk, w, taps, k, layout="operand", impl="cuda",
                          **kw) if wide else outs["operand"],
            wire_to_operand(outs["wire"]))),
        "grid_ctas": grids, "cluster_size": K1_CLUSTER,
        "sms": torch.cuda.get_device_properties(dev).multi_processor_count,
        "l2_bytes": k1_l2_bytes(s, b, m, taps),
        "card": card()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
