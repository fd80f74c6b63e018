"""The read and write probes P1 and P2: the F-engine's memory traffic
split into its input and output sides.

PyTorch counterpart of ``scripts/sweep_s10_micro.py``, whose two TPU
kernels read the 4k wire contract's input in its (TB, M) blocks over a
(S, NB) grid (``_read_kernel``) and write its output blocks
(``_write_kernel``).
On CUDA tensors :func:`read_probe` and :func:`write_probe` launch the
hand-written kernels of ``csrc/probes.cu``, each launch adding one to the
wrapper's ``launches``; on CPU tensors they run the plain versions,
:func:`read_probe_torch` and :func:`write_probe_torch`.
:func:`bench_probes` times both at the script's shapes.
"""

from __future__ import annotations

import time

import torch

from dc_sand_tpu_torch import _build
from dc_sand_tpu_torch.bench.harness import BenchResult, time_cuda
from dc_sand_tpu_torch.ops._dispatch import default_device, resolve_impl

__all__ = ["read_probe", "read_probe_torch", "write_probe",
           "write_probe_torch", "bench_probes", "S", "NB", "TB", "M", "M2",
           "K1N", "NF"]

# the script's shapes: grid (S, NB), input blocks (TB, M) int8, output
# blocks (1, 2*M2, TB, K1N) int8 (the 4k wire contract shape)
S, NB, TB, M = 16, 8, 64, 8192
M2, K1N = 64, 64
NF = NB * TB + 15


def _check_read(x: torch.Tensor, tb: int, nb: int) -> None:
    if x.dim() != 3 or x.dtype != torch.int8:
        raise ValueError(f"x must be int8 (S, NF, M), got {x.dtype} "
                         f"{tuple(x.shape)}")
    s, nf, m = x.shape
    if tb < 8 or m < 128 or nb < 1 or nb * tb > nf or s < 1:
        raise ValueError(f"the read probe needs tb >= 8, M >= 128 and nb * tb "
                         f"<= NF, got tb={tb}, nb={nb}, x {tuple(x.shape)}")


def read_probe_torch(x: torch.Tensor, *, tb: int, nb: int):
    """Plain version of :func:`read_probe`."""
    _check_read(x, tb, nb)
    s, _, m = x.shape
    sums = x[:, :nb * tb].reshape(s, nb, tb * m).sum(dim=-1,
                                                     dtype=torch.int64)
    r0 = (nb - 1) * tb
    return x[s - 1, r0:r0 + 8, :128].clone(), sums


def read_probe(x: torch.Tensor, *, tb: int, nb: int, impl: str = "auto"):
    """P1: read ``x`` int8 ``(S, NF, M)`` in ``(tb, M)`` blocks, ``nb`` of
    them a stream.  Returns ``(tile, sums)``: the ``(8, 128)`` int8 tile
    that the TPU kernel writes, rows 0-7 and columns 0-127 of the last
    block read (``x[S-1, (nb-1)*tb : (nb-1)*tb+8, :128]``), and ``(S,
    nb)`` int64, the exact sum of each block's ``tb * M`` bytes, which
    keeps every load live on the card."""
    _check_read(x, tb, nb)
    if resolve_impl(impl, x) == "torch":
        return read_probe_torch(x, tb=tb, nb=nb)
    if not x.is_contiguous():
        raise ValueError("the read probe kernel takes a contiguous x")
    s, nf, m = x.shape
    if s > 65535:
        raise ValueError(f"the read probe kernel takes at most 65535 "
                         f"streams, got {s}")
    dev = x.device
    tile = torch.empty((8, 128), dtype=torch.int8, device=dev)
    sums = torch.zeros((s, nb), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):   # a launch needs its stream's device
        err = _build.library().dcs_read_probe(
            x.data_ptr(), tile.data_ptr(), sums.data_ptr(), s, nf, m, nb, tb,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "dcs_read_probe")
    read_probe.launches += 1
    return tile, sums


read_probe.launches = 0


def write_probe_torch(s: int, nb: int, tb: int, m2: int, k1n: int, *,
                      device) -> torch.Tensor:
    """Plain version of :func:`write_probe`."""
    if not 1 <= nb <= 128:
        raise ValueError(f"the write probe's values are int8: nb must be "
                         f"1..128, got {nb}")
    t = torch.arange(nb * tb, device=device) // tb
    return t.to(torch.int8)[None, None, :, None].expand(
        s, 2 * m2, nb * tb, k1n).contiguous()


def write_probe(s: int, nb: int, tb: int, m2: int, k1n: int, *, device=None,
                impl: str = "auto") -> torch.Tensor:
    """P2: int8 ``(s, 2*m2, nb*tb, k1n)`` with ``out[s, k2, t, k] = t //
    tb``, block ``(1, 2*m2, tb, k1n)`` b filled with b, as
    ``_write_kernel`` fills it.  ``device``: None is the current CUDA
    device."""
    if not 1 <= nb <= 128:
        raise ValueError(f"the write probe's values are int8: nb must be "
                         f"1..128, got {nb}")
    if min(s, tb, m2, k1n) < 1:
        raise ValueError(f"the write probe needs positive sizes, got s={s}, "
                         f"tb={tb}, m2={m2}, k1n={k1n}")
    dev = default_device(device)
    if resolve_impl(impl, torch.empty(0, device=dev)) == "torch":
        return write_probe_torch(s, nb, tb, m2, k1n, device=dev)
    if s > 65535 or 2 * m2 * tb * k1n >= 2 ** 31:
        raise ValueError("the write probe kernel takes at most 65535 streams "
                         "and output blocks under 2 GiB")
    out = torch.empty((s, 2 * m2, nb * tb, k1n), dtype=torch.int8, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().dcs_write_probe(
            out.data_ptr(), s, 2 * m2, nb, tb, k1n,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "dcs_write_probe")
    write_probe.launches += 1
    return out


write_probe.launches = 0


def bench_probes(s: int = S, nb: int = NB, tb: int = TB, m: int = M,
                 m2: int = M2, k1n: int = K1N, *, iters: int = 200,
                 device=None, seed: int = 0) -> list:
    """Time P1 and P2 at the script's shapes (67.1 MB read, 67.1 MB
    written): one event pair per launch with the L2 flushed before each,
    since the F-engine finds its input cold, and back to back
    (``ms_back_to_back``: part of the input still in the L2, and a launch
    is about as long as the wrapper's host work, ``host_ms_per_call``).
    Returns the two records; the rate is GB/s of the bytes the probe must
    move (the read: the blocks read, the tile and the sums written)."""
    dev = default_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    x = torch.randint(-128, 128, (s, nb * tb + 15, m), generator=gen,
                      device=dev, dtype=torch.int8)
    calls = {
        "read_probe": (lambda: read_probe(x, tb=tb, nb=nb),
                       s * nb * tb * m + 8 * 128 + s * nb * 8,
                       s * nb * tb * m),
        "write_probe": (lambda: write_probe(s, nb, tb, m2, k1n, device=dev),
                        s * 2 * m2 * nb * tb * k1n, 0),
    }
    out = []
    for name, (fn, nbytes, adds) in calls.items():
        wall = time_cuda(fn, warmup=2, iters=iters, flush_l2=True,
                         device=dev)
        warm = time_cuda(fn, warmup=0, iters=iters, device=dev)
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        host = (time.perf_counter() - t) / iters
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out.append(BenchResult(
            name=f"probe_{name}", metric=f"{name} bandwidth",
            value=nbytes / wall / 1e9, unit="GB/s", wall_s=wall,
            bytes_moved=nbytes,
            extra={"n_streams": s, "n_blocks": nb, "tb": tb, "m": m,
                   "m2": m2, "k1n": k1n, "l2_flushed": True,
                   "ms": wall * 1e3, "ms_back_to_back": warm * 1e3,
                   "host_ms_per_call": host * 1e3},
        ).finish(dev, int8_ops=adds))
    return out
