"""At-rate ingest -> runner benchmarks on one card.

PyTorch counterpart of :mod:`dc_sand_tpu.bench.ingest_bench`, with its
record names, metrics and ``extra`` keys.  It drives the port's native
packet assembler the way production would (timestamped per-stream packets
in, retired chunks out) and measures the sustained rate against
:data:`~dc_sand_tpu_torch.bench.pipelines.ARRAY_REALTIME`, the whole
array in real time (``vs_array_realtime``):

* ``ingest_host``: packets -> reassembled chunk -> (optionally) the
  runner's host coarse-delay gather, no device;
* ``ingest_runner_e2e``: the same feed driving ``FXRunner.run`` end to end
  on the card (pinned slots, the copy in the source);
* ``e2e_atrate``: SPEAD-shaped bursts -> ``NativeIngest`` -> pinned
  host-to-device copies on a copy stream -> the fx step, the feed of chunk
  i+1 overlapping the step of chunk i (:class:`Feeder`), every timed dump
  verified against the float64 golden chain; ``e2e_atrate_replay`` runs
  the same chunk loop on chunks staged on the card before the clock;
* ``ingest_udp``: the wire leg through a localhost UDP socket.

Rates are host-clock times around work that ends in
``torch.cuda.synchronize()``.
"""

from __future__ import annotations

import concurrent.futures
import os
import threading
import time

import numpy as np
import torch

from dc_sand_tpu_torch.bench.harness import BenchResult
from dc_sand_tpu_torch.bench.pipelines import ARRAY_REALTIME
from dc_sand_tpu_torch.ops._dispatch import default_device

__all__ = ["bench_ingest_host", "bench_ingest_runner",
           "bench_ingest_udp", "bench_e2e_atrate", "spead_bursts", "retime",
           "spead_feed"]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _make_bursts(a, p, c_samp, n_chunks, packet_samples, seed=0):
    """Per-chunk burst descriptors in NIC-ring shape: parallel (ant, pol,
    timestamp) arrays + one contiguous payload buffer per chunk (packet
    order (ant, pol, offset) IS the chunk layout, so the chunk's own bytes
    serve as the burst payload)."""
    if c_samp % packet_samples:
        raise ValueError(f"packets of {packet_samples} samples do not tile "
                         f"a chunk of {c_samp}")
    rng = np.random.default_rng(seed)
    data = rng.integers(-100, 100, (a, p, n_chunks * c_samp),
                        dtype=np.int8)
    npk = c_samp // packet_samples
    ants = np.repeat(np.arange(a, dtype=np.int32), p * npk)
    pols = np.tile(np.repeat(np.arange(p, dtype=np.int32), npk), a)
    offs = np.tile(np.arange(npk, dtype=np.uint64) * packet_samples,
                   a * p)
    bursts = []
    for i in range(n_chunks):
        base = i * c_samp
        payload = np.ascontiguousarray(
            data[..., base:base + c_samp]).tobytes()
        # timestamps stay RELATIVE; the driver adds the global chunk base
        # so warm + timed passes form one monotonic stream (a rewound
        # timestamp is a LATE packet the assembler rightly drops)
        bursts.append((ants, pols, offs, payload))
    return data, bursts


def bench_ingest_host(n_ants: int = 64, n_pols: int = 2,
                      n_chans: int = 1024, spectra: int = 64,
                      n_chunks: int = 8, packet_samples: int = 16384,
                      delay_in_ingest: bool = True, n_workers: int = 1,
                      max_delay: int = 64, zero_copy: bool = False,
                      device=None) -> BenchResult:
    """Host feed path: submit -> retire -> coarse delay, no device work
    (``device`` names the record).

    ``n_workers > 1`` shards the antennas over that many independent
    ingest instances driven from threads, the production layout (one
    reassembler per antenna group / NIC queue; ctypes releases the GIL
    during the native burst, so workers overlap).  One full pass over the
    ring warms the slot pages before timing.  ``delay_in_ingest`` applies
    the coarse delay at packet placement (``set_delay``); without it the
    runner's host gather runs on each retired chunk.  ``zero_copy=True``
    retires via ``retire_view`` (gaps zero-filled in place, no chunk-sized
    copy out), against the copying ``retire``.
    """
    from dc_sand_tpu_torch.runtime.ingest import NativeIngest
    dev = default_device(device)
    a, p = n_ants, n_pols
    if a % n_workers:
        raise ValueError(f"{a} antennas must divide over {n_workers}")
    aw = a // n_workers
    c_samp = spectra * 2 * n_chans
    rng = np.random.default_rng(1)
    delays = rng.integers(0, max_delay, (a, p))

    workers = []
    for w in range(n_workers):
        _, bursts = _make_bursts(aw, p, c_samp, n_chunks, packet_samples,
                                 seed=w)
        ing = NativeIngest(aw, p, c_samp, n_slots=4)
        if delay_in_ingest:
            for ai in range(aw):
                for pi in range(p):
                    ing.set_delay(ai, pi,
                                  int(delays[w * aw + ai, pi]), max_delay)
        workers.append((ing, bursts))

    def drive(w, timed_chunks):
        ing, bursts = workers[w]
        host_tail = np.zeros((aw, p, max_delay), np.int8)
        for i in timed_chunks:
            ants, pols, tss, payload = bursts[i % n_chunks]
            ing.submit_burst(ants, pols,
                             tss + np.uint64(i * c_samp), payload,
                             packet_samples)
            if zero_copy:
                chunk, _fill = ing.retire_view(force=True)
            else:
                chunk, _fill = ing.retire(force=True)
            if not delay_in_ingest:
                # the runner's coarse shift, as a vectorised host gather
                buf = np.concatenate([host_tail, chunk], axis=-1)
                win = np.lib.stride_tricks.sliding_window_view(
                    buf, c_samp, axis=-1)
                sel = (max_delay - delays[w * aw:(w + 1) * aw]
                       .astype(np.int64))[..., None, None]
                chunk = np.ascontiguousarray(
                    np.take_along_axis(win, sel, axis=2)[..., 0, :])
                host_tail = buf[..., -max_delay:]
            if zero_copy:
                # release only AFTER the view's last read
                ing.release()

    # warm: one pass over every ring slot (page first-touch); the timed
    # pass continues the SAME timestamp stream so nothing is late
    n_warm = min(4, n_chunks)
    for w in range(n_workers):
        drive(w, range(n_warm))

    timed = range(n_warm, n_warm + n_chunks)
    t0 = time.perf_counter()
    if n_workers == 1:
        drive(0, timed)
    else:
        ts = [threading.Thread(target=drive, args=(w, timed))
              for w in range(n_workers)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    wall = time.perf_counter() - t0
    samples = a * p * c_samp * n_chunks
    rate = samples / wall
    # aggregate over ALL workers: a late-drop in any of them means the
    # measured rate skipped that worker's placement memcpys
    stats = {}
    for ing, _b in workers:
        for k, v in ing.stats().items():
            stats[k] = stats.get(k, 0) + v
        ing.close()
    if stats.get("packets_late"):
        raise RuntimeError(
            f"ingest bench submitted late packets ({stats}); the "
            "measured rate would not include placement cost")
    name = f"ingest_host_{'placed' if delay_in_ingest else 'gather'}"
    if zero_copy:
        name += "_view"
    if n_workers > 1:
        name += f"_{n_workers}w"
    return BenchResult(
        name=name,
        metric="host ingest feed samples/s", value=rate, unit="samp/s",
        wall_s=wall / n_chunks, bytes_moved=samples,
        extra={"n_ants": a, "n_chans": n_chans, "spectra": spectra,
               "packet_samples": packet_samples,
               "delay_in_ingest": delay_in_ingest,
               "n_workers": n_workers, "n_chunks": n_chunks,
               "vs_array_realtime": rate / ARRAY_REALTIME,
               "stats": stats},
    ).finish(dev)


def bench_ingest_runner(n_ants: int = 16, n_pols: int = 2,
                        n_chans: int = 1024, spectra: int = 64,
                        n_chunks: int = 8, packet_samples: int = 16384,
                        device=None) -> BenchResult:
    """End to end: packets -> native ingest (coarse delay at placement) ->
    the pinned copy -> FXRunner's step on the card, one chunk at a time
    (no overlap: :func:`bench_e2e_atrate` overlaps)."""
    from dc_sand_tpu_torch.config import get_config
    from dc_sand_tpu_torch.runtime import DelayModel, FXRunner
    from dc_sand_tpu_torch.runtime.ingest import (NativeIngest,
                                                  multi_ingest_source)
    from dc_sand_tpu_torch.windows import pfb_window

    dev = default_device(device)
    cfg = get_config("fx64").replace(
        n_ants=n_ants, n_pols=n_pols, n_chans=n_chans,
        spectra_per_chunk=spectra, n_spectra_per_acc=spectra * 2)
    a, p, c_samp = n_ants, n_pols, cfg.chunk_samples
    md = 64
    _data, bursts = _make_bursts(a, p, c_samp, n_chunks, packet_samples)
    ing = NativeIngest(a, p, c_samp, n_slots=4)
    rng = np.random.default_rng(1)
    d0 = rng.integers(0, md, (a, p))
    # coarse rides packet placement; the runner sees coarse=0 and applies
    # only the fine-delay/fringe residual on the card
    for ai in range(a):
        for pi in range(p):
            ing.set_delay(ai, pi, int(d0[ai, pi]), md)
    window = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    runner = FXRunner(cfg, window, delay_model=DelayModel.zeros(a, p),
                      device=dev)
    src = multi_ingest_source([ing], cfg, device=dev)

    def source(i):
        ants, pols, tss, payload = bursts[i % n_chunks]
        ing.submit_burst(ants, pols, tss + np.uint64(i * c_samp),
                         payload, packet_samples)
        return src(i)

    # warm through a full dump cadence (the dump's first pinned buffer
    # and the kernels' first launches)
    n_warm = cfg.n_spectra_per_acc // cfg.spectra_per_chunk + 1
    runner.run(source, n_warm)
    _sync(dev)
    t0 = time.perf_counter()
    runner.run(source, n_chunks - 1)
    _sync(dev)
    wall = time.perf_counter() - t0
    ing.close()
    samples = a * p * c_samp * (n_chunks - 1)
    rate = samples / wall
    return BenchResult(
        name="ingest_runner_e2e",
        metric="ingest->runner samples/s", value=rate, unit="samp/s",
        wall_s=wall / (n_chunks - 1), bytes_moved=samples,
        extra={"n_ants": a, "n_chans": n_chans, "spectra": spectra,
               "n_chunks": n_chunks - 1,
               "vs_array_realtime": rate / ARRAY_REALTIME},
    ).finish(dev)


def _golden_dump_snrs(data, window, cfg, eq, t_lo, dumps) -> list:
    """SNR in dB of each dump against the float64 golden chain run on the
    stream segment it integrated (``data[..., t_lo:]`` onward, the true
    FIR lead-in before it).  The golden spectra of a window are made one
    stream at a time on a thread pool and kept as complex64 (their
    requantised values are integers, exact in it); the golden CMAC
    (``golden.xcorr``'s sum, in the baseline order of
    ``golden.baseline_pairs``) runs in complex128 as one product a channel,
    on blocks of channels."""
    from dc_sand_tpu_torch import golden
    from dc_sand_tpu_torch.utils import snr_db
    a, p = data.shape[:2]
    m, k = cfg.fft_size, cfg.n_chans
    bpa = cfg.n_spectra_per_acc
    lead = (cfg.n_taps - 1) * m
    gains = np.full(k, eq) + 0j
    pairs = golden.baseline_pairs(a)
    rows_i = pairs[:, 0, None, None] * p + np.arange(p)[None, :, None]
    rows_j = pairs[:, 1, None, None] * p + np.arange(p)[None, None, :]
    snrs = []
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        for di, d in enumerate(dumps):
            lo = t_lo + di * bpa * m

            def stream(ap):
                seg = data[ap[0], ap[1], lo - lead:lo + bpa * m]
                return golden.f_engine(seg, window, cfg.n_taps, k,
                                       gains=gains).astype(np.complex64)

            spec = np.stack(list(pool.map(stream, np.ndindex(a, p))))
            ref = np.empty((len(pairs), p, p, k), np.complex128)
            for k0 in range(0, k, 256):
                x = spec[..., k0:k0 + 256].transpose(2, 0, 1).astype(
                    np.complex128)                      # (kb, A*P, B)
                full = x @ x.conj().transpose(0, 2, 1)  # (kb, A*P, A*P)
                ref[..., k0:k0 + 256] = np.moveaxis(full[:, rows_i, rows_j],
                                                    0, -1)
            snrs.append(float(snr_db(ref, d.vis[..., 0] + 1j * d.vis[..., 1])))
    return snrs


def bench_e2e_atrate(n_ants: int = 16, n_pols: int = 2,
                     n_chans: int = 4096, spectra: int = 2048,
                     n_chunks: int = 6, packet_samples: int = 16384,
                     verify: bool = True, impl: str = "fused",
                     queue_depth: int = 2, feed: str = "host",
                     device=None) -> BenchResult:
    """The at-rate rehearsal with the card in the loop: packet bursts ->
    ``NativeIngest`` (pinned slots) -> host-to-device copy on a copy
    stream -> ``FXRunner``'s fx step, with the feed of chunk i+1 (packet
    placement and copy, on the :class:`Feeder`'s threads) overlapping the
    step of chunk i.  One record carries the sustained rate, the ingest's
    loss counters and the golden verification of every timed dump
    (``dumps_verified``: each dump above 50 dB against the float64 golden
    chain and fully integrated).

    ``feed="device_replay"`` stages every chunk on the card before the
    clock starts and replays them through the same runner chunk loop: the
    device side of the loop and the dump at rate, to pair with the
    ``feed="host"`` record of the whole chain.  ``impl``: ``"fused"``
    (K1) or ``"unfused"`` (K6 and PyTorch ops); ``queue_depth``: the
    device buffers the feed takes turns with.
    """
    from dc_sand_tpu_torch.config import get_config
    from dc_sand_tpu_torch.runtime import FXRunner
    from dc_sand_tpu_torch.runtime.ingest import (Feeder, NativeIngest,
                                                  multi_ingest_source)
    from dc_sand_tpu_torch.windows import pfb_window

    if impl not in ("fused", "unfused"):
        raise ValueError(f"unknown impl {impl!r}; choose fused or unfused")
    if feed not in ("host", "device_replay"):
        raise ValueError(f"feed must be 'host' or 'device_replay', "
                         f"got {feed!r}")
    dev = default_device(device)
    cfg = get_config("fx64").replace(
        n_ants=n_ants, n_pols=n_pols, n_chans=n_chans,
        spectra_per_chunk=spectra, n_spectra_per_acc=2 * spectra,
        apply_delay=False)
    a, p, c_samp = n_ants, n_pols, cfg.chunk_samples
    # warm two full dump windows and keep the timed region dump-aligned so
    # that the golden windows line up
    cpd = cfg.n_spectra_per_acc // spectra
    if n_chunks % cpd:
        raise ValueError(f"n_chunks must be dump-aligned (x{cpd})")
    n_warm = 2 * cpd
    total = n_warm + n_chunks
    data, bursts = _make_bursts(a, p, c_samp, total, packet_samples,
                                seed=5)
    window = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    # EQ gain scaled so the requantised noise spectra fill int8 without
    # saturating (0.05 for +-100 ADC noise)
    eq = 0.05
    gains_ri = np.stack([np.full((n_chans,), eq, np.float32),
                         np.zeros((n_chans,), np.float32)], -1)
    runner = FXRunner(cfg, window, gains=gains_ri, device=dev,
                      fused=impl == "fused")
    shp = (a * p, spectra, 2 * n_chans)

    ing = feeder = None
    if feed == "device_replay":
        staged = [torch.from_numpy(np.ascontiguousarray(
            data[..., i * c_samp:(i + 1) * c_samp].reshape(shp))).to(dev)
            for i in range(total)]
        _sync(dev)
        seq = iter(staged)

        def source(i):
            return next(seq)
    else:
        ing = NativeIngest(a, p, c_samp, n_slots=4)

        def submit(i):
            ants, pols, tss, payload = bursts[i]
            ing.submit_burst(ants, pols, tss + np.uint64(i * c_samp),
                             payload, packet_samples)

        feeder = Feeder(multi_ingest_source([ing], cfg, device=dev,
                                            depth=queue_depth),
                        total, [submit])
        source = feeder

    try:
        runner.run(source, n_warm)
        _sync(dev)
        t0 = time.perf_counter()
        dumps = []
        runner.run(source, n_chunks, on_dump=dumps.append)
        # on_dump's pinned copy waits for the last dump's device work
        _sync(dev)
        wall = time.perf_counter() - t0
    finally:
        if feeder is not None:
            feeder.close()
    samples = a * p * c_samp * n_chunks
    rate = samples / wall
    stats = {}
    if ing is not None:
        stats = ing.stats()
        ing.close()

    verified = None
    snrs = []
    if verify and dumps:
        snrs = _golden_dump_snrs(data, window, cfg, eq, n_warm * c_samp,
                                 dumps)
        verified = all(snr > 50 and d.n_spectra == d.n_spectra_nominal
                       for snr, d in zip(snrs, dumps))
    extra = {"n_ants": a, "n_chans": n_chans, "spectra": spectra,
             "n_chunks": n_chunks, "impl": impl,
             "frames_io": True,
             "packet_samples": packet_samples,
             "feed": feed,
             "vs_array_realtime": rate / ARRAY_REALTIME,
             "dumps_verified": verified,
             "dump_snrs_db": snrs,
             "dumps": len(dumps)}
    if feed == "host":
        extra.update(
            overlap=f"feeder thread, queue depth {queue_depth}",
            ingest_stats=stats)
    return BenchResult(
        name=("e2e_atrate" if feed == "host" else "e2e_atrate_replay"),
        metric="e2e SPEAD->ingest->device samples/s" if feed == "host"
        else "e2e device-replay samples/s", value=rate,
        unit="samp/s", wall_s=wall / n_chunks, bytes_moved=samples,
        extra=extra,
    ).finish(dev)


def bench_ingest_udp(n_ants: int = 8, n_pols: int = 2,
                     n_chans: int = 1024, spectra: int = 64,
                     n_chunks: int = 8, max_payload: int = 8192,
                     n_workers: int = 1, device=None) -> BenchResult:
    """The wire leg: SPEAD datagrams through a localhost UDP socket,
    ``SpeadTransmitter`` -> ``sendmmsg`` sink -> kernel loopback ->
    ``recvmmsg`` receiver thread -> ``NativeIngest`` -> retire, with the
    loss counters live; packetization is included on the transmit side.
    No device work (``device`` names the record).

    ``n_workers`` shards antennas over that many (socket, receiver,
    assembler) triples, one receiver per NIC queue.  Localhost loopback
    bounds what one kernel socket pair can do.
    """
    from dc_sand_tpu_torch.runtime.ingest import (NativeIngest,
                                                  SpeadTransmitter,
                                                  UdpSpeadReceiver,
                                                  UdpSpeadSink)
    dev = default_device(device)
    a, p = n_ants, n_pols
    if a % n_workers:
        raise ValueError(f"{a} antennas must divide over {n_workers}")
    aw = a // n_workers
    c_samp = spectra * 2 * n_chans
    rng = np.random.default_rng(3)
    data = rng.integers(-100, 100, (a, p, c_samp), dtype=np.int8)

    workers = []
    for w in range(n_workers):
        ing = NativeIngest(aw, p, c_samp, n_slots=4)
        rx = UdpSpeadReceiver(ing, bind_addr="127.0.0.1",
                              rcvbuf_bytes=64 * 1024 * 1024)
        sink = UdpSpeadSink("127.0.0.1", rx.port,
                            sndbuf_bytes=64 * 1024 * 1024)
        tx = SpeadTransmitter(sink, max_payload=max_payload)
        workers.append((ing, rx, sink, tx))

    def drive(w, chunks):
        ing, rx, sink, tx = workers[w]
        lo = w * aw
        for i in chunks:
            for ai in range(aw):
                for pi in range(p):
                    tx.send(data[lo + ai, pi], timestamp=i * c_samp,
                            stream=ai * p + pi)
            # real-time semantics: retire whatever arrived (the fill
            # statistic carries any socket loss); wait only for the
            # receiver to drain what the kernel actually delivered
            want = sink.stats()["datagrams"]
            t0 = time.perf_counter()
            while (rx.stats()["datagrams"] < want
                   and time.perf_counter() - t0 < 2.0):
                time.sleep(0)
            ing.retire_view(force=True)
            ing.release()

    n_warm = min(2, n_chunks)
    for w in range(n_workers):
        drive(w, range(n_warm))

    timed = range(n_warm, n_warm + n_chunks)
    t0 = time.perf_counter()
    if n_workers == 1:
        drive(0, timed)
    else:
        ts = [threading.Thread(target=drive, args=(w, timed))
              for w in range(n_workers)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    wall = time.perf_counter() - t0
    samples = a * p * c_samp * n_chunks
    rate = samples / wall
    stats = {"rx": {}, "tx": {}, "ingest": {}}
    for ing, rx, sink, _tx in workers:
        for k, v in rx.stats().items():
            stats["rx"][k] = stats["rx"].get(k, 0) + v
        for k, v in sink.stats().items():
            stats["tx"][k] = stats["tx"].get(k, 0) + v
        for k, v in ing.stats().items():
            stats["ingest"][k] = stats["ingest"].get(k, 0) + v
    for ing, rx, sink, _tx in workers:
        rx.close()
        sink.close()
        ing.close()
    name = "ingest_udp" + (f"_{n_workers}w" if n_workers > 1 else "")
    return BenchResult(
        name=name,
        metric="UDP-socket ingest feed samples/s", value=rate,
        unit="samp/s", wall_s=wall / n_chunks, bytes_moved=samples,
        extra={"n_ants": a, "n_chans": n_chans, "spectra": spectra,
               "max_payload": max_payload, "n_workers": n_workers,
               "n_chunks": n_chunks,
               "vs_array_realtime": rate / ARRAY_REALTIME,
               "stats": stats},
    ).finish(dev)


# byte offset of the timestamp item in a datagram of spead_packetize
# (csrc/ingest.cpp:spead_encode: header, heap id, heap length, payload
# offset, payload length, then the timestamp)
_TS_ITEM = 40


def spead_bursts(chunk: np.ndarray, n_workers: int) -> list:
    """Packetize the int8 chunk ``(A, P, C)`` for ``n_workers`` assemblers
    of ``A / n_workers`` antennas each: per assembler one burst
    ``(bytearray, lens)`` of its streams' heaps (stream ids local to it,
    ``ant * P + pol``) at timestamp 0, with :func:`spead_packetize`'s
    defaults (8192-byte payloads).  :func:`retime` moves a burst along the
    stream."""
    from dc_sand_tpu_torch.runtime.ingest import spead_packetize
    a, p, _c = chunk.shape
    if a % n_workers:
        raise ValueError(f"{a} antennas must divide over {n_workers}")
    aw = a // n_workers

    def burst(w):
        parts = [spead_packetize(chunk[w * aw + ai, pi], 0, ai * p + pi)
                 for ai in range(aw) for pi in range(p)]
        return (bytearray(b"".join(b for b, _ in parts)),
                np.concatenate([lens for _, lens in parts]))

    with concurrent.futures.ThreadPoolExecutor(n_workers) as pool:
        return list(pool.map(burst, range(n_workers)))


def retime(blob: bytearray, lens: np.ndarray, timestamp: int) -> None:
    """Rewrite, in place, the timestamp item of every datagram of a burst
    that :func:`spead_packetize` made: the same samples, ``timestamp``
    later on the stream."""
    ts_id = 0x1600                  # spead_packetize's default ts_id
    arr = np.frombuffer(blob, np.uint8)
    offs = (np.cumsum(lens, dtype=np.int64) - lens.astype(np.int64))
    idx = offs[:, None] + _TS_ITEM + np.arange(8)
    ids = arr[idx[:, :2]].astype(np.int64)
    if np.any(((ids[:, 0] & 0x7F) << 8 | ids[:, 1]) != ts_id):
        raise ValueError("not a burst of spead_packetize's datagrams")
    item = np.array([(1 << 63) | (ts_id << 48) | timestamp], ">u8")
    arr[idx] = item.view(np.uint8)


def spead_feed(chunk: np.ndarray, n_chunks: int, *, n_workers: int = 4,
               delays=None, max_delay: int = 0, cfg=None,
               device=None) -> tuple:
    """The overlapped ingest feed of a runner on one stream: the host
    chunk ``(A, P, C)`` int8 repeated ``n_chunks`` times with advancing
    timestamps, packetized once (:func:`spead_bursts`) for ``n_workers``
    assemblers of ``A / n_workers`` antennas with 3 slots each (the
    :class:`Feeder`'s least; pinned on a card), every stream's integer
    coarse delay ``delays[a, p]`` in ``[0, max_delay]`` set at placement,
    each assembler fed from its own thread with ``submit_spead_burst``,
    the chunks copied to ``device`` by :func:`multi_ingest_source` (two
    device buffers) on a :class:`Feeder`.

    Returns ``(feeder, ingests, submit_ms)``: the runner's source (call
    ``feeder.close()`` after the run), the assemblers (close them after)
    and the list each submit appends its host ms to."""
    from dc_sand_tpu_torch.runtime.ingest import (Feeder, NativeIngest,
                                                  multi_ingest_source)
    a, p, c = chunk.shape
    aw = a // n_workers
    bursts = spead_bursts(chunk, n_workers)
    ingests = [NativeIngest(aw, p, c, n_slots=3) for _ in range(n_workers)]
    if delays is not None:
        for w, ing in enumerate(ingests):
            for ai in range(aw):
                for pi in range(p):
                    ing.set_delay(ai, pi, int(delays[w * aw + ai, pi]),
                                  max_delay)
    submit_ms = []

    def submitter(w):
        blob, lens = bursts[w]

        def submit(i):
            t = time.perf_counter()
            retime(blob, lens, i * c)
            placed = ingests[w].submit_spead_burst((blob, lens))
            submit_ms.append((time.perf_counter() - t) * 1e3)
            if placed != len(lens):
                raise RuntimeError(f"assembler {w} placed {placed} of "
                                   f"{len(lens)} datagrams of chunk {i}: "
                                   f"{ingests[w].stats()}")
        return submit

    feeder = Feeder(multi_ingest_source(ingests, cfg, device=device),
                    n_chunks, [submitter(w) for w in range(n_workers)])
    return feeder, ingests, submit_ms
