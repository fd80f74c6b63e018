"""ctypes wrapper for the port's native ingest library
(``dc_sand_tpu_torch/csrc/ingest.cpp``), and the feed of its chunks to the
card.

PyTorch counterpart of :mod:`dc_sand_tpu.runtime.ingest`, with the same
names, constants, signatures, return values and errors.  Packet reassembly
and the 10-bit unpack run in C++, built with ``g++`` at first use into
``build/torch_ingest/`` (:func:`dc_sand_tpu_torch._build.ingest_library`).
For the card it adds:

* ``NativeIngest(..., pinned=None)``: on a machine with a CUDA device every
  slot of the ring is registered with ``cudaHostRegister`` (page-locked),
  so that a retired chunk goes to the card by DMA straight out of its slot;
  a registration that fails raises, the slots are never used pageable;
* :func:`multi_ingest_source`: each assembler's retired view is copied
  ``non_blocking`` on a copy stream of its own straight into its antenna
  rows of one of ``depth`` device buffers, handed to the consuming stream
  through an event, and its slot released only once the copy is done;
* :class:`Feeder`: the packet submission and those copies on threads
  beside the runner, so that chunk i+1's host-to-device copy runs on the
  copy engine while chunk i's step runs.
"""

from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import queue
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from dc_sand_tpu_torch import _build
from dc_sand_tpu_torch.ops._dispatch import default_device

__all__ = ["NativeIngest", "load_library", "unpack_10bit",
           "multi_ingest_source", "spead_packetize", "IngestSource",
           "Feeder", "SpeadTransmitter", "UdpSpeadReceiver", "UdpSpeadSink"]

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()


def load_library() -> ctypes.CDLL:
    """Load (building if needed) the port's ingest library; threads may
    call it at once."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(str(_build.ingest_library())))
    return _LIB


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' argument and result types."""
    lib.ingest_create.restype = ctypes.c_void_p
    lib.ingest_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                  ctypes.c_uint64, ctypes.c_int]
    lib.ingest_destroy.argtypes = [ctypes.c_void_p]
    lib.ingest_submit.restype = ctypes.c_int
    lib.ingest_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int]
    lib.ingest_submit_burst.restype = ctypes.c_longlong
    lib.ingest_submit_burst.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int]
    lib.ingest_retire.restype = ctypes.c_longlong
    lib.ingest_retire.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_int8),
                                  ctypes.c_int]
    lib.ingest_retire_view.restype = ctypes.c_longlong
    lib.ingest_retire_view.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_int8)),
        ctypes.c_int]
    lib.ingest_release.argtypes = [ctypes.c_void_p]
    lib.ingest_tail_complete.restype = ctypes.c_int
    lib.ingest_tail_complete.argtypes = [ctypes.c_void_p]
    lib.ingest_n_slots.restype = ctypes.c_int
    lib.ingest_n_slots.argtypes = [ctypes.c_void_p]
    lib.ingest_slot_buffer.restype = ctypes.c_int
    lib.ingest_slot_buffer.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_uint64)]
    lib.ingest_submit_spead.restype = ctypes.c_longlong
    lib.ingest_submit_spead.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.ingest_submit_spead_burst.restype = ctypes.c_longlong
    lib.ingest_submit_spead_burst.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.ingest_stats.argtypes = [ctypes.c_void_p] + \
        [ctypes.POINTER(ctypes.c_uint64)] * 4
    lib.spead_encode.restype = ctypes.c_longlong
    lib.spead_encode.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_uint64, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64]
    lib.ingest_set_delay.restype = ctypes.c_int
    lib.ingest_set_delay.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_longlong,
                                     ctypes.c_longlong]
    lib.unpack_10bit.argtypes = [ctypes.c_char_p,
                                 ctypes.POINTER(ctypes.c_int8),
                                 ctypes.c_uint64]
    lib.udp_rx_create.restype = ctypes.c_void_p
    lib.udp_rx_create.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.udp_rx_port.restype = ctypes.c_int
    lib.udp_rx_port.argtypes = [ctypes.c_void_p]
    lib.udp_rx_stats.argtypes = [ctypes.c_void_p] + \
        [ctypes.POINTER(ctypes.c_uint64)] * 4
    lib.udp_rx_destroy.argtypes = [ctypes.c_void_p]
    lib.udp_tx_create.restype = ctypes.c_void_p
    lib.udp_tx_create.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                  ctypes.c_int]
    lib.udp_tx_send_burst.restype = ctypes.c_longlong
    lib.udp_tx_send_burst.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64]
    lib.udp_tx_stats.argtypes = [ctypes.c_void_p] + \
        [ctypes.POINTER(ctypes.c_uint64)] * 3
    lib.udp_tx_destroy.argtypes = [ctypes.c_void_p]
    return lib


def unpack_10bit(packed: bytes, n_samples: int) -> np.ndarray:
    """Unpack 10-bit big-endian samples to int8 (drops 2 LSBs)."""
    lib = load_library()
    out = np.empty(n_samples, np.int8)
    lib.unpack_10bit(packed,
                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
                     n_samples)
    return out


def spead_packetize(payload, timestamp: int, stream: int, *,
                    heap_id: int = 0, max_payload: int = 8192,
                    ts_id: int = 0x1600, stream_id: int = 0x3101,
                    align: int = 1):
    """Packetize one heap into SPEAD-64-48 datagrams (native encoder,
    ``csrc/ingest.cpp:spead_encode``, the transmit mirror of
    :meth:`NativeIngest.submit_spead`).

    ``payload`` is any bytes-like / contiguous ndarray (an int8 stream
    chunk, a visibility dump's raw bytes); it is split into packets of at
    most ``max_payload`` payload bytes, each self-describing via immediate
    items (heap id, heap length, payload offset/length, ``ts_id``
    timestamp, ``stream_id`` stream index).  Returns ``(buf, lens)``:
    datagrams stored back to back, the burst shape
    :meth:`NativeIngest.submit_spead_burst` or a ``sendmmsg()`` loop
    consumes.

    ``align`` forces payload split points to multiples of that many bytes:
    10-bit packed streams (4 samples / 5 bytes) must pass ``align=5``, the
    decoder rejects heaps split off a group boundary.
    """
    lib = load_library()
    if align > 1:
        if max_payload < align:
            raise ValueError(f"max_payload {max_payload} < align {align}")
        max_payload -= max_payload % align
    data = np.ascontiguousarray(
        np.frombuffer(memoryview(payload).cast("B"), np.uint8)
        if not isinstance(payload, np.ndarray)
        else payload.reshape(-1).view(np.uint8))
    n_pkts = -(-len(data) // max_payload)
    hdr = 8 + 8 * 6
    buf = ctypes.create_string_buffer(hdr * n_pkts + len(data))
    lens = np.empty(n_pkts, np.uint64)
    n = lib.spead_encode(
        buf, len(buf), lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n_pkts, data.ctypes.data_as(ctypes.c_char_p), len(data),
        heap_id, timestamp, stream, ts_id, stream_id, max_payload)
    if n < 0:
        raise ValueError("spead_encode: empty payload or capacity bug")
    return buf.raw, lens[:n]


class SpeadTransmitter:
    """Outward SPEAD sender for the signal chain's products (visibility
    dumps, beam data leave the correlator as SPEAD heaps over UDP).

    Packetizes each array it is given as one heap per stream with a
    monotonically increasing heap id, and hands the datagram burst to
    ``sink(buf, lens)``: a :class:`UdpSpeadSink` in deployment, or a
    :class:`NativeIngest` loopback in tests.  Transport only: no device
    work, no copies beyond the packet build.
    """

    def __init__(self, sink, *, max_payload: int = 8192,
                 ts_id: int = 0x1600, stream_id: int = 0x3101,
                 ticks_per_chunk: int = 1):
        self._sink = sink
        self._max_payload = max_payload
        self._ids = (ts_id, stream_id)
        self._ticks_per_chunk = ticks_per_chunk
        self._heap = 0
        self.heaps_sent = 0

    def send(self, payload, timestamp: int, stream: int = 0) -> int:
        """Ship one heap; returns the number of datagrams emitted."""
        buf, lens = spead_packetize(
            payload, timestamp, stream, heap_id=self._heap,
            max_payload=self._max_payload, ts_id=self._ids[0],
            stream_id=self._ids[1])
        self._heap += 1
        self.heaps_sent += 1
        self._sink(buf, lens)
        return len(lens)

    def send_dump(self, dump) -> int:
        """Ship a runner :class:`~dc_sand_tpu_torch.runtime.runner.Dump`:
        visibilities (stream 0) and, when present, beam data (stream 1).
        The 0x1600 timestamp is in ADC sample ticks, so the dump's first
        chunk index is scaled by ``ticks_per_chunk`` (pass
        ``cfg.chunk_samples`` to place dumps on the stream's timeline)."""
        ts = int(getattr(dump, "first_chunk", 0)) * self._ticks_per_chunk
        n = self.send(np.ascontiguousarray(dump.vis), ts, 0)
        beams = getattr(dump, "beams", None)
        if beams is not None:
            n += self.send(np.ascontiguousarray(beams), ts, 1)
        return n


class NativeIngest:
    """Chunk assembler: submit timestamped packets, retire (A,P,C) chunks.

    Usage as a runner source::

        ing = NativeIngest(cfg.n_ants, cfg.n_pols, cfg.chunk_samples)
        ... feed packets (e.g. from a socket thread) via ing.submit(...)
        runner.run(lambda i: ing.retire(force=True)[0], n_chunks)

    ``pinned``: register every slot of the ring with the CUDA driver
    (``cudaHostRegister``), so that :meth:`retire_view` hands out
    page-locked memory the card copies from by DMA.  ``None`` pins when a
    CUDA device is present; ``True`` without one raises.  A registration
    that fails raises: the slots are never used pageable on the card.
    :meth:`close` (or the collector) unregisters them before the ring is
    freed.
    """

    FORMAT_INT8 = 0
    FORMAT_10BIT = 1

    def __init__(self, n_ants: int, n_pols: int, chunk_samples: int,
                 n_slots: int = 4, pinned: Optional[bool] = None):
        self._lib = load_library()
        self._shape = (n_ants, n_pols, chunk_samples)
        self._registered = []
        self._h = ctypes.c_void_p(self._lib.ingest_create(
            n_ants, n_pols, chunk_samples, n_slots))
        if not self._h:
            raise ValueError(
                f"bad ingest geometry: n_ants={n_ants}, n_pols={n_pols},"
                f" chunk_samples={chunk_samples}, n_slots={n_slots} "
                "(all must be positive)")
        if pinned is None:
            pinned = torch.cuda.is_available()
        if pinned:
            try:
                self._register()
            except BaseException:
                self.close()
                raise

    @property
    def n_slots(self) -> int:
        """Slots in the ring."""
        return self._lib.ingest_n_slots(self._h)

    @property
    def pinned(self) -> bool:
        """True when every slot is registered with the CUDA driver."""
        return bool(self._registered)

    def _slots(self) -> list:
        """``(address, bytes)`` of each slot's buffer (whole pages)."""
        out = []
        for i in range(self.n_slots):
            ptr, nbytes = ctypes.c_void_p(), ctypes.c_uint64()
            if self._lib.ingest_slot_buffer(self._h, i, ctypes.byref(ptr),
                                            ctypes.byref(nbytes)) != 0:
                raise RuntimeError(f"ingest_slot_buffer refused slot {i}")
            out.append((ptr.value, nbytes.value))
        return out

    def _register(self) -> None:
        if not torch.cuda.is_available():
            raise RuntimeError("pinned ingest slots need a CUDA device")
        cudart = torch.cuda.cudart()
        for ptr, nbytes in self._slots():
            err = cudart.cudaHostRegister(ptr, nbytes, 0)
            if err != cudart.cudaError.success:
                raise RuntimeError(
                    f"cudaHostRegister refused a {nbytes}-byte ingest slot "
                    f"({err}); lower n_slots or the chunk size (the "
                    "slots are never used pageable on the card)")
            self._registered.append(ptr)

    def set_delay(self, ant: int, pol: int, delay: int,
                  max_delay: int) -> None:
        """Coarse delay as a packet-placement offset: stream samples land
        ``delay`` later on the aligned timeline; ``max_delay`` bounds it."""
        r = self._lib.ingest_set_delay(self._h, ant, pol, delay, max_delay)
        if r != 0:
            raise ValueError(
                f"bad delay {delay} (max {max_delay}) for ({ant},{pol})")

    def submit(self, ant: int, pol: int, timestamp: int,
               payload: bytes, n_samples: Optional[int] = None,
               fmt: int = FORMAT_INT8) -> int:
        if n_samples is None:
            if fmt == self.FORMAT_10BIT:
                n_samples = len(payload) * 8 // 10
            else:
                n_samples = len(payload)
        return self._lib.ingest_submit(self._h, ant, pol, timestamp,
                                       payload, n_samples, fmt)

    def submit_burst(self, ants: np.ndarray, pols: np.ndarray,
                     timestamps: np.ndarray, payloads,
                     samples_per_packet: int,
                     fmt: int = FORMAT_INT8) -> int:
        """Submit a burst of equal-size packets in ONE native call.

        ``ants``/``pols`` int32, ``timestamps`` uint64 (parallel arrays,
        one entry per packet); ``payloads`` the packets' bytes stored
        contiguously: the NIC-ring shape a real receiver hands over, with
        one ctypes crossing for the burst.  Returns the number of packets
        accepted."""
        ants = np.ascontiguousarray(ants, np.int32)
        pols = np.ascontiguousarray(pols, np.int32)
        timestamps = np.ascontiguousarray(timestamps, np.uint64)
        n = len(ants)
        return self._lib.ingest_submit_burst(
            self._h,
            ants.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            pols.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            timestamps.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            payloads, samples_per_packet, n, fmt)

    # SPEAD application item IDs (MeerKAT convention for the timestamp;
    # the stream item carries ant * n_pols + pol)
    SPEAD_TS_ID = 0x1600
    SPEAD_STREAM_ID = 0x3101

    def submit_spead(self, datagram: bytes,
                     ts_id: int = SPEAD_TS_ID,
                     stream_id: int = SPEAD_STREAM_ID,
                     fmt: int = FORMAT_INT8) -> int:
        """Decode + place one SPEAD-64-48 datagram (8-byte header, BE64
        item pointers, payload; multi-packet heaps place via the 0x03
        payload-offset item).  Returns 0 ok, <0 on late/malformed (see
        ``csrc/ingest.cpp``)."""
        return self._lib.ingest_submit_spead(
            self._h, datagram, len(datagram), ts_id, stream_id, fmt)

    def submit_spead_burst(self, datagrams, ts_id: int = SPEAD_TS_ID,
                           stream_id: int = SPEAD_STREAM_ID,
                           fmt: int = FORMAT_INT8) -> int:
        """One native call for a burst of SPEAD datagrams (the recvmmsg()
        shape).  ``datagrams`` is a list of datagram bytes, or a
        pre-packed ``(blob, lens)`` pair as produced by
        :func:`spead_packetize` (``blob`` bytes, or a bytearray that the
        caller rewrites between bursts, passed by address).  Returns the
        number placed."""
        if (isinstance(datagrams, tuple) and len(datagrams) == 2
                and isinstance(datagrams[0], (bytes, bytearray))
                and isinstance(datagrams[1], np.ndarray)
                and datagrams[1].dtype.kind in "iu"):
            # (blob, lens) pair: a 2-tuple of raw datagram BYTES (both
            # elements bytes, no ndarray) still takes the list path
            blob, lens = datagrams
            lens = np.ascontiguousarray(lens, np.uint64)
            if isinstance(blob, bytearray):
                blob = (ctypes.c_char * len(blob)).from_buffer(blob)
        else:
            lens = np.asarray([len(d) for d in datagrams], np.uint64)
            blob = b"".join(datagrams)
        return self._lib.ingest_submit_spead_burst(
            self._h, blob,
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(lens), ts_id, stream_id, fmt)

    def retire(self, force: bool = False):
        """-> (chunk int8 (A,P,C) or None, fill_fraction)."""
        out = np.empty(self._shape, np.int8)
        r = self._lib.ingest_retire(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)),
            1 if force else 0)
        if r == -5:
            raise RuntimeError("a retire_view() slot is still lent out "
                               "for this ring position; release() first")
        if r < 0:
            return None, 0.0
        return out, r / 1e6

    def retire_view(self, force: bool = False):
        """Zero-copy retire: -> (chunk VIEW int8 (A,P,C) or None, fill).

        The returned array aliases the assembler's own slot buffer (gap
        bytes zero-filled in place), page-locked when the ingest is
        :attr:`pinned`: the feed hands it straight to the host-to-device
        copy.  The slot stays out of the ring until :meth:`release`; only
        one view may be outstanding at a time."""
        ptr = ctypes.POINTER(ctypes.c_int8)()
        r = self._lib.ingest_retire_view(self._h, ctypes.byref(ptr),
                                         1 if force else 0)
        if r == -5:
            raise RuntimeError("retire_view already outstanding; "
                               "release() first")
        if r < 0:
            return None, 0.0
        arr = np.ctypeslib.as_array(ptr, shape=self._shape)
        return arr, r / 1e6

    def release(self) -> None:
        """Return the retire_view slot to the ring (the view's memory must
        no longer be read, by the host or by a copy in flight)."""
        self._lib.ingest_release(self._h)

    def tail_complete(self) -> bool:
        """True if the oldest chunk is fully covered and retirable: a
        peek, consuming nothing (multi-assembler consumers check all
        workers before retiring any)."""
        return bool(self._lib.ingest_tail_complete(self._h))

    def stats(self):
        ok = ctypes.c_uint64()
        late = ctypes.c_uint64()
        bad = ctypes.c_uint64()
        clipped = ctypes.c_uint64()
        self._lib.ingest_stats(self._h, ctypes.byref(ok),
                               ctypes.byref(late), ctypes.byref(bad),
                               ctypes.byref(clipped))
        return {"packets_ok": ok.value, "packets_late": late.value,
                "packets_bad": bad.value,
                # placed but lost a chunk segment to a borrowed-slot
                # wrap: consumer-too-slow data loss, invisible in
                # packets_ok/bad alone
                "packets_clipped": clipped.value}

    def close(self) -> None:
        """Unregister the slots, then free the assembler."""
        if getattr(self, "_h", None):
            if self._registered:
                cudart = torch.cuda.cudart()
                while self._registered:
                    err = cudart.cudaHostUnregister(self._registered[-1])
                    if err != cudart.cudaError.success:
                        # freeing a range the driver still holds is
                        # undefined: keep the ring (a leak) and say so
                        raise RuntimeError(f"cudaHostUnregister of an "
                                           f"ingest slot failed ({err})")
                    self._registered.pop()
            self._lib.ingest_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class IngestSource:
    """A runner ``source`` over assemblers that shard the antenna axis
    (:func:`multi_ingest_source`).

    Calling it retires chunk i: each assembler's view is copied into its
    antenna rows of one of ``depth`` device buffers ``(A, P, C)`` int8, on
    a CUDA device ``non_blocking`` on the source's own copy stream.  An
    event recorded after the copies is waited for on the consuming stream
    (the caller's current stream) before the buffer is returned, and every
    borrowed slot is released, in a ``finally``, only once the copies are
    done.  A buffer is refilled only after an event recorded on the
    consuming stream at the next call, after the step that read it.

    :meth:`fill` (the producer half, on any thread) and :meth:`consumed`
    and :meth:`hand_off` (the consumer half, on the consuming thread) let
    a :class:`Feeder` run the copies ahead of the runner.
    """

    def __init__(self, ingests, cfg=None, force: bool = True, *,
                 device=None, depth: int = 2):
        self.ingests = list(ingests)
        if not self.ingests or depth < 1:
            raise ValueError("multi_ingest_source needs assemblers and "
                             "depth >= 1")
        shapes = [ing._shape for ing in self.ingests]
        p, c = shapes[0][1:]
        if any(s[1:] != (p, c) for s in shapes):
            raise ValueError(f"the assemblers' (pols, samples) differ: "
                             f"{shapes}")
        a = sum(s[0] for s in shapes)
        self._frames = None
        if cfg is not None:
            if (a, p, c) != (cfg.n_ants, cfg.n_pols, cfg.chunk_samples):
                raise ValueError(
                    f"the assemblers hold (A, P, C) = {(a, p, c)}, the "
                    f"config {(cfg.n_ants, cfg.n_pols, cfg.chunk_samples)}")
            self._frames = (a * p, cfg.spectra_per_chunk, cfg.fft_size)
        edges = np.cumsum([0] + [s[0] for s in shapes])
        self._rows = list(zip(edges[:-1], edges[1:]))
        self.force = force
        self.device = default_device(device)
        self._cuda = self.device.type == "cuda"
        if self._cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._bufs = [torch.empty((a, p, c), dtype=torch.int8,
                                  device=self.device) for _ in range(depth)]
        self._copy = torch.cuda.Stream(self.device) if self._cuda else None
        # per buffer: None (free), _LENT (handed out, its step not yet
        # enqueued) or the consuming stream's event after that step
        self._free = [None] * depth
        self._cond = threading.Condition()
        self._next = 0          # the buffer the next fill takes
        self._last = None       # the buffer the consumer holds
        # device ms of the latest fills' copies (CUDA events on the copy
        # stream, from the end of the wait for the buffer to the last copy)
        self.copy_ms = collections.deque(maxlen=1024)

    def __call__(self, _chunk_idx: int) -> torch.Tensor:
        self.consumed()
        return self.hand_off(*self.fill())

    def fill(self, stop: Optional[threading.Event] = None,
             timeout: Optional[float] = None) -> tuple:
        """Producer half: retire the next chunk of every assembler into
        the next device buffer; returns ``(buffer index, ready event or
        None)``.  Waits (up to ``timeout`` s, or until ``stop`` is set) for
        the consumer to be done with the buffer."""
        if not self.force:
            # check ALL workers before retiring ANY: a retire that fails
            # midway would consume chunks from the earlier ingests and
            # desynchronise the workers by one chunk
            for ing in self.ingests:
                if not ing.tail_complete():
                    raise RuntimeError(
                        "multi_ingest_source(force=False): a worker's "
                        "tail chunk is incomplete")
        k = self._next
        with self._cond:
            if not self._cond.wait_for(
                    lambda: self._free[k] is not _LENT
                    or (stop is not None and stop.is_set()), timeout):
                raise RuntimeError(f"no device buffer came free in "
                                   f"{timeout} s")
            if stop is not None and stop.is_set():
                raise _Stopped
            after = self._free[k]
        buf = self._bufs[k]
        borrowed = []
        ready = None
        try:
            views = []
            for ing in self.ingests:
                view, _fill = ing.retire_view(force=self.force)
                if view is None:
                    raise RuntimeError(
                        "multi_ingest_source(force=False): a worker's "
                        "tail chunk is incomplete")
                borrowed.append(ing)
                views.append(torch.from_numpy(view))
            if self._cuda:
                for view in views:
                    if not view.is_pinned():
                        raise RuntimeError(
                            "an ingest slot is not pinned: build the "
                            "assemblers with pinned=True for the card")
                start = torch.cuda.Event(enable_timing=True)
                ready = torch.cuda.Event(enable_timing=True)
                with torch.cuda.stream(self._copy):
                    if after is not None:
                        self._copy.wait_event(after)
                    start.record(self._copy)
                    for (lo, hi), view in zip(self._rows, views):
                        buf[lo:hi].copy_(view, non_blocking=True)
                    ready.record(self._copy)
            else:
                for (lo, hi), view in zip(self._rows, views):
                    buf[lo:hi].copy_(view)
        finally:
            # the copies MUST be done before the slots return to the ring:
            # a receiver thread may overwrite a released slot at once.
            # Release in a finally so that a failed retire (an incomplete
            # tail with force=False) leaves no slot lent out.
            if self._cuda:
                self._copy.synchronize()
            for ing in borrowed:
                ing.release()
        if ready is not None:
            self.copy_ms.append(start.elapsed_time(ready))
        with self._cond:
            self._free[k] = _LENT
        self._next = (k + 1) % len(self._bufs)
        return k, ready

    def consumed(self) -> None:
        """Consumer half, at the start of each call for a chunk: everything
        that read the buffer handed out last is enqueued by now, so an
        event recorded here on the consuming stream frees it."""
        if self._last is None:
            return
        ev = None
        if self._cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
        with self._cond:
            self._free[self._last] = ev
            self._cond.notify_all()
        self._last = None

    def hand_off(self, k: int, ready) -> torch.Tensor:
        """Consumer half: the consuming stream waits for buffer ``k``'s
        copies; returns it, ``(A*P, B, M)`` frames when a config was
        given, else ``(A, P, C)``."""
        if ready is not None:
            torch.cuda.current_stream(self.device).wait_event(ready)
        self._last = k
        buf = self._bufs[k]
        return buf.view(self._frames) if self._frames else buf

    def wake(self) -> None:
        """Wake a producer waiting in :meth:`fill` (to see its ``stop``)."""
        with self._cond:
            self._cond.notify_all()


_LENT = object()      # a buffer handed out whose step is not yet enqueued


class _Stopped(Exception):
    """The feed was closed while a producer waited."""


def multi_ingest_source(ingests, cfg=None, force: bool = True, *,
                        device=None, depth: int = 2) -> IngestSource:
    """Runner ``source`` over N assemblers sharding the antenna axis: the
    production layout (one :class:`NativeIngest` per NIC queue / antenna
    group, each fed from its own receiver thread), with the coarse delay
    placed at the packet boundary (``set_delay``).

    Each call retires one chunk VIEW per assembler (zero-copy) and copies
    each straight into its antenna rows of a device buffer: the full
    chunk is never put together on the host and there is no device
    concatenation.  On a CUDA device (``device=None`` is the current one)
    the copies run ``non_blocking`` from the pinned slots on a copy stream
    (see :class:`IngestSource`); on the CPU they are plain copies with the
    same result.  With ``cfg`` the chunk comes in the F-engine's frame
    form ``(A*P, B, M)`` (a view), else ``(A, P, C)``; ``depth`` device
    buffers take turns.  Wrap it in a :class:`Feeder` to overlap the copies
    with the runner's steps.
    """
    return IngestSource(ingests, cfg, force, device=device, depth=depth)


class Feeder:
    """The overlapped feed: a runner ``source`` that runs the packet
    submission and the ingest's copies on threads ahead of the runner.

    A producer thread (on the source's device, ``torch.cuda.set_device``,
    and the source's copy stream) takes chunks 0 .. ``n_chunks`` - 1 in
    order: it waits until every ``submit[w](i)`` has placed chunk i's
    packets, starts each ``submit[w](i + 1)`` on its own thread (one thread
    per callable: one per assembler, as a receiver per NIC queue), waits
    until the runner asks for chunk i, then :meth:`IngestSource.fill` s it.
    The runner asks for chunk i right after it has enqueued the step of
    chunk i - 1, so chunk i's copy runs on the copy engine while that step
    runs, and chunk i + 1's packets are placed meanwhile.  The copy must
    not be issued earlier: the step's own small host-to-device copies (the
    delays) would queue behind it on the copy engine, and the step with
    them.  The ring must hold the chunk being copied, the one being placed
    and the one a coarse delay spills into, so each assembler needs
    ``n_slots >= 3`` when ``submit`` is given; the source needs ``depth
    >= 2``.

    Calling it returns chunk i on the consuming stream; it raises when
    the producer failed (its exception is the cause) or produced nothing
    in ``timeout`` seconds.  :meth:`close` (or leaving the ``with``
    block) stops and joins the threads.
    """

    def __init__(self, source: IngestSource, n_chunks: int,
                 submit: Sequence[Callable[[int], object]] = (), *,
                 timeout: float = 120.0):
        if len(source._bufs) < 2:
            raise ValueError("the overlapped feed needs a source of "
                             "depth >= 2")
        if submit and any(ing.n_slots < 3 for ing in source.ingests):
            raise ValueError("the overlapped feed needs assemblers of "
                             "n_slots >= 3")
        self.source = source
        self.n_chunks = n_chunks
        self.timeout = timeout
        self._submit = list(submit)
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._asked = threading.Semaphore(0)    # a permit a chunk asked for
        self._next = 0
        self._thread = threading.Thread(target=self._produce,
                                        name="ingest-feeder", daemon=True)
        self._thread.start()

    def _produce(self) -> None:
        pools = [concurrent.futures.ThreadPoolExecutor(1)
                 for _ in self._submit]
        try:
            if self.source._cuda:
                torch.cuda.set_device(self.source.device)
            pending = [p.submit(fn, 0) for p, fn in zip(pools, self._submit)]
            for i in range(self.n_chunks):
                for f in pending:
                    f.result(timeout=self.timeout)
                pending = ([p.submit(fn, i + 1)
                            for p, fn in zip(pools, self._submit)]
                           if i + 1 < self.n_chunks else [])
                while not self._asked.acquire(timeout=0.1):
                    if self._stop.is_set():
                        raise _Stopped
                k, ready = self.source.fill(self._stop, self.timeout)
                self._q.put((i, k, ready))
        except _Stopped:
            pass
        except BaseException as exc:     # handed to the consumer
            self._q.put((None, exc, None))
        finally:
            for p in pools:
                p.shutdown(wait=True, cancel_futures=True)

    def __call__(self, _chunk_idx: int) -> torch.Tensor:
        if self._next >= self.n_chunks:
            raise RuntimeError(f"the feed holds {self.n_chunks} chunks")
        self.source.consumed()
        self._asked.release()
        try:
            i, k, ready = self._q.get(timeout=self.timeout)
        except queue.Empty:
            raise RuntimeError(f"the feed produced no chunk in "
                               f"{self.timeout} s") from None
        if i is None:
            raise RuntimeError("the ingest feeder thread failed") from k
        self._next += 1
        return self.source.hand_off(k, ready)

    def close(self) -> None:
        self._stop.set()
        self.source.wake()
        self._thread.join(self.timeout)
        if self._thread.is_alive():
            raise RuntimeError("the ingest feeder thread did not stop")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class UdpSpeadReceiver:
    """The wire leg of the ingest tier: a native ``recvmmsg()`` thread
    pumping SPEAD datagrams off a real UDP socket into a
    :class:`NativeIngest` assembler.  All datagram handling stays in C++
    (``csrc/ingest.cpp:udp_rx_create``); Python only starts/stops and
    reads counters.

    ``port=0`` binds an ephemeral port (read it back from ``.port``).  The
    receiver holds a reference to the ingest so the assembler cannot be
    collected under the thread.
    """

    def __init__(self, ingest: NativeIngest, *, bind_addr: str = "0.0.0.0",
                 port: int = 0, ts_id: int = NativeIngest.SPEAD_TS_ID,
                 stream_id: int = NativeIngest.SPEAD_STREAM_ID,
                 fmt: int = NativeIngest.FORMAT_INT8,
                 rcvbuf_bytes: int = 8 * 1024 * 1024):
        self._lib = load_library()
        self._ingest = ingest          # keep the assembler alive
        self._h = ctypes.c_void_p(self._lib.udp_rx_create(
            ingest._h, bind_addr.encode(), port, ts_id, stream_id, fmt,
            rcvbuf_bytes))
        if not self._h:
            raise OSError(
                f"udp_rx_create failed for {bind_addr}:{port} "
                "(bad address or bind error)")
        self.port = self._lib.udp_rx_port(self._h)

    def stats(self):
        vals = [ctypes.c_uint64() for _ in range(4)]
        self._lib.udp_rx_stats(self._h, *map(ctypes.byref, vals))
        return {"datagrams": vals[0].value, "bytes": vals[1].value,
                "placed": vals[2].value, "rejected": vals[3].value}

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.udp_rx_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class UdpSpeadSink:
    """``sendmmsg()`` transmit sink for :class:`SpeadTransmitter`: ships a
    packetized burst (the ``(buf, lens)`` shape :func:`spead_packetize`
    produces) to ``addr:port`` with one syscall per 64 datagrams.  UDP
    semantics: a full socket buffer drops packets (counted in
    ``stats()["dropped"]``) rather than blocking the real-time path."""

    def __init__(self, addr: str, port: int,
                 sndbuf_bytes: int = 8 * 1024 * 1024):
        self._lib = load_library()
        self._h = ctypes.c_void_p(self._lib.udp_tx_create(
            addr.encode(), port, sndbuf_bytes))
        if not self._h:
            raise OSError(f"udp_tx_create failed for {addr}:{port}")

    def __call__(self, buf, lens) -> int:
        lens = np.ascontiguousarray(lens, np.uint64)
        return self._lib.udp_tx_send_burst(
            self._h, bytes(buf) if not isinstance(buf, bytes) else buf,
            lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(lens))

    def stats(self):
        vals = [ctypes.c_uint64() for _ in range(3)]
        self._lib.udp_tx_stats(self._h, *map(ctypes.byref, vals))
        return {"datagrams": vals[0].value, "bytes": vals[1].value,
                "dropped": vals[2].value}

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.udp_tx_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
