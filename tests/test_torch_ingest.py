"""The port's native ingest (``dc_sand_tpu_torch/csrc/ingest.cpp`` and
``runtime/ingest.py``) against the JAX package's on the same packet
sequences, its feed of the runner, and the ported ingest benches and
examples, on the CPU.  Card-only checks (pinned slots, the copy stream):
``tests/test_torch_ingest_cuda.py``."""

import os
import re
import socket
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch

import dc_sand_tpu.runtime.ingest as jax_ingest
from dc_sand_tpu.config import ChainConfig as JaxChainConfig
from dc_sand_tpu.runtime import DelayModel as JaxDelayModel
from dc_sand_tpu.runtime import FXRunner as JaxRunner
from dc_sand_tpu.windows import pfb_window
from dc_sand_tpu_torch import _build
from dc_sand_tpu_torch.bench import ingest_bench
from dc_sand_tpu_torch.config import ChainConfig, get_config
from dc_sand_tpu_torch.bench.fixtures import ingest_setup
from dc_sand_tpu_torch.runtime import DelayModel, FXRunner
from dc_sand_tpu_torch.runtime import ingest as port_ingest
from dc_sand_tpu_torch.runtime.ingest import (Feeder, NativeIngest,
                                              multi_ingest_source)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_library_builds_into_build_from_the_ports_copy():
    """g++ builds the port's own copy into build/torch_ingest/, keyed by a
    hash; the port neither reads nor builds the JAX package's csrc/ (whose
    loader makes csrc/libingest.so in place); the copy keeps every C entry
    point of the original and adds the two slot accessors."""
    so = _build.ingest_library()
    assert so.exists() and so.parent == (
        _build.build_dir().parent / "torch_ingest")
    assert re.fullmatch(r"libingest_[0-9a-f]{16}\.so", so.name)
    assert str(so.parent).startswith(os.path.join(REPO, "build"))
    port_src = os.path.join(REPO, "dc_sand_tpu_torch")
    for root, _dirs, files in os.walk(port_src):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(root, f)).read()
                assert "libingest.so" not in text, f
                assert '"make"' not in text, f

    def entry_points(path):
        return set(re.findall(r"^(?:[\w*]+\s+)+\**(\w+)\(",
                              open(path).read(), re.M))

    orig = entry_points(os.path.join(REPO, "csrc", "ingest.cpp"))
    copy = entry_points(os.path.join(port_src, "csrc", "ingest.cpp"))
    assert orig <= copy
    assert {"ingest_n_slots", "ingest_slot_buffer"} <= copy - orig


def test_slots_are_page_aligned_whole_pages():
    ing = NativeIngest(3, 2, 1000, n_slots=3)
    slots = ing._slots()
    assert ing.n_slots == 3 and len(slots) == 3 and not ing.pinned
    for ptr, nbytes in slots:
        assert ptr % 4096 == 0 and nbytes == 8192
    view, _ = ing.retire_view(force=True)
    assert view.ctypes.data == slots[0][0]
    ing.release()
    ing.close()
    ing.close()                         # a second close does nothing


# ---------------------------------------------------------------------------
# (b) the same packet sequences through the JAX wrapper and the port's: every
# chunk, fill, return code, error and stats() equal
# ---------------------------------------------------------------------------

def _spead_packet(items: dict, payload: bytes) -> bytes:
    out = bytearray([0x53, 0x04, 0x08, 0x06, 0x00, 0x00])
    out += len(items).to_bytes(2, "big")
    for item_id, val in items.items():
        out += ((1 << 63) | (item_id << 48)
                | (val & ((1 << 48) - 1))).to_bytes(8, "big")
    return bytes(out + payload)


def _pack_10bit(s10) -> bytes:
    out = bytearray()
    for g in range(len(s10) // 4):
        bits = 0
        for i in range(4):
            bits = (bits << 10) | (int(s10[g * 4 + i]) & 0x3FF)
        out += bits.to_bytes(5, "big")
    return bytes(out)


class _Rec(list):
    """A scenario's trace: results, arrays as bytes, errors as type and
    message."""

    def call(self, fn, *args, **kw):
        try:
            out = fn(*args, **kw)
        except (ValueError, RuntimeError, OSError) as exc:
            self.append(("raised", type(exc).__name__, str(exc)))
            return None
        self.add(out)
        return out

    def add(self, out):
        if isinstance(out, tuple):
            for x in out:
                self.add(x)
        elif isinstance(out, np.ndarray):
            self.append((out.dtype.str, out.shape, out.tobytes()))
        else:
            self.append(out)


def _sc_in_order(m, r):
    ing = m.NativeIngest(2, 2, 64)
    ref = np.random.default_rng(1).integers(-100, 100, (2, 2, 64), np.int8)
    for i in range(2):
        for j in range(2):
            r.call(ing.submit, i, j, 0, ref[i, j].tobytes())
    r.call(ing.retire)
    r.add(ing.stats())


def _sc_out_of_order_dup_gap(m, r):
    ing = m.NativeIngest(1, 1, 64)
    ref = np.arange(-32, 32, dtype=np.int8)
    r.call(ing.submit, 0, 0, 32, ref[32:].tobytes())
    r.call(ing.retire)                          # incomplete: None
    r.call(ing.submit, 0, 0, 0, ref[:48].tobytes())
    r.call(ing.submit, 0, 0, 16, ref[16:48].tobytes())   # duplicate
    r.call(ing.tail_complete)
    r.call(ing.retire)
    r.call(ing.retire)                          # a gap: nothing there
    r.call(ing.retire, force=True)              # lost chunk: zeros
    r.add(ing.stats())


def _sc_straddle_late_future(m, r):
    ing = m.NativeIngest(1, 1, 32, n_slots=2)
    r.call(ing.submit, 0, 0, 16, np.arange(48, dtype=np.int8).tobytes())
    r.call(ing.retire, force=True)
    r.call(ing.submit, 0, 0, 0, bytes(32))      # behind the window
    r.call(ing.submit, 0, 0, 32 * 10, bytes(32))  # too far ahead
    r.call(ing.retire, force=True)
    r.add(ing.stats())


def _sc_slot_reuse(m, r):
    ing = m.NativeIngest(1, 1, 64, n_slots=2)
    full = np.full((64,), 55, np.int8).tobytes()
    r.call(ing.submit, 0, 0, 0, full)
    r.call(ing.retire)
    r.call(ing.submit, 0, 0, 64, full)
    r.call(ing.retire)
    r.call(ing.submit, 0, 0, 2 * 64 + 16, np.full((16,), 77, np.int8)
           .tobytes())
    r.call(ing.retire, force=True)


def _sc_borrowed_wrap(m, r):
    ing = m.NativeIngest(1, 1, 16, n_slots=2)
    r.call(ing.submit, 0, 0, 0, np.full((16,), 9, np.int8).tobytes())
    view, fill = ing.retire_view()
    r.add((view.copy(), fill))
    r.call(ing.retire_view, force=True)         # a second view refused
    r.call(ing.submit, 0, 0, 2 * 16, np.full((16,), 1, np.int8).tobytes())
    r.call(ing.submit, 0, 0, 16 + 8, np.full((16,), 5, np.int8).tobytes())
    r.add(view.copy())                          # intact
    r.call(ing.tail_complete)
    r.call(ing.retire)                          # tail is chunk 1: no -5
    ing.release()
    r.call(ing.retire, force=True)
    r.add(ing.stats())


def _sc_retire_lent_slot(m, r):
    ing = m.NativeIngest(1, 1, 16, n_slots=1)
    r.call(ing.submit, 0, 0, 0, bytes(16))
    r.call(ing.retire_view)
    r.call(ing.retire, force=True)              # the tail's slot is lent
    ing.release()
    r.call(ing.retire, force=True)


def _sc_window_edges(m, r):
    ing = m.NativeIngest(1, 1, 100, n_slots=4)
    r.call(ing.submit, 0, 0, 350, np.full((100,), 1, np.int8).tobytes())
    r.call(ing.retire, force=True)
    r.call(ing.submit, 0, 0, 50, np.full((100,), 2, np.int8).tobytes())
    r.call(ing.retire, force=True)
    r.add(ing.stats())


def _sc_tail_complete_borrow(m, r):
    ing = m.NativeIngest(1, 1, 16, n_slots=4)
    r.call(ing.submit, 0, 0, 0, np.full((16,), 1, np.int8).tobytes())
    r.call(ing.retire_view)
    r.call(ing.tail_complete)
    r.call(ing.submit, 0, 0, 16, np.full((16,), 2, np.int8).tobytes())
    r.call(ing.tail_complete)
    ing.release()


def _sc_10bit(m, r):
    s10 = np.random.default_rng(2).integers(-512, 512, size=64)
    ing = m.NativeIngest(1, 1, 64)
    r.call(ing.submit, 0, 0, 0, _pack_10bit(s10),
           fmt=m.NativeIngest.FORMAT_10BIT)
    r.call(ing.retire)
    r.call(ing.submit, 0, 0, 64, b"\x01" * 7,
           fmt=m.NativeIngest.FORMAT_10BIT)     # ragged tail
    r.call(m.unpack_10bit, _pack_10bit(s10), 64)
    r.call(m.unpack_10bit, _pack_10bit([511, -512, 0, -1]), 4)
    r.add(ing.stats())


def _sc_spead(m, r):
    a, p, c = 2, 2, 64
    ref = np.random.default_rng(9).integers(-100, 100, (a, p, c), np.int8)
    ing = m.NativeIngest(a, p, c)
    for ai in range(a):
        for pi in range(p):
            pay = ref[ai, pi].tobytes()
            for off, part in ((0, pay[:40]), (40, pay[40:])):
                r.call(ing.submit_spead, _spead_packet(
                    {0x1600: 0, 0x3101: ai * p + pi, 0x03: off}, part))
    r.call(ing.retire)
    good = _spead_packet({0x1600: 64, 0x3101: 0, 0x03: 0}, bytes(64))
    r.call(ing.submit_spead_burst, [good, b"\x00" + good[1:],
                                    _spead_packet({0x1600: 64}, bytes(64))])
    for stream in (a * p, p * ((1 << 32) + 3)):
        r.call(ing.submit_spead, _spead_packet(
            {0x1600: 64, 0x3101: stream, 0x03: 0}, bytes(64)))
    r.call(ing.retire, force=True)
    r.add(ing.stats())


def _sc_spead_10bit_align(m, r):
    s10 = np.random.default_rng(4).integers(-512, 512, size=64)
    packed = _pack_10bit(s10)
    ing = m.NativeIngest(1, 1, 64)
    fmt = m.NativeIngest.FORMAT_10BIT
    r.call(ing.submit_spead, _spead_packet({0x1600: 0, 0x3101: 0, 0x03: 8},
                                           packed[8:]), fmt=fmt)
    r.call(ing.submit_spead, _spead_packet({0x1600: 0, 0x3101: 0, 0x03: 0},
                                           packed[:12]), fmt=fmt)
    pair = m.spead_packetize(packed, 0, 0, max_payload=12, align=5)
    r.add(pair)
    r.call(ing.submit_spead_burst, pair, fmt=fmt)
    r.call(ing.retire)
    r.call(m.spead_packetize, packed, 0, 0, max_payload=3, align=5)


def _sc_delay(m, r):
    ing = m.NativeIngest(2, 1, 64, n_slots=4)
    for ai, d in enumerate((3, 8)):
        r.call(ing.set_delay, ai, 0, d, 8)
    raw = np.random.default_rng(60).integers(-100, 100, (2, 128), np.int8)
    for ai in range(2):
        r.call(ing.submit, ai, 0, 0, raw[ai].tobytes())
    r.call(ing.retire, force=True)
    r.call(ing.retire, force=True)
    r.call(ing.set_delay, 0, 0, 40, 16)         # beyond max_delay
    r.call(ing.set_delay, 5, 0, 1, 16)          # no such antenna
    r.call(ing.set_delay, 0, 0, -1, 16)


def _sc_geometry(m, r):
    for bad in ((4, 2, 0), (0, 2, 64), (4, 0, 64)):
        r.call(m.NativeIngest, *bad)
    r.call(m.NativeIngest, 4, 2, 64, n_slots=0)


def _sc_packetize(m, r):
    pay = bytes(range(250))
    r.add(m.spead_packetize(pay, timestamp=12345, stream=7, heap_id=99,
                            max_payload=100))
    x = np.arange(300, dtype=np.int8)
    r.add(m.spead_packetize(x, 3, 1, max_payload=128))
    r.call(m.spead_packetize, b"", 0, 0)


def _sc_loopback(m, r):
    a, p, c = 2, 2, 300
    rng = np.random.default_rng(17)
    ref = rng.integers(-128, 128, (a, p, c), dtype=np.int8)
    frags = []
    for ai in range(a):
        for pi in range(p):
            buf, lens = m.spead_packetize(ref[ai, pi], timestamp=0,
                                          stream=ai * p + pi,
                                          heap_id=ai * p + pi,
                                          max_payload=128)
            off = 0
            for ln in lens:
                frags.append(buf[off:off + int(ln)])
                off += int(ln)
    rng.shuffle(frags)
    ing = m.NativeIngest(a, p, c)
    r.call(ing.submit_spead_burst, frags)
    r.call(ing.retire)
    # a 2-tuple of datagram bytes is a burst of two, not (blob, lens)
    buf, lens = m.spead_packetize(ref[0, 0, :64], 0, 0, max_payload=32)
    ing2 = m.NativeIngest(1, 1, 64)
    r.call(ing2.submit_spead_burst, (buf[:int(lens[0])],
                                     buf[int(lens[0]):]))
    r.call(ing2.retire)


def _sc_transmit_dump(m, r):
    vis = np.random.default_rng(3).integers(-2**31, 2**31, (6, 2, 2, 32, 2),
                                            dtype=np.int32)
    dump = types.SimpleNamespace(vis=vis, first_chunk=4)
    rx = m.NativeIngest(1, 1, vis.nbytes, n_slots=6)
    sent = []

    def sink(buf, lens):
        sent.append((buf, lens))
        return rx.submit_spead_burst((buf, lens))

    tx = m.SpeadTransmitter(sink, max_payload=4096, ticks_per_chunk=vis.nbytes)
    r.call(tx.send_dump, dump)
    r.add(tx.heaps_sent)
    for b, lens in sent:
        r.add((np.frombuffer(b, np.uint8), lens))
    for _ in range(5):
        r.call(rx.retire, force=True)


def _wait(cond, timeout=5.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout and not cond():
        time.sleep(0.01)
    return cond()


def _sc_udp(m, r):
    a, p, c = 2, 2, 4096
    ref = np.random.default_rng(23).integers(-128, 128, (a, p, c), np.int8)
    ing = m.NativeIngest(a, p, c)
    with m.UdpSpeadReceiver(ing, bind_addr="127.0.0.1") as rx:
        with m.UdpSpeadSink("127.0.0.1", rx.port) as sink:
            tx = m.SpeadTransmitter(sink, max_payload=1024)
            n = sum(tx.send(ref[ai, pi], timestamp=0, stream=ai * p + pi)
                    for ai in range(a) for pi in range(p))
            r.add(n)
            r.add(_wait(lambda: rx.stats()["placed"] >= n))
            r.add(sink.stats())
            r.add(rx.stats())
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.sendto(b"not spead at all", ("127.0.0.1", rx.port))
        s.close()
        r.add(_wait(lambda: rx.stats()["rejected"] >= 1))
    r.call(ing.retire)
    r.add(ing.stats())
    r.call(m.UdpSpeadReceiver, ing, bind_addr="not-an-address")
    r.call(m.UdpSpeadSink, "999.999.0.1", 1)


SCENARIOS = [_sc_in_order, _sc_out_of_order_dup_gap, _sc_straddle_late_future,
             _sc_slot_reuse, _sc_borrowed_wrap, _sc_retire_lent_slot,
             _sc_window_edges, _sc_tail_complete_borrow, _sc_10bit, _sc_spead,
             _sc_spead_10bit_align, _sc_delay, _sc_geometry, _sc_packetize,
             _sc_loopback, _sc_transmit_dump, _sc_udp]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[f.__name__[4:] for f in SCENARIOS])
def test_same_results_as_the_jax_wrapper(scenario):
    got = {}
    for name, mod in (("jax", jax_ingest), ("port", port_ingest)):
        rec = _Rec()
        scenario(mod, rec)
        got[name] = rec
    assert len(got["port"]) > 2
    assert got["port"] == got["jax"]


def test_spead_hypothesis_fuzz_same_as_jax():
    """Any payload size, split, arrival order, duplicates and format
    reassemble bit-exact in both, with the same counters."""
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=25, deadline=None)
    @given(st.data())
    def check(data):
        fmt = data.draw(st.sampled_from([0, 1]))
        c = 4 * data.draw(st.integers(2, 32))
        a, p = data.draw(st.integers(1, 3)), data.draw(st.integers(1, 2))
        rng = np.random.default_rng(data.draw(st.integers(0, 2 ** 16)))
        s10 = rng.integers(-512, 512, (a, p, c))
        mp = (5 if fmt else 1) * data.draw(st.integers(1, 8))
        grams = []
        for ai in range(a):
            for pi in range(p):
                pay = (_pack_10bit(s10[ai, pi]) if fmt
                       else (s10[ai, pi] >> 2).astype(np.int8).tobytes())
                buf, lens = port_ingest.spead_packetize(
                    pay, 0, ai * p + pi, max_payload=mp,
                    align=5 if fmt else 1)
                assert (buf, lens.tobytes()) == tuple(
                    x if isinstance(x, bytes) else x.tobytes()
                    for x in jax_ingest.spead_packetize(
                        pay, 0, ai * p + pi, max_payload=mp,
                        align=5 if fmt else 1))
                off = 0
                for ln in lens:
                    grams.append(buf[off:off + int(ln)])
                    off += int(ln)
        rng.shuffle(grams)
        grams += grams[:len(grams) // 3]
        outs = []
        for mod in (jax_ingest, port_ingest):
            ing = mod.NativeIngest(a, p, c)
            placed = [ing.submit_spead(g, fmt=fmt) for g in grams]
            chunk, fill = ing.retire()
            outs.append((placed, chunk.tobytes(), fill, ing.stats()))
        assert outs[0] == outs[1]
        assert outs[1][2] == 1.0
        assert outs[1][1] == (s10 >> 2).astype(np.int8).tobytes()

    check()


def test_submit_spead_burst_takes_a_bytearray_blob_rewritten_in_place():
    """The (blob, lens) pair may carry a bytearray: retime() moves a
    burst along the stream in place, as the chip smoke's feed replays one
    chunk."""
    x = np.random.default_rng(5).integers(-100, 100, (2, 2, 256), np.int8)
    (blob, lens), = ingest_bench.spead_bursts(x, 1)
    ing = NativeIngest(2, 2, 256)
    for i in range(3):
        ingest_bench.retime(blob, lens, i * 256)
        assert ing.submit_spead_burst((blob, lens)) == len(lens)
        chunk, fill = ing.retire()
        assert fill == 1.0 and np.array_equal(chunk, x)
    with pytest.raises(ValueError, match="spead_packetize"):
        ingest_bench.retime(bytearray(len(blob)), lens, 0)


# ---------------------------------------------------------------------------
# (c) multi_ingest_source and the overlapped feed
# ---------------------------------------------------------------------------

def _fed_workers(mod, n_workers, aw, c, data, n_chunks, **kw):
    ings = [mod.NativeIngest(aw, 1, c, **kw) for _ in range(n_workers)]
    for w, ing in enumerate(ings):
        for ai in range(aw):
            for i in range(n_chunks):
                ing.submit(ai, 0, i * c, data[w * aw + ai, 0,
                                              i * c:(i + 1) * c].tobytes())
    return ings


def test_multi_ingest_source_equals_jax():
    """Three assemblers of two antennas: the port's chunks equal
    ``np.asarray`` of the JAX's, as (A, P, C) and, with a config, as the
    F-engine's frames; no slot stays lent out."""
    c, n = 64, 3
    data = np.random.default_rng(8).integers(-100, 100, (6, 1, n * c),
                                             np.int8)
    cfg = ChainConfig(name="t", n_ants=6, n_pols=1, n_chans=16,
                      n_taps=4, spectra_per_chunk=2, n_spectra_per_acc=4,
                      run_xengine=True, apply_requant=True)
    jsrc = jax_ingest.multi_ingest_source(
        _fed_workers(jax_ingest, 3, 2, c, data, n))
    pings = _fed_workers(port_ingest, 3, 2, c, data, n)
    psrc = multi_ingest_source(pings, device="cpu")
    fsrc = multi_ingest_source(_fed_workers(port_ingest, 3, 2, c, data, n),
                               cfg, device="cpu")
    for i in range(n):
        want = np.asarray(jsrc(i))
        got = psrc(i)
        assert got.dtype == torch.int8 and got.shape == (6, 1, c)
        np.testing.assert_array_equal(got.numpy(), want)
        frames = fsrc(i)
        assert frames.shape == (6, 2, 32)
        np.testing.assert_array_equal(frames.numpy(), want.reshape(6, 2, 32))
    for ing in pings:
        ing.retire_view(force=True)             # nothing lent out
        ing.release()
    with pytest.raises(ValueError, match="config"):
        multi_ingest_source(pings, cfg.replace(n_ants=4), device="cpu")


def test_incomplete_tail_force_false_raises_like_jax_and_lends_nothing():
    c = 32
    full = np.full((c,), 7, np.int8).tobytes()
    errors, outs = [], []
    for mod, kw in ((jax_ingest, {}), (port_ingest, {"device": "cpu"})):
        ings = [mod.NativeIngest(1, 1, c) for _ in range(2)]
        ings[0].submit(0, 0, 0, full)
        ings[1].submit(0, 0, 0, full[:c // 2])
        src = mod.multi_ingest_source(ings, force=False, **kw)
        with pytest.raises(RuntimeError, match="incomplete") as err:
            src(0)
        errors.append(str(err.value))
        ings[1].submit(0, 0, c // 2, full[c // 2:])
        outs.append(np.asarray(src(0)))
        for ing in ings:
            assert ing.tail_complete() is False
            assert ing.retire_view(force=True)[0] is not None
            ing.release()
    assert errors[0] == errors[1]
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[1], 7)


@pytest.mark.parametrize("n_workers", [1, 2])
def test_feeder_overlapped_equals_direct_with_delays(n_workers):
    """The feed of spead_feed (assemblers fed each by its thread, the
    Feeder ahead of the consumer) gives the chunks of the stream with the
    coarse delays placed, the first chunk's head zero-filled; a stream's
    heap spans two datagrams."""
    x = np.random.default_rng(3).integers(-100, 100, (4, 2, 12288),
                                          np.int8)
    c = x.shape[-1]
    delays = np.random.default_rng(4).integers(0, 9, (4, 2))
    feeder, ings, submit_ms = ingest_bench.spead_feed(
        x, 5, n_workers=n_workers, delays=delays, max_delay=8,
        device="cpu")
    with feeder:
        got = [feeder(i).clone() for i in range(5)]
        with pytest.raises(RuntimeError, match="holds 5 chunks"):
            feeder(5)
    stream = np.concatenate([np.zeros((4, 2, 8), np.int8), np.tile(x, 6)],
                            -1)
    for i, chunk in enumerate(got):
        want = np.stack([[stream[a, p, 8 - delays[a, p] + i * c:
                                 8 - delays[a, p] + (i + 1) * c]
                          for p in range(2)] for a in range(4)])
        np.testing.assert_array_equal(chunk.numpy(), want)
    assert len(submit_ms) == 5 * n_workers
    assert all(st == {"packets_ok": 5 * 16 // n_workers, "packets_late": 0,
                      "packets_bad": 0, "packets_clipped": 0}
               for st in (ing.stats() for ing in ings))


def test_feeder_hands_a_failure_to_the_consumer_and_refuses_bad_rings():
    ings = [NativeIngest(1, 1, 32, n_slots=3)]

    def fails(i):
        raise ValueError(f"no packets for chunk {i}")

    feeder = Feeder(multi_ingest_source(ings, device="cpu"), 3, [fails],
                    timeout=10)
    with pytest.raises(RuntimeError, match="feeder thread failed") as err:
        feeder(0)
    assert isinstance(err.value.__cause__, ValueError)
    feeder.close()
    with pytest.raises(ValueError, match="n_slots >= 3"):
        Feeder(multi_ingest_source([NativeIngest(1, 1, 32, n_slots=2)],
                                   device="cpu"), 3, [fails])
    with pytest.raises(ValueError, match="depth >= 2"):
        Feeder(multi_ingest_source(ings, device="cpu", depth=1), 3)
    # a producer with nothing to place stalls: the consumer's get times out
    silent = Feeder(multi_ingest_source(ings, force=False, device="cpu"), 3,
                    timeout=0.5)
    with pytest.raises(RuntimeError, match="feeder thread failed"):
        silent(0)
    silent.close()


# ---------------------------------------------------------------------------
# (d) the runner fed through the ingest
# ---------------------------------------------------------------------------

def _cfg(cls):
    return cls(name="t", n_ants=4, n_pols=2, n_chans=32, n_taps=4,
               spectra_per_chunk=4, n_spectra_per_acc=8, run_xengine=True,
               apply_delay=True, apply_requant=True)


def test_runner_through_the_ingest_equals_coarse_path_and_jax():
    """Coarse delays placed by the assemblers (the runner's model zero)
    give the dumps of the port's runner-side coarse shift bitwise, and of
    the JAX runner (jnp) fed through the JAX multi_ingest_source."""
    cfg, jcfg = _cfg(ChainConfig), _cfg(JaxChainConfig)
    a, p, c, md, n = 4, 2, cfg.chunk_samples, 8, 4
    raw = np.random.default_rng(61).integers(-100, 100, (a, p, n * c),
                                             np.int8)
    delays = np.random.default_rng(62).integers(0, md + 1, (a, p))
    p1 = np.random.default_rng(63).uniform(-1e-3, 1e-3, (a, p))
    w = pfb_window(cfg.n_taps, cfg.fft_size)

    def assemblers(mod):
        ings = [mod.NativeIngest(2, p, c) for _ in range(2)]
        for wk, ing in enumerate(ings):
            for ai in range(2):
                for pi in range(p):
                    ing.set_delay(ai, pi, int(delays[2 * wk + ai, pi]), md)
        return ings

    def fed(mod, src_kw):
        ings = assemblers(mod)
        src = mod.multi_ingest_source(ings, **src_kw)

        def source(i):
            for wk, ing in enumerate(ings):
                for ai in range(2):
                    for pi in range(p):
                        ing.submit(ai, pi, i * c, raw[2 * wk + ai, pi,
                                                      i * c:(i + 1) * c]
                                   .tobytes())
            return src(i)
        return source

    dm = DelayModel.zeros(a, p, max_delay=md)
    dm.d0, dm.p1 = delays.astype(float), p1.copy()
    coarse, _ = FXRunner(cfg, w, delay_model=dm, device="cpu").run(
        lambda i: raw[..., i * c:(i + 1) * c], n)
    zdm = DelayModel.zeros(a, p)
    zdm.p1 = p1.copy()
    port, _ = FXRunner(cfg, w, delay_model=zdm, device="cpu").run(
        fed(port_ingest, {"cfg": cfg, "device": "cpu"}), n)
    jdm = JaxDelayModel.zeros(a, p)
    jdm.p1 = p1.copy()
    jax_dumps, _ = JaxRunner(jcfg, w, delay_model=jdm, impl="jnp").run(
        fed(jax_ingest, {}), n)
    assert len(port) == len(coarse) == len(jax_dumps) == 2
    for x, y, z in zip(port, coarse, jax_dumps):
        np.testing.assert_array_equal(x.vis, y.vis)
        np.testing.assert_array_equal(x.vis, z.vis)


def test_zero_delay_runner_takes_the_ingest_buffer_with_no_copy():
    """With a zero delay model the runner keeps no coarse tail and hands
    the source's buffer to the step as it is: no per-stream shift copy."""
    cfg = _cfg(ChainConfig)
    c = cfg.chunk_samples
    x = np.random.default_rng(1).integers(-100, 100, (4, 2, c), np.int8)
    feeder, ings, _ = ingest_bench.spead_feed(x, 2, n_workers=2, cfg=cfg,
                                              device="cpu")
    runner = FXRunner(cfg, pfb_window(4, 64), device="cpu")
    assert runner._tail is None
    buffers = {b.data_ptr() for b in feeder.source._bufs}
    seen = []
    step = runner._step

    def spy(history, acc, chunk, *rest):
        seen.append(chunk[0].data_ptr())
        return step(history, acc, chunk, *rest)

    def no_shift(*_a, **_k):
        raise AssertionError("coarse shift on a zero-delay runner")

    runner._step, runner._coarse_shift = spy, no_shift
    with feeder:
        runner.run(feeder, 2)
    assert len(seen) == 2 and set(seen) <= buffers


def test_phase24_rehearsal_on_the_cpu():
    """The chip smoke's phase 24 at a small width: the seeded chunk
    replayed through 4 assemblers with delays placed, against the runner
    fed the same samples with the delays as its d0: equal dumps bitwise
    and no lost packet."""
    cfg = get_config("fx64").replace(n_ants=8, n_chans=32,
                                     spectra_per_chunk=4,
                                     n_spectra_per_acc=16)
    g = cfg.n_spectra_per_acc // cfg.spectra_per_chunk
    gen = torch.Generator()
    gen.manual_seed(24)
    chunk, host, delays, runner_dm, reference_dm = ingest_setup(cfg, gen,
                                                                "cpu")
    assert np.array_equal(host, chunk.numpy()) and delays.max() <= 32
    w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    feeder, ings, _ = ingest_bench.spead_feed(
        host, 2 * g, n_workers=4, delays=delays, max_delay=32, cfg=cfg,
        device="cpu")
    with feeder:
        got, _ = FXRunner(cfg, w, delay_model=runner_dm,
                          device="cpu").run(feeder, 2 * g)
    want, _ = FXRunner(cfg, w, delay_model=reference_dm,
                       device="cpu").run(lambda i: chunk, 2 * g)
    assert len(got) == 2
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.vis, y.vis)
    for ing in ings:
        st = ing.stats()
        assert st["packets_late"] == st["packets_bad"] == 0
        assert st["packets_clipped"] == 0
        ing.close()


# ---------------------------------------------------------------------------
# (e) the ported benches, (f) the ported examples
# ---------------------------------------------------------------------------

# the JAX records' extra keys, with vs_realtime_floor (a TPU chip's share)
# as vs_array_realtime and the TPU dev box's transport notes left out
_HOST_KEYS = {"n_ants", "n_chans", "spectra", "packet_samples",
              "delay_in_ingest", "n_workers", "n_chunks",
              "vs_array_realtime", "stats"}
_E2E_KEYS = {"n_ants", "n_chans", "spectra", "n_chunks", "impl",
             "frames_io", "packet_samples", "feed", "vs_array_realtime",
             "dumps_verified", "dump_snrs_db", "dumps"}


@pytest.mark.parametrize("kw,name", [
    (dict(n_workers=2, zero_copy=True), "ingest_host_placed_view_2w"),
    (dict(zero_copy=True), "ingest_host_placed_view"),
    (dict(), "ingest_host_placed"),
    (dict(delay_in_ingest=False), "ingest_host_gather")])
def test_bench_ingest_host(kw, name):
    r = ingest_bench.bench_ingest_host(n_ants=4, n_chans=32, spectra=8,
                                       packet_samples=128, device="cpu",
                                       **kw)
    assert r.name == name and r.unit == "samp/s" and r.value > 0
    assert _HOST_KEYS <= set(r.extra) and r.extra["platform"] == "cpu"
    assert r.bytes_moved == 4 * 2 * 512 * 8
    assert r.extra["stats"]["packets_ok"] == 12 * 4 * 2 * 4


@pytest.mark.parametrize("n_workers", [1, 2])
def test_bench_ingest_udp(n_workers):
    r = ingest_bench.bench_ingest_udp(n_ants=2, n_chans=64, spectra=4,
                                      n_chunks=2, n_workers=n_workers,
                                      device="cpu")
    assert r.name == ("ingest_udp" if n_workers == 1 else "ingest_udp_2w")
    assert {"n_ants", "n_chans", "spectra", "max_payload", "n_workers",
            "n_chunks", "vs_array_realtime", "stats"} <= set(r.extra)
    assert r.extra["stats"]["rx"]["rejected"] == 0


def test_bench_ingest_runner_and_packet_tiling():
    r = ingest_bench.bench_ingest_runner(n_ants=2, n_chans=32, spectra=4,
                                         n_chunks=4, packet_samples=64,
                                         device="cpu")
    assert r.name == "ingest_runner_e2e" and r.value > 0
    assert {"n_ants", "n_chans", "spectra", "n_chunks",
            "vs_array_realtime"} <= set(r.extra)
    with pytest.raises(ValueError, match="tile"):
        ingest_bench.bench_ingest_runner(n_ants=2, n_chans=32, spectra=4,
                                         packet_samples=100, device="cpu")


@pytest.mark.parametrize("feed", ["host", "device_replay"])
def test_bench_e2e_atrate_verifies_its_dumps(feed):
    r = ingest_bench.bench_e2e_atrate(n_ants=2, n_chans=32, spectra=8,
                                      n_chunks=4, packet_samples=64,
                                      feed=feed, device="cpu")
    assert r.name == {"host": "e2e_atrate",
                      "device_replay": "e2e_atrate_replay"}[feed]
    assert _E2E_KEYS <= set(r.extra)
    assert r.extra["dumps_verified"] is True and r.extra["dumps"] == 2
    assert all(s > 50 for s in r.extra["dump_snrs_db"])
    if feed == "host":
        assert r.extra["ingest_stats"]["packets_late"] == 0
    with pytest.raises(ValueError, match="feed"):
        ingest_bench.bench_e2e_atrate(feed="nope", device="cpu")


def test_golden_product_is_golden_xcorr():
    """The e2e bench's float64 CMAC by products equals golden.xcorr."""
    from dc_sand_tpu_torch import golden
    cfg = get_config("fx64").replace(n_ants=3, n_chans=32,
                                     spectra_per_chunk=4, n_spectra_per_acc=8)
    data = np.random.default_rng(0).integers(-100, 100, (3, 2, 40 * 64),
                                             np.int8)
    w = pfb_window(cfg.n_taps, cfg.fft_size, cfg.window)
    seg = data[..., 16 * 64 - 15 * 64:16 * 64 + 8 * 64]
    ref = golden.xcorr(golden.f_engine(seg, w, 16, 32,
                                       gains=np.full(32, 0.05) + 0j))
    dump = types.SimpleNamespace(vis=np.stack([ref.real, ref.imag], -1))
    assert ingest_bench._golden_dump_snrs(data, w, cfg, 0.05, 16 * 64,
                                          [dump]) == [float("inf")]


@pytest.mark.parametrize("example", ["spead_loopback", "udp_observation"])
def test_ported_example_passes_on_the_cpu(example):
    res = subprocess.run(
        [sys.executable, "-m", f"dc_sand_tpu_torch.examples.{example}",
         "--cpu"], capture_output=True, text=True, timeout=300, cwd=REPO)
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.strip().splitlines()[-1] == "PASS"


@pytest.mark.parametrize("argv,names", [
    (["ingest"], ["ingest_host_placed_view_4w", "ingest_host_placed_view",
                  "ingest_host_placed", "ingest_host_gather", "ingest_udp",
                  "ingest_udp_4w", "ingest_runner_e2e"]),
    (["e2e", "--scale", "64", "--spectra", "128"],
     ["e2e_atrate", "e2e_atrate_replay"])])
def test_bench_entry_runs_the_ingest_targets(argv, names, capsys):
    """The bench entry's ``ingest`` and ``e2e`` targets run the JAX CLI's
    record lists (e2e at --scale/--spectra), one JSON record a line."""
    import json
    from dc_sand_tpu_torch.bench.__main__ import main as bench_main
    assert bench_main(argv + ["--device", "cpu"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["name"] for r in recs] == names
    for r in recs:
        assert r["extra"]["platform"] == "cpu" and r["value"] > 0
        if r["name"].startswith("e2e"):
            assert r["extra"]["dumps_verified"] is True
