#!/usr/bin/env python
"""End-to-end observation over a real UDP socket (the wire leg).

``spead_loopback`` runs the SPEAD framing in process; this example puts
the same signal chain on a kernel socket pair, scaled to localhost:

  digitiser streams -> SpeadTransmitter -> UdpSpeadSink (sendmmsg)
      -> 127.0.0.1 UDP -> UdpSpeadReceiver (recvmmsg thread)
      -> NativeIngest (pinned slots on the card) -> multi_ingest_source
      -> FXRunner -> visibility dumps, equal to the runner fed the same
         chunks from the device
      -> SpeadTransmitter -> second UDP hop -> downstream consumer

The loss counters are live at every hop; the delivered dump is verified
bit-exact.  Runs on the card, or on the CPU with ``--cpu``::

    python -m dc_sand_tpu_torch.examples.udp_observation [--cpu]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def _drain(rx, want, timeout=5.0):
    t0 = time.monotonic()
    while rx.stats()["placed"] < want and time.monotonic() - t0 < timeout:
        time.sleep(0.005)
    return rx.stats()


def main(argv=None) -> int:
    import torch
    from dc_sand_tpu_torch.config import get_config
    from dc_sand_tpu_torch.ops._dispatch import default_device
    from dc_sand_tpu_torch.runtime import (FXRunner, NativeIngest,
                                           SpeadTransmitter,
                                           multi_ingest_source)
    from dc_sand_tpu_torch.runtime.ingest import (UdpSpeadReceiver,
                                                  UdpSpeadSink)
    from dc_sand_tpu_torch.windows import pfb_window

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = default_device("cpu" if args.cpu else None)

    # 16-spectra chunks (the JAX example: 8): the CMAC kernel takes
    # spectra in multiples of 16
    cfg = get_config("fx4").replace(n_chans=128, spectra_per_chunk=16,
                                    n_spectra_per_acc=32,
                                    apply_delay=False)
    a, p, c = cfg.n_ants, cfg.n_pols, cfg.chunk_samples
    n_chunks = 2
    rng = np.random.default_rng(11)
    x = rng.integers(-100, 100, (a, p, n_chunks * c), dtype=np.int8)

    # --- the antenna->correlator hop: a real socket pair --------------
    ing = NativeIngest(a, p, c, pinned=dev.type == "cuda")
    rx = UdpSpeadReceiver(ing, bind_addr="127.0.0.1")
    sink = UdpSpeadSink("127.0.0.1", rx.port)
    dig = SpeadTransmitter(sink, max_payload=2048)
    # force=False: a chunk the socket did not deliver whole raises
    src = multi_ingest_source([ing], cfg, force=False, device=dev)

    def source(i):
        # each "digitiser" ships its chunk over the wire, the receiver
        # thread reassembles, the runner retires at its own cadence
        for ai in range(a):
            for pi in range(p):
                dig.send(x[ai, pi, i * c:(i + 1) * c], timestamp=i * c,
                         stream=ai * p + pi)
        _drain(rx, sink.stats()["datagrams"])
        if not ing.tail_complete():
            raise RuntimeError(f"chunk {i} did not arrive whole: rx "
                               f"{rx.stats()}, tx {sink.stats()}, ingest "
                               f"{ing.stats()}")
        return src(i)

    window = pfb_window(cfg.n_taps, cfg.fft_size)
    runner = FXRunner(cfg, window, device=dev)
    t0 = time.perf_counter()
    dumps, counters = runner.run(source, n_chunks)
    wall = time.perf_counter() - t0
    rate = a * p * c * n_chunks / wall
    ref, _ = FXRunner(cfg, window, device=dev).run(
        lambda i: torch.from_numpy(x[..., i * c:(i + 1) * c]).to(dev),
        n_chunks)
    same = len(dumps) == len(ref) == 1 and np.array_equal(dumps[0].vis,
                                                          ref[0].vis)

    # --- the correlator->consumer hop: a second socket pair -----------
    vis = np.ascontiguousarray(dumps[0].vis)
    consumer = NativeIngest(1, 1, vis.nbytes, pinned=False)
    rx2 = UdpSpeadReceiver(consumer, bind_addr="127.0.0.1")
    sink2 = UdpSpeadSink("127.0.0.1", rx2.port)
    out_tx = SpeadTransmitter(sink2, max_payload=4096)
    n_out = out_tx.send(vis.view(np.int8), timestamp=0, stream=0)
    _drain(rx2, n_out)
    got, fill2 = consumer.retire()
    delivered = fill2 == 1.0 and got.tobytes() == vis.tobytes()
    ok = (same and delivered and rx.stats()["rejected"] == 0
          and sink.stats()["dropped"] == 0)

    print(f"rx: {rx.stats()}  tx: {sink.stats()}  ingest: {ing.stats()}")
    print(f"{counters.chunks_in} chunks through the socket at "
          f"{rate / 1e6:.1f} Msamp/s (localhost), {len(dumps)} dump equal "
          f"to the device-fed run: {same}; dump delivered downstream "
          f"bit-exact over hop 2 ({n_out} datagrams): {delivered} ({dev})")
    for h in (rx, sink, rx2, sink2, ing, consumer):
        h.close()
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
