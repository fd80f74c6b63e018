#!/usr/bin/env python
"""SPEAD-64-48 transport loopback: digitiser packets in, dumps out.

Every hop moves as SPEAD heaps over UDP in the reference world.  This
example runs the port's native transport both ways with no network:

  tx side: per-antenna sample streams packetized by ``spead_packetize``
  rx side: datagrams (shuffled, as UDP would) -> ``NativeIngest`` (pinned
           slots on the card) -> ``multi_ingest_source`` -> FXRunner ->
           integrated visibility dump, equal to the runner fed the same
           samples from the device
  out:     the dump shipped onward by ``SpeadTransmitter`` and
           reassembled bit-exact by a second assembler

Runs on the card, or on the CPU with ``--cpu``::

    python -m dc_sand_tpu_torch.examples.spead_loopback [--cpu]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))


def main(argv=None) -> int:
    import torch
    from dc_sand_tpu_torch.config import get_config
    from dc_sand_tpu_torch.ops._dispatch import default_device
    from dc_sand_tpu_torch.runtime import (DelayModel, FXRunner, NativeIngest,
                                           SpeadTransmitter,
                                           multi_ingest_source,
                                           spead_packetize)
    from dc_sand_tpu_torch.windows import pfb_window

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    dev = default_device("cpu" if args.cpu else None)

    cfg = get_config("fx4").replace(n_chans=128, spectra_per_chunk=8,
                                    n_spectra_per_acc=8,
                                    apply_delay=False)
    a, p, c = cfg.n_ants, cfg.n_pols, cfg.chunk_samples
    rng = np.random.default_rng(7)
    x = rng.integers(-100, 100, (a, p, c), dtype=np.int8)

    # --- tx: packetize every stream, shuffle the datagrams like UDP ---
    frags = []
    for ai in range(a):
        for pi in range(p):
            buf, lens = spead_packetize(x[ai, pi], timestamp=0,
                                        stream=ai * p + pi,
                                        heap_id=ai * p + pi,
                                        max_payload=1024)
            off = 0
            for ln in lens:
                frags.append(buf[off:off + int(ln)])
                off += int(ln)
    rng.shuffle(frags)

    # --- rx: reassemble, run the correlator on the retired chunk ------
    window = pfb_window(cfg.n_taps, cfg.fft_size)
    ing = NativeIngest(a, p, c, pinned=dev.type == "cuda")
    placed = ing.submit_spead_burst(frags)
    complete = ing.tail_complete()
    src = multi_ingest_source([ing], cfg, force=False, device=dev)
    runner = FXRunner(cfg, window, delay_model=DelayModel.zeros(a, p),
                      device=dev)
    dumps, _counters = runner.run(src, 1)
    ref, _ = FXRunner(cfg, window, delay_model=DelayModel.zeros(a, p),
                      device=dev).run(
        lambda i: torch.from_numpy(x).to(dev), 1)

    # --- onward: ship the dump as SPEAD, reassemble it ----------------
    vis = np.ascontiguousarray(dumps[0].vis)
    consumer = NativeIngest(1, 1, vis.nbytes, pinned=False)
    tx = SpeadTransmitter(
        lambda b, lens: consumer.submit_spead_burst((b, lens)),
        ticks_per_chunk=vis.nbytes)
    n_pkts = tx.send_dump(dumps[0])
    got, fill = consumer.retire()
    print(f"{placed} datagrams in -> chunk reassembled (complete: "
          f"{complete}) -> {len(dumps)} dump ({vis.shape} int32, equal to "
          f"the device-fed run: {np.array_equal(vis, ref[0].vis)}) -> "
          f"{n_pkts} datagrams out, reassembled bit-exact: "
          f"{fill == 1.0 and got.tobytes() == vis.tobytes()} ({dev})")
    ok = (placed == len(frags) and complete and len(dumps) == 1
          and np.array_equal(vis, ref[0].vis) and n_pkts > 0
          and fill == 1.0 and got.tobytes() == vis.tobytes())
    for h in (ing, consumer):
        h.close()
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
