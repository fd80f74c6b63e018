"""K7b, the corner-turn across the cards (parallel/corner_turn.py,
parallel/remote_dma.py, csrc/remote_dma.cu: copy_rows), a card's launch
a chunk: its share of the bound of its frozen work, the bytes that cross
NVLink at 450 GB/s each way (benchmark/roofline.py:
corner_turn_bound_s)."""

from benchmark.roofline import corner_turn_bound_s


def read(trace):
    c = trace.cfg
    pitch = -(-c.spectra_per_chunk // 16) * 16
    return trace.roofline_pct(("copy_rows",), corner_turn_bound_s(
        c.n_chans, c.n_ants * c.n_pols // trace.cards, pitch, trace.cards))
