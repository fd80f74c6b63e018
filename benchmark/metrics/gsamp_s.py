"""gsamp_s: samples of every chunk completed in the window over the
window's seconds, in Gsamp/s (host clock)."""


def read(run):
    return run["chunks"] * run["samples_per_chunk"] / run["seconds"] / 1e9
