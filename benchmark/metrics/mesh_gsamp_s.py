"""mesh_gsamp_s: the node's samples (every rank's antennas) of every
chunk completed in the window over the window's seconds on rank 0's
clock, in Gsamp/s."""


def read(run):
    return run["chunks"] * run["samples_per_chunk"] / run["seconds"] / 1e9
