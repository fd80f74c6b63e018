"""Runnable examples of the port, each verifying itself and printing
``PASS``: ``spead_loopback`` (SPEAD framing in process) and
``udp_observation`` (the wire leg over a localhost UDP socket).  They run
on the card unless given ``--cpu``::

    python -m dc_sand_tpu_torch.examples.spead_loopback [--cpu]
    python -m dc_sand_tpu_torch.examples.udp_observation [--cpu]
"""
