"""Runnable examples of the port, each verifying itself and printing
``PASS``, with the shapes and seeds of the JAX package's ``examples/``:
``fx_observation`` (fx4 at 256 channels), ``observe`` (fringe stopping on
8-spectra chunks), ``beams`` (two steered beams and the incoherent beam),
``beam_pointing`` (beam64 cut to 8 antennas and 3 beams),
``spead_loopback`` (SPEAD framing in process) and ``udp_observation``
(the wire leg over a localhost UDP socket).  They run on the card unless
given ``--cpu``::

    python -m dc_sand_tpu_torch.examples.observe [--cpu]
"""
