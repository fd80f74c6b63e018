"""The H100's published peaks and the frozen counts of the work each
kernel of a cell does, from its shapes alone.

The counts are the benchmark's own copy, so a roofline share reads the
same work whatever implements the kernel.  A share is the least time the
card could take for the counted work, the larger of its bytes at the HBM
rate and its operations at their peaks (or, for an exchange between
cards, its bytes over NVLink), over the time the kernel took.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense rates at the card's full 700 W: HBM3,
# fp32 without the tensor cores, int8 and bf16 on the tensor cores; NVLink
# 4 carries 900 GB/s a card to the others of its host, 450 each way
HBM_BYTES_S = 3.35e12
FP32_FLOPS = 67e12
INT8_OPS = 1979e12
BF16_FLOPS = 989e12
NVLINK_BYTES_S = 450e9


def bound_s(nbytes: float = 0.0, fp32_ops: float = 0.0, int8_ops: float = 0.0,
            bf16_ops: float = 0.0, link_bytes: float = 0.0) -> float:
    """Seconds the card needs at least: the largest of the bytes at the
    HBM rate, the operations at their peaks (their times added) and the
    bytes that cross NVLink at its rate each way."""
    return max(nbytes / HBM_BYTES_S,
               fp32_ops / FP32_FLOPS + int8_ops / INT8_OPS
               + bf16_ops / BF16_FLOPS,
               link_bytes / NVLINK_BYTES_S)


def fengine_flops(spectra: int, m: int, taps: int) -> int:
    """fp32 operations of the F-engine with delay and requantisation for
    ``spectra`` spectra of ``m`` samples: a multiply and an add a tap, 5 N
    log2 N for the N = M/2 point complex FFT, 16 a channel for the real
    split, 9 for the phasor (its angle and a complex product; sincos
    uncounted) and 6 for the complex gain."""
    n = m // 2
    return spectra * (2 * taps * m + 5 * n * int(math.log2(n)) + 16 * n
                      + 9 * n + 6 * n)


def k1_bound_s(streams: int, spectra: int, m: int, taps: int) -> float:
    """K1 (FIR, FFT, phasor, requantisation) on ``streams`` streams of a
    chunk of ``spectra`` spectra: the chunk and the history's taps-1
    frames read, the int8 spectra written, and its fp32 operations."""
    nbytes = streams * ((spectra + taps - 1) * m + spectra * m)
    return bound_s(nbytes, fp32_ops=fengine_flops(streams * spectra, m, taps))


def cmac_bound_s(chans: int, streams: int, spectra: int) -> float:
    """The CMAC of one chunk: the int8 operand ``(K, 2 S, B)`` read, the
    packed int32 ``(K, S, S)`` accumulator read and written, and 8 int8
    operations a complex product over the full S x S matrix."""
    nbytes = chans * 2 * streams * spectra + 2 * chans * streams ** 2 * 4
    return bound_s(nbytes, int8_ops=8 * chans * streams ** 2 * spectra)


def gather_bound_s(streams: int, samples_out: int) -> float:
    """The coarse gather: every output sample read once and written once,
    and a 4-byte delay a stream."""
    return bound_s(2 * streams * samples_out + 4 * streams)


def beam_bound_s(ants: int, pols: int, spectra: int, chans: int,
                 beams: int, beam_bytes: int) -> float:
    """The beam kernel on one chunk: the int8 spectra and the float32
    weights read, the beams (``beam_bytes`` a complex sample: 2 for the
    8-bit product, 8 for float32) and the float32 incoherent beam
    written; 8 useful flops a complex multiply-add at the bf16 peak, 4 a
    sample for the incoherent sum at the fp32 peak."""
    nbytes = (ants * pols * spectra * chans * 2 + beams * ants * chans * 8
              + beams * pols * spectra * chans * beam_bytes
              + pols * spectra * chans * 4)
    return bound_s(nbytes, fp32_ops=4 * pols * spectra * chans * ants,
                   bf16_ops=8 * beams * pols * spectra * chans * ants)


def corner_turn_bound_s(chans: int, streams_local: int, spectra: int,
                        cards: int) -> float:
    """K7b's corner-turn on one card: its operand shard ``(K, 2, S_l, B)``
    int8 of which ``(cards - 1) / cards`` crosses NVLink to the other
    cards, the rest copied on the card (read and written)."""
    shard = chans * 2 * streams_local * spectra
    return bound_s(2 * shard // cards, link_bytes=shard * (cards - 1) // cards)
