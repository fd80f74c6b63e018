"""The plain reference of the chain, in PyTorch, independent of the port:
it imports nothing of ``dc_sand_tpu_torch`` and takes nothing the program
made, only the run's inputs (:mod:`benchmark.inputs`).

Each function follows the chain's definition (the repo's float64 golden
models, ``golden/chain.py``): the coarse delay as a read offset into the
raw stream, the polyphase FIR ``y[b, n] = sum_t w[t M + n] x[(b + t) M +
n]``, the real FFT's first M/2 bins, the fine-delay and fringe phasor
``exp(-i (2 pi k d / M + p))``, the complex gain, rounding half to even
and saturation to +-127; then every baseline integrated exactly, or the
beams ``sum_a w x``, requantised to 8 bits by the configuration's beam
scale, and the incoherent beam ``sum_a |x|^2``.

``precision="float64"`` is the reference.  ``precision="tf32"`` is the
control: the same chain one precision step below the configuration's
float32 with TF32 off, the FIR's window and the FFT's operands (a DFT
matrix product) rounded to TF32's 10-bit mantissa with float32 sums, the
phasor and gain in float32, and the beam weights rounded to TF32.
"""

from __future__ import annotations

import math

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest, ties
    to even."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def delayed_segment(ring: list, i: int, coarse, max_delay: int, taps: int,
                    m: int) -> torch.Tensor:
    """The coarse-delayed stream that chunk ``i``'s spectra read: ``(S,
    (taps-1) M + C)`` int8, row s the raw stream from ``t0 - (taps-1) M -
    coarse_s`` on (``t0 = i C``), zeros before the stream's start.  Chunk
    j of the raw stream is ``ring[j mod len(ring)]`` ``(A, P, C)``."""
    cur = ring[i % len(ring)]
    s = cur.shape[0] * cur.shape[1]
    c = cur.shape[-1]
    cur = cur.reshape(s, c)
    lead_len = max_delay + (taps - 1) * m
    lead = (ring[(i - 1) % len(ring)].reshape(s, c)[:, c - lead_len:]
            if i > 0 else torch.zeros((s, lead_len), dtype=torch.int8,
                                      device=cur.device))
    buf = torch.cat([lead, cur], dim=1)
    n = (taps - 1) * m + c
    co = torch.as_tensor(coarse).reshape(-1).to(torch.int64).clamp(
        0, max_delay).tolist()
    return torch.stack([buf[r, max_delay - d:max_delay - d + n]
                        for r, d in enumerate(co)])


def _dft(m: int, k: int, device) -> torch.Tensor:
    """``(M, 2K)`` float32: the real FFT's first K bins as a matrix,
    cosines then minus sines, rounded to TF32."""
    n = torch.arange(m, dtype=torch.float64, device=device)[:, None]
    ang = 2 * math.pi * ((n * torch.arange(k, dtype=torch.float64,
                                           device=device)) % m) / m
    return tf32(torch.cat([torch.cos(ang), -torch.sin(ang)], 1))


def fengine(seg: torch.Tensor, window, taps: int, m: int, frac, phase,
            gains, precision: str = "float64", block: int = 16) -> tuple:
    """The F-engine on delayed streams ``seg (S, (taps-1) M + B M)`` int8
    with per-spectrum ``frac`` and ``phase`` ``(S, B)`` float32 and
    ``gains (K, 2)``: ``(re, im)`` int8 ``(S, B, K)``.  ``block`` streams
    at a time."""
    dev = seg.device
    s, k = seg.shape[0], m // 2
    b = seg.shape[1] // m - (taps - 1)
    wide = torch.float64 if precision == "float64" else torch.float32
    w = torch.as_tensor(window, dtype=torch.float64, device=dev)
    w = (w if precision == "float64" else tf32(w)).to(wide).reshape(taps, m)
    fir = w.t().contiguous().reshape(m, 1, taps)
    g = torch.as_tensor(gains, device=dev).to(wide)
    g = torch.complex(g[:, 0], g[:, 1])
    kk = torch.arange(k, dtype=wide, device=dev)
    scale = -2.0 * math.pi / m
    frac = torch.as_tensor(frac, device=dev).reshape(s, b)
    phase = torch.as_tensor(phase, device=dev).reshape(s, b)
    dft = _dft(m, k, dev) if precision == "tf32" else None
    re = torch.empty((s, b, k), dtype=torch.int8, device=dev)
    im = torch.empty_like(re)
    for lo in range(0, s, block):
        hi = min(lo + block, s)
        # the FIR as a depthwise convolution along the frames, one filter
        # a column n: y[s, b, n] = sum_t w[t, n] x[s, b + t, n]
        x = seg[lo:hi].to(wide).reshape(hi - lo, taps - 1 + b, m)
        y = torch.nn.functional.conv1d(x.transpose(1, 2), fir, groups=m)
        y = y.transpose(1, 2).contiguous()
        del x
        if dft is None:
            spec = torch.fft.rfft(y, dim=-1)[..., :k]
        else:
            prod = tf32(y).reshape(-1, m) @ dft
            spec = torch.complex(prod[:, :k], prod[:, k:]).reshape(
                hi - lo, b, k)
            del prod
        del y
        theta = (scale * kk) * frac[lo:hi, :, None].to(wide) \
            - phase[lo:hi, :, None].to(wide)
        spec = spec * torch.polar(torch.ones_like(theta), theta) * g
        del theta
        re[lo:hi] = torch.clamp(torch.round(spec.real), -127, 127).to(
            torch.int8)
        im[lo:hi] = torch.clamp(torch.round(spec.imag), -127, 127).to(
            torch.int8)
    return re, im


def chunk_spectra(inputs, i: int, cfg, precision: str = "float64") -> tuple:
    """Chunk ``i``'s requantised spectra ``(re, im)`` int8 ``(A*P, B,
    K)`` from the run's ``inputs``."""
    m, b = cfg.fft_size, cfg.spectra_per_chunk
    coarse, frac, phase = inputs.delays.evaluate(i * cfg.chunk_samples, b, m)
    seg = delayed_segment(inputs.ring, i, torch.from_numpy(coarse),
                          inputs.delays.max_delay, cfg.n_taps, m)
    return fengine(seg, inputs.window, cfg.n_taps, m,
                   torch.from_numpy(frac), torch.from_numpy(phase),
                   torch.from_numpy(inputs.gains), precision)


def visibilities(re: torch.Tensor, im: torch.Tensor, n_ants: int,
                 n_pols: int, block: int = 128) -> torch.Tensor:
    """Every baseline integrated exactly from int8 spectra ``(A*P, B,
    K)``: ``(n_bl, P, P, K, 2)`` int64, baselines (i, j), i <= j,
    i-major, ``V = sum_b x_i conj(x_j)``."""
    s, _, k = re.shape
    iu = torch.triu_indices(n_ants, n_ants, device=re.device)
    out = torch.empty((iu.shape[1], n_pols, n_pols, k, 2), dtype=torch.int64,
                      device=re.device)
    for lo in range(0, k, block):
        hi = min(lo + block, k)
        x = torch.complex(re[..., lo:hi].to(torch.float64),
                          im[..., lo:hi].to(torch.float64)).permute(2, 0, 1)
        v = (x @ x.conj().transpose(1, 2)).reshape(
            hi - lo, n_ants, n_pols, n_ants, n_pols).permute(1, 3, 2, 4, 0)
        v = v[iu[0], iu[1]]                       # (bl, P, P, k)
        out[..., lo:hi, 0] = v.real.round().to(torch.int64)
        out[..., lo:hi, 1] = v.imag.round().to(torch.int64)
    return out


def beams(re: torch.Tensor, im: torch.Tensor, weights, n_ants: int,
          precision: str = "float64") -> tuple:
    """The coherent beams ``(nb, P, B, K, 2)`` and the incoherent beam
    ``(P, B, K)`` of int8 spectra ``(A*P, B, K)``, float64 (float32 with
    the weights rounded to TF32 for the control)."""
    s, b, k = re.shape
    wide = torch.float64 if precision == "float64" else torch.float32
    w = torch.as_tensor(weights, device=re.device).to(torch.float32)
    if precision != "float64":
        w = tf32(w)
    w = torch.complex(w[..., 0].to(wide), w[..., 1].to(wide))
    x = torch.complex(re.to(wide), im.to(wide)).reshape(n_ants, -1, b, k)
    y = torch.einsum("eak,apbk->epbk", w, x)
    inc = (x.real ** 2 + x.imag ** 2).sum(0)
    return torch.stack([y.real, y.imag], -1), inc


def quantise_beams(y: torch.Tensor, scale: float) -> torch.Tensor:
    """Beams ``y`` as the 8-bit beam product: ``y * scale`` rounded half to
    even and saturated to +-127 (``y`` as it is where ``scale`` is 0, the
    float beams)."""
    if not scale:
        return y
    return torch.clamp(torch.round(y * scale), -127, 127)
