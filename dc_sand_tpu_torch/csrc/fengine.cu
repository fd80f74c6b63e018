// Fused F-engine kernel (K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel dc_sand_tpu/ops/fengine_fused.py:_kernel (launched
// by _launch_fused from fengine_fused / _fused_split).  It computes what that
// kernel computes, not its block plan (the bf16x3 stage-2 matmul, the
// identity-dot shifts and the native planes exist for the TPU's Mosaic
// compiler):
//
//   1. FIR:   y[j, n] = sum_t w[t, n] * x[j + pad0 + t, n] in float32 over the
//             frames of the virtual stream [hist | chunk] (frame f comes from
//             `hist` when f < n_hist and from `chunk` otherwise);
//   2. FFT:   the M-point real FFT as an N = M/2 point complex FFT of the
//             packed even/odd samples z[n] = y[2n] + i y[2n+1];
//   3. Split: X[k] = E[k] + W_M^k O[k] for k < N = K (the Nyquist bin is
//             dropped, as golden/chain.py:channelize does);
//   4. Phase: X *= exp(i theta), theta = (-(2 pi / M) * k) * d_j - p_j, the
//             phasor a product of two per-spectrum table values made in
//             float64 (see phasor_tables);
//   5. Quant: X *= gain[k], rintf (round half to even), saturate to
//             [-127, 127] (never -128: the X-engine negates int8 values).
//             Without gains (the float-output mode of config pfb1k) X is
//             stored as float32 instead.
//
// Output layouts: "wire" (S, n_out, K, 2), int8 or float32; "operand" (int8
// only) (K, 2, S, pitch), the X-engine's stacked operand [Ar; Ai] for the
// streams of the call, so the fx path needs no corner-turn permute.  Its
// rows hold n_out spectra at a pitch the caller gives (the fx path: n_out
// rounded up to the CMAC's 16), zeros in the pad: from M = 2048 the
// cluster's gather stores them with the row's last run, below it (or for a
// pitch past the grid's last spectrum) a 2D memset writes them first.
//
// What bounds it on the H100: at fx64 (M = 8192, 16 taps, 128 streams x 2048
// spectra) the useful work is 0.17 TFLOP of fp32 (2.5 ms at 67 TFLOP/s) and
// 4.3 GB of device memory (1.3 ms); the FIR alone needs 512 KB of window for
// every output spectrum.  The first design (one CTA per spectrum, radix-2 FFT
// in shared memory, every operation an _rn intrinsic) pulled 640 KB a spectrum
// through L2, converted each frame byte 16 times with I2F, and made 12 passes
// of shared memory with a 32-way bank conflict on the bit-reversed scatter: 46
// ms a chunk on an H100 80GB HBM3 at 700 W; this design takes about 14 ms
// (wire layout) and 17 ms (operand layout) there:
//
//   * One CTA of 512 threads per (stream, tile of kJ consecutive spectra); for
//     M < 2048 a tile holds P = 2048 / M sub-tiles of kJ spectra each, so every
//     thread has work.  Neighbouring tiles of one stream run in neighbouring
//     CTAs, so shared frames hit in L2.
//   * FIR as K6 does it (csrc/pfb.cu): a thread holds the weights of 4
//     consecutive columns in registers for a column slice, walks the tile's
//     kJ + taps - 1 frames once (each byte converted once, by the exponent
//     trick, not I2F), FMA into kJ x 4 accumulators and stores them into the
//     tile's spectra in shared memory.  The window is read once a tile: L2
//     traffic per spectrum falls from 640 KB to 113 KB at kJ = 6, the most
//     float32 spectra of M = 8192 that fit in 227 KB of shared memory.
//   * FFT as Stockham radix-16 passes (radix 8, 4 or 2 for the last): each
//     thread holds one butterfly's 16 points in registers, twiddles from
//     float64-made tables (one table row a pass, read once a tile), output in
//     natural order, no bit reversal.  Shared memory is padded by one complex
//     value in 16, which keeps every pass free of bank conflicts.  At N = 4096:
//     3 passes of 3 rounds (2 spectra a round), each load -> DFT -> barrier
//     -> store, and a barrier after a pass's last round.
//   * Epilogue per (bin k, tile): the split, phasor, gain and rounding of the
//     tile's kJ spectra, with W_M^k and gain[k] loaded once.  The phasor
//     comes from two tables of each spectrum (128 float64 sincos a spectrum
//     at M = 8192 in place of 4096 float32 ones).  The operand layout's
//     kJ-byte runs per (k, re/im, stream) are staged in shared memory and
//     a cluster of kCluster CTAs (consecutive tiles of one stream) gathers
//     them over DSMEM into kCluster * kJ = 48-byte runs, stored as 16-byte
//     words: on the same card 6-byte runs stored by each CTA cost 10 ms more
//     than the wire layout, the 48-byte runs 3 ms.  A cluster's CTAs must
//     share a GPC, so 15 clusters (120 of the 132 SMs) run at once; M < 2048
//     (several sub-tiles a CTA) stores each CTA's runs itself.
//   * FMA and any summation order are allowed: the kernel is held to its
//     plain version within 1-LSB boundary flips (int8) and >= 100 dB (float),
//     not bitwise.
//
// Built with -DDCS_K1_PHASES (dc_sand_tpu_torch/bench/k1_phases.py) thread 0
// of every CTA adds the clocks of its FIR, FFT and epilogue (in the
// cluster-gathered operand layout: its compute, the exchange through shared
// memory and the gather and store) to device counters that
// dcs_fengine_phases reads.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kJ = 6;          // spectra per sub-tile
constexpr int kMaxTaps = 16;
constexpr int kCols = 4;       // consecutive FIR columns per thread
constexpr int kFrames = kJ + kMaxTaps - 1;
constexpr int kMaxHalf = 4096; // N = M / 2 <= 4096
constexpr int kMaxPasses = 4;
constexpr int kCluster = 8;    // CTAs that gather the operand layout's runs

#ifdef DCS_K1_PHASES
constexpr int kPhases = 5;  // fir, fft, epilogue, exchange, gather + store
__device__ unsigned long long g_phase_clocks[kPhases];
#define DCS_CLOCK(name) const long long name = clock64()
#else
#define DCS_CLOCK(name)
#endif

struct Params {
  const int8_t* hist;
  const int8_t* chunk;
  const float* window;
  const float2* split_tw;  // W_M^k, k < N
  const float2* pass_tw;   // Stockham pass twiddles, see fft_plan
  const float* frac;       // (S, n_out) or null
  const float* phase;
  const float2* gains;     // (K,) or null (float output)
  void* out;
  int n_streams, n_hist, n_chunk, n_out, m, taps, pad0;
  int pitch;               // operand layout: bytes between a row's streams
  int groups;              // FIR column groups G = min(kThreads, M / 4)
  int subs;                // sub-tiles P = kThreads / G
  int n_pass;
  int radix[kMaxPasses];
  int tw_off[kMaxPasses];
};

__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

// Four signed bytes -> four exact floats: byte b becomes the low mantissa
// byte of 2^23 + (b + 128), and subtracting 2^23 + 128 leaves b.
__device__ __forceinline__ void unpack4(uint32_t packed, float x[kCols]) {
  const uint32_t q = packed ^ 0x80808080u;
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    x[c] = __uint_as_float(__byte_perm(q, 0x4B000000u, 0x7440 | c)) - 8388736.0f;
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

__device__ __forceinline__ int8_t quant(float v) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v), -127.0f), 127.0f));
}

// cos and sin of 2 pi e / 16, e < 8
__device__ __forceinline__ float cos16(int e) {
  switch (e) {
    case 0: return 1.0f;
    case 1: return 0.92387953251128674f;
    case 2: return 0.70710678118654752f;
    case 3: return 0.38268343236508977f;
    case 4: return 0.0f;
    case 5: return -0.38268343236508977f;
    case 6: return -0.70710678118654752f;
    default: return -0.92387953251128674f;
  }
}

__device__ __forceinline__ float sin16(int e) { return cos16(e < 4 ? 4 - e : e - 4); }

// d * exp(-2 pi i E / R), E < R / 2, with the trivial angles done by hand.
template <int R, int E>
__device__ __forceinline__ float2 rot(float2 d) {
  constexpr int e16 = E * (16 / R);
  constexpr float c45 = 0.70710678118654752f;
  if constexpr (e16 == 0) {
    return d;
  } else if constexpr (e16 == 4) {
    return make_float2(d.y, -d.x);  // -i
  } else if constexpr (e16 == 2) {
    return make_float2(c45 * (d.x + d.y), c45 * (d.y - d.x));
  } else if constexpr (e16 == 6) {
    return make_float2(c45 * (d.y - d.x), -c45 * (d.x + d.y));
  } else {
    const float c = cos16(e16), s = sin16(e16);
    return make_float2(fmaf(d.x, c, d.y * s), fmaf(d.y, c, -d.x * s));  // d (c - i s)
  }
}

__host__ __device__ constexpr int brev(int k, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((k >> b) & 1) << (bits - 1 - b);
  return r;
}

__host__ __device__ constexpr int log2c(int r) { return r <= 1 ? 0 : 1 + log2c(r / 2); }

// Butterfly I (of R / 2) of the radix-2 decimation-in-frequency stage whose
// butterflies span Span registers, then the stage's later butterflies.  All
// indices are template constants, so the registers are never addressed at
// run time.
template <int R, int Span, int I>
__device__ __forceinline__ void dif_stage(float2 (&v)[R]) {
  if constexpr (I < R / 2) {
    constexpr int k = I % Span;
    constexpr int i0 = (I / Span) * 2 * Span + k;
    const float2 a = v[i0], b = v[i0 + Span];
    v[i0] = make_float2(a.x + b.x, a.y + b.y);
    v[i0 + Span] = rot<R, k * (R / (2 * Span))>(make_float2(a.x - b.x, a.y - b.y));
    dif_stage<R, Span, I + 1>(v);
  }
}

template <int R, int Span>
__device__ __forceinline__ void dif(float2 (&v)[R]) {
  if constexpr (Span >= 1) {
    dif_stage<R, Span, 0>(v);
    dif<R, Span / 2>(v);
  }
}

template <int R, int K>
__device__ __forceinline__ void unscramble(float2 (&t)[R], const float2 (&v)[R]) {
  if constexpr (K < R) {
    constexpr int src = brev(K, log2c(R));
    t[K] = v[src];
    unscramble<R, K + 1>(t, v);
  }
}

// In-register R-point DFT, natural order in and out: radix-2
// decimation-in-frequency stages, then the bit reversal as a renaming of
// registers.
template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R]) {
  dif<R, R / 2>(v);
  float2 t[R];
  unscramble<R, 0>(t, v);
#pragma unroll
  for (int k = 0; k < R; ++k) v[k] = t[k];
}

// One Stockham pass of radix R over the CTA's n_spec spectra, in place:
// butterfly j reads z[j + r N/R], multiplies by W_{Ns R}^{(j mod Ns) r},
// transforms and writes z[(j / Ns) Ns R + j mod Ns + r Ns].  A round covers
// whole spectra (N / R divides kThreads), so its loads finish, behind a
// barrier, before any of its stores.  Rounds touch disjoint spectra, so
// only the last round's stores need a barrier behind them: the next pass
// reads an earlier round's spectra behind the later rounds' barriers.
template <int R>
__device__ __forceinline__ void fft_pass(float2* __restrict__ z, int stride, int n_half,
                                         int ns, const float2* __restrict__ tw,
                                         int n_spec) {
  const int per = n_half / R;
  const int j = threadIdx.x & (per - 1);
  const int spec0 = threadIdx.x / per;
  const int step = kThreads / per;
  const int jm = j & (ns - 1);
  float2 w[R];
#pragma unroll
  for (int r = 1; r < R; ++r)
    w[r] = ns > 1 ? __ldg(tw + (r - 1) * ns + jm) : make_float2(1.0f, 0.0f);
  const int dst = (j - jm) * R + jm;
  for (int base = 0; base < n_spec; base += step) {
    const int spec = base + spec0;
    const bool valid = spec < n_spec;
    float2* zs = z + static_cast<size_t>(spec) * stride;
    float2 v[R];
    if (valid) {
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = zs[pad(j + r * per)];
      if (ns > 1) {
#pragma unroll
        for (int r = 1; r < R; ++r) v[r] = cmul(v[r], w[r]);
      }
      dft<R>(v);
    }
    __syncthreads();
    if (valid) {
#pragma unroll
      for (int r = 0; r < R; ++r) zs[pad(dst + r * ns)] = v[r];
    }
    if (base + step >= n_spec) __syncthreads();
  }
}

// n (<= kJ) bytes of `v` (byte i at bits 8i) to dst, as the widest aligned
// words.
__device__ __forceinline__ void store_run(int8_t* dst, unsigned long long v, int n) {
  int i = 0;
  while (i < n) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(dst + i);
    if ((a & 3) == 0 && i + 4 <= n) {
      *reinterpret_cast<uint32_t*>(dst + i) = static_cast<uint32_t>(v >> (8 * i));
      i += 4;
    } else if ((a & 1) == 0 && i + 2 <= n) {
      *reinterpret_cast<uint16_t*>(dst + i) = static_cast<uint16_t>(v >> (8 * i));
      i += 2;
    } else {
      dst[i] = static_cast<int8_t>(v >> (8 * i));
      i += 1;
    }
  }
}

// The phasor exp(i theta), theta = (-(2 pi / M) k) d - p, of bin k = kh L + kl
// of a spectrum is the product of two table values made in float64,
// exp(i ((-(2 pi / M) L kh) d - p)) (H = N / L of them) and
// exp(i (-(2 pi / M) kl) d) (L of them), in place of a sincosf a value.
__host__ __device__ constexpr int phasor_lo(int n_half) { return n_half < 64 ? n_half : 64; }

// The phasor tables of the CTA's n_spec spectra, (H + L) values each.  Out
// of line: float64 sincos would raise the register count of the whole kernel.
__device__ __noinline__ void phasor_tables(const Params& p, float2* tab, int n_half,
                                              size_t row0, int n_spec) {
  const int lo = phasor_lo(n_half), hi = n_half / lo, per = hi + lo;
  const double scale = -6.283185307179586476925286766559 / p.m;
  for (int e = threadIdx.x; e < n_spec * per; e += kThreads) {
    const int q = e / per, i = e - q * per;
    const double d = p.frac[row0 + q];
    const double a = i < hi ? scale * lo * i * d - p.phase[row0 + q] : scale * (i - hi) * d;
    double sn, cs;
    sincos(a, &sn, &cs);
    tab[e] = make_float2(static_cast<float>(cs), static_cast<float>(sn));
  }
}

// The split, phasor, gain and rounding of bin k of the n_valid spectra of a
// sub-tile (zsub; rows row0 ...; phasor tables tab, or null): layout 2 stores
// the float values, the int8 layouts get them back packed, spectrum jj's at
// bits 8 jj.
template <int kLayout>
__device__ __forceinline__ void epilogue_bin(const Params& p, const float2* zsub,
                                             int stride, int n_half, int k,
                                             int n_valid, size_t row0,
                                             const float2* tab,
                                             unsigned long long& re,
                                             unsigned long long& im) {
  const float2 wk = __ldg(p.split_tw + k);
  const float2 gk = kLayout == 2 ? make_float2(0.0f, 0.0f) : __ldg(p.gains + k);
  const int lo = phasor_lo(n_half), per = n_half / lo + lo;
  const int th = k / lo, tl = n_half / lo + (k & (lo - 1));
  const int ka = pad(k), kb = pad((n_half - k) & (n_half - 1));
  re = im = 0;
#pragma unroll
  for (int jj = 0; jj < kJ; ++jj) {
    if (jj < n_valid) {
      const float2 a = zsub[static_cast<size_t>(jj) * stride + ka];
      const float2 b = zsub[static_cast<size_t>(jj) * stride + kb];
      // E = (Z[k] + conj(Z[N-k])) / 2,  O = -i (Z[k] - conj(Z[N-k])) / 2
      const float2 e = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
      const float2 o = make_float2(0.5f * (a.y + b.y), -0.5f * (a.x - b.x));
      const float2 wo = cmul(wk, o);
      float2 v = make_float2(e.x + wo.x, e.y + wo.y);
      const size_t row = row0 + jj;
      if (tab != nullptr)
        v = cmul(v, cmul(tab[jj * per + th], tab[jj * per + tl]));
      if constexpr (kLayout == 2) {
        reinterpret_cast<float2*>(p.out)[row * n_half + k] = v;
      } else {
        v = cmul(v, gk);
        re |= static_cast<unsigned long long>(static_cast<uint8_t>(quant(v.x))) << (8 * jj);
        im |= static_cast<unsigned long long>(static_cast<uint8_t>(quant(v.y))) << (8 * jj);
      }
    }
  }
}

// kLayout: 0 wire int8, 1 operand int8 stored by each CTA, 2 wire float32,
// 3 operand int8 gathered by a cluster of kCluster CTAs (one sub-tile a CTA).
template <int kLayout>
__global__ void __launch_bounds__(kThreads, 1)
fengine_kernel(const __grid_constant__ Params p) {
  extern __shared__ float2 z[];  // subs * kJ spectra of N (+ N/16 pad) values
  DCS_CLOCK(c0);
  const int m = p.m;
  const int n_half = m >> 1;
  const int stride = n_half + (n_half >> 4);
  const int s = blockIdx.y;
  const int j_cta = blockIdx.x * p.subs * kJ;
  const int n_spec = min(p.subs * kJ, p.n_out - j_cta);  // <= 0: cluster padding
  const int tid = threadIdx.x;

  // 1. FIR of this thread's sub-tile, column slice by column slice.
  {
    const int g = tid % p.groups;
    const int sub = tid / p.groups;
    const int n_valid = min(kJ, n_spec - sub * kJ);
    const int f0 = j_cta + sub * kJ + p.pad0;
    const int nf = n_valid + p.taps - 1;
    float2* zsub = z + static_cast<size_t>(sub * kJ) * stride;
    for (int n0 = kCols * g; n_valid > 0 && n0 < m; n0 += kCols * p.groups) {
      float w[kMaxTaps][kCols];
#pragma unroll
      for (int t = 0; t < kMaxTaps; ++t) {
        if (t < p.taps) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(
              p.window + static_cast<size_t>(t) * m + n0));
          w[t][0] = v.x; w[t][1] = v.y; w[t][2] = v.z; w[t][3] = v.w;
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c) w[t][c] = 0.0f;
        }
      }
      uint32_t raw[kFrames];
#pragma unroll
      for (int f = 0; f < kFrames; ++f) {
        raw[f] = 0u;
        if (f < nf) {
          const int fa = f0 + f;
          const int8_t* row =
              fa < p.n_hist
                  ? p.hist + (static_cast<size_t>(s) * p.n_hist + fa) * m
                  : p.chunk + (static_cast<size_t>(s) * p.n_chunk + (fa - p.n_hist)) * m;
          raw[f] = __ldg(reinterpret_cast<const unsigned int*>(row + n0));
        }
      }
      float acc[kJ][kCols];
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[jj][c] = 0.0f;
#pragma unroll
      for (int f = 0; f < kFrames; ++f) {
        float x[kCols];
        unpack4(raw[f], x);
#pragma unroll
        for (int t = 0; t < kMaxTaps; ++t) {
          const int jj = f - t;
          if (jj >= 0 && jj < kJ) {
#pragma unroll
            for (int c = 0; c < kCols; ++c) acc[jj][c] = fmaf(w[t][c], x[c], acc[jj][c]);
          }
        }
      }
      const int i0 = n0 >> 1;
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        if (jj < n_valid) {
          float2* zj = zsub + static_cast<size_t>(jj) * stride;
          zj[pad(i0)] = make_float2(acc[jj][0], acc[jj][1]);
          zj[pad(i0 + 1)] = make_float2(acc[jj][2], acc[jj][3]);
        }
      }
    }
  }
  __syncthreads();
  DCS_CLOCK(c1);

  // 2. FFT, Stockham passes in place.
  {
    int ns = 1;
    for (int q = 0; q < p.n_pass; ++q) {
      const int r = p.radix[q];
      const float2* tw = p.pass_tw + p.tw_off[q];
      if (r == 16) fft_pass<16>(z, stride, n_half, ns, tw, n_spec);
      else if (r == 8) fft_pass<8>(z, stride, n_half, ns, tw, n_spec);
      else if (r == 4) fft_pass<4>(z, stride, n_half, ns, tw, n_spec);
      else fft_pass<2>(z, stride, n_half, ns, tw, n_spec);
      ns *= r;
    }
  }
  DCS_CLOCK(c2);

  // 3-5. Split, phasor, gain, rounding and the store, per (sub-tile, bin).
  float2* tab = nullptr;  // the phasor tables, after the spectra
  if (p.frac != nullptr) {
    tab = z + static_cast<size_t>(p.subs) * kJ * stride;
    phasor_tables(p, tab, n_half, static_cast<size_t>(s) * p.n_out + j_cta, n_spec);
    __syncthreads();
  }
  if constexpr (kLayout == 3) {
    // one sub-tile; the cluster's kCluster CTAs hold consecutive tiles
    const int n_valid = min(kJ, n_spec);
    const size_t row0 = static_cast<size_t>(s) * p.n_out + j_cta;
    constexpr int kItems = kMaxHalf / kThreads;
    unsigned long long kr[kItems], ki[kItems];
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int k = tid + i * kThreads;
      kr[i] = ki[i] = 0;
      if (k < n_half && n_valid > 0)
        epilogue_bin<kLayout>(p, z, stride, n_half, k, n_valid, row0, tab, kr[i], ki[i]);
    }
    __syncthreads();  // the spectra are read: their space takes the stage
    DCS_CLOCK(c3);
    unsigned long long* stage = reinterpret_cast<unsigned long long*>(z);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int k = tid + i * kThreads;
      if (k < n_half) {
        stage[2 * k] = kr[i];
        stage[2 * k + 1] = ki[i];
      }
    }
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    DCS_CLOCK(c4);
    // rank r stores rows (k, c) [r, r + 1) * 2N / kCluster of the cluster's
    // kCluster * kJ spectra, gathered from every CTA's stage
    const int rank = static_cast<int>(cluster.block_rank());
    const int j_clu = (blockIdx.x / kCluster) * kCluster * kJ;
    // the run of a row this cluster stores: its spectra, and past n_out the
    // pad's zeros up to the pitch (the stages hold zeros past n_out)
    const int n_clu = min(kCluster * kJ, p.pitch - j_clu);
    const int per_rank = 2 * n_half / kCluster;
    const size_t plane = static_cast<size_t>(p.n_streams) * p.pitch;
    for (int row = rank * per_rank + tid; row < (rank + 1) * per_rank; row += kThreads) {
      unsigned long long w[kCluster * kJ / 8] = {};
#pragma unroll
      for (int q = 0; q < kCluster; ++q) {
        const unsigned long long piece = cluster.map_shared_rank(stage, q)[row];
        constexpr int kWords = kCluster * kJ / 8;
        const int off = q * kJ;
        w[off / 8] |= piece << (8 * (off % 8));
        if (off % 8 + kJ > 8 && off / 8 + 1 < kWords)
          w[off / 8 + 1] |= piece >> (8 * (8 - off % 8));
      }
      int8_t* dst = static_cast<int8_t*>(p.out) + static_cast<size_t>(row) * plane +
                    static_cast<size_t>(s) * p.pitch + j_clu;
      if (n_clu == kCluster * kJ && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
#pragma unroll
        for (int q = 0; q < kCluster * kJ / 16; ++q)
          reinterpret_cast<ulonglong2*>(dst)[q] = make_ulonglong2(w[2 * q], w[2 * q + 1]);
      } else {
#pragma unroll
        for (int q = 0; q < kCluster * kJ / 8; ++q)
          if (8 * q < n_clu) store_run(dst + 8 * q, w[q], min(8, n_clu - 8 * q));
      }
    }
    cluster.sync();  // no CTA leaves while another reads its stage
#ifdef DCS_K1_PHASES
    if (tid == 0) {
      const long long c5 = clock64();
      atomicAdd(&g_phase_clocks[2], static_cast<unsigned long long>(c3 - c2));
      atomicAdd(&g_phase_clocks[3], static_cast<unsigned long long>(c4 - c3));
      atomicAdd(&g_phase_clocks[4], static_cast<unsigned long long>(c5 - c4));
    }
#endif
  } else {
    const int per = n_half / phasor_lo(n_half) + phasor_lo(n_half);
    for (int it = tid; it < p.subs * n_half; it += kThreads) {
      const int sub = it / n_half;
      const int k = it & (n_half - 1);
      const int n_valid = min(kJ, n_spec - sub * kJ);
      if (n_valid <= 0) continue;
      const size_t row0 = static_cast<size_t>(s) * p.n_out + j_cta + sub * kJ;
      unsigned long long re, im;
      epilogue_bin<kLayout>(p, z + static_cast<size_t>(sub * kJ) * stride, stride, n_half,
                            k, n_valid, row0,
                            tab == nullptr ? nullptr : tab + sub * kJ * per, re, im);
      if constexpr (kLayout == 0) {
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj)
          if (jj < n_valid)
            reinterpret_cast<char2*>(p.out)[(row0 + jj) * n_half + k] =
                make_char2(static_cast<char>(re >> (8 * jj)), static_cast<char>(im >> (8 * jj)));
      } else if constexpr (kLayout == 1) {
        const size_t plane = static_cast<size_t>(p.n_streams) * p.pitch;
        int8_t* dst = static_cast<int8_t*>(p.out) + 2 * static_cast<size_t>(k) * plane +
                      static_cast<size_t>(s) * p.pitch + j_cta + sub * kJ;
        store_run(dst, re, n_valid);
        store_run(dst + plane, im, n_valid);
      }
    }
  }
#ifdef DCS_K1_PHASES
  if (tid == 0) {
    atomicAdd(&g_phase_clocks[0], static_cast<unsigned long long>(c1 - c0));
    atomicAdd(&g_phase_clocks[1], static_cast<unsigned long long>(c2 - c1));
    if (kLayout != 3)
      atomicAdd(&g_phase_clocks[2], static_cast<unsigned long long>(clock64() - c2));
  }
#endif
}

template <int kLayout>
int launch(const Params& p, dim3 grid, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      fengine_kernel<kLayout>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (kLayout == 3) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, fengine_kernel<kLayout>, p);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    fengine_kernel<kLayout><<<grid, kThreads, smem, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point (bound with ctypes).  Pointers are device pointers:
// `hist` (S, n_hist, M) and `chunk` (S, n_chunk, M) int8, 16-byte aligned
// (one stream: `hist` is the whole frame array and n_chunk = 0); `window`
// (taps, M) float32; `split_tw` (N,) and `pass_tw` the complex float32 tables
// of ops/fengine_fused.py:fft_plan; `frac` and `phase` both null (no rotation)
// or both (S, n_out) float32; `gains` (K, 2) float32 or null (float output).
// `layout` 0: `out` (S, n_out, K, 2), int8 with gains, float32 without;
// layout 1 (gains needed): `out` (K, 2, S, pitch) int8, spectra [n_out,
// pitch) of each row zeros (pitch >= n_out; the wire layout ignores it).  M
// is a power of two in [32, 8192], taps 1..16, S 1..65535.  Returns
// cudaGetLastError() after the launch.
extern "C" int dcs_fengine(const void* hist, const void* chunk, const void* window,
                           const void* split_tw, const void* pass_tw, const void* frac,
                           const void* phase, const void* gains, void* out,
                           int n_streams, int n_hist, int n_chunk, int n_out, int m,
                           int taps, int pad0, int layout, int pitch, void* stream) {
  if (m < 32 || (m & (m - 1)) || m / 2 > kMaxHalf || n_streams < 1 ||
      n_streams > 65535 || n_out < 1 || taps < 1 || taps > kMaxTaps || pad0 < 0 ||
      n_out - 1 + pad0 + taps > n_hist + n_chunk || (layout != 0 && layout != 1) ||
      (layout == 1 && (gains == nullptr || pitch < n_out)) ||
      (frac == nullptr) != (phase == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.hist = static_cast<const int8_t*>(hist);
  p.chunk = static_cast<const int8_t*>(chunk);
  p.window = static_cast<const float*>(window);
  p.split_tw = static_cast<const float2*>(split_tw);
  p.pass_tw = static_cast<const float2*>(pass_tw);
  p.frac = static_cast<const float*>(frac);
  p.phase = static_cast<const float*>(phase);
  p.gains = static_cast<const float2*>(gains);
  p.out = out;
  p.n_streams = n_streams;
  p.n_hist = n_hist;
  p.n_chunk = n_chunk;
  p.n_out = n_out;
  p.m = m;
  p.taps = taps;
  p.pad0 = pad0;
  p.pitch = layout == 1 ? pitch : n_out;
  p.groups = m / kCols < kThreads ? m / kCols : kThreads;
  p.subs = kThreads / p.groups;
  // the plan of fft_plan: radix-16 passes, then one of 2^(log2 N mod 4);
  // pass q's table holds (R - 1) Ns values when Ns > 1
  const int n_half = m / 2;
  int log2n = 0;
  while ((1 << log2n) < n_half) ++log2n;
  int ns = 1, off = 0;
  for (int left = log2n; left > 0; left -= 4) {
    const int r = 1 << (left < 4 ? left : 4);
    p.radix[p.n_pass] = r;
    p.tw_off[p.n_pass] = off;
    if (ns > 1) off += (r - 1) * ns;
    ns *= r;
    ++p.n_pass;
  }
  const int stride = n_half + n_half / 16;
  const int lo = phasor_lo(n_half);
  const size_t smem = static_cast<size_t>(p.subs) * kJ *
                      (stride + (frac != nullptr ? n_half / lo + lo : 0)) * sizeof(float2);
  const int tiles = (n_out + p.subs * kJ - 1) / (p.subs * kJ);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (gains == nullptr) return launch<2>(p, dim3(tiles, n_streams), smem, st);
  if (layout == 0) return launch<0>(p, dim3(tiles, n_streams), smem, st);
  // the operand layout: kCluster CTAs gather their tiles' kJ-byte runs into
  // runs of kCluster * kJ bytes (M >= 2048, one sub-tile a CTA), which
  // reach the pitch when it lies within the grid's last cluster
  const int clustered = (tiles + kCluster - 1) / kCluster * kCluster;
  if (pitch != n_out && (p.subs > 1 || pitch > clustered * kJ)) {
    // the pad spectra of every (k, c, stream) row, which the CMAC reads as
    // zeros
    const cudaError_t err = cudaMemset2DAsync(static_cast<int8_t*>(out) + n_out, pitch, 0,
                                              pitch - n_out,
                                              static_cast<size_t>(m) * n_streams, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (p.subs > 1) return launch<1>(p, dim3(tiles, n_streams), smem, st);
  return launch<3>(p, dim3(clustered, n_streams), smem, st);
}

#ifdef DCS_K1_PHASES
// The summed phase clocks of thread 0 of every CTA since the last call
// (which zeroes them), into clocks[kPhases].
extern "C" int dcs_fengine_phases(unsigned long long* clocks) {
  cudaError_t err = cudaMemcpyFromSymbol(clocks, g_phase_clocks, sizeof(g_phase_clocks));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[kPhases] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_phase_clocks, zero, sizeof(zero)));
}

// How many clusters of the cluster-gathered operand kernel the card runs at
// once at M, and its SMs (the product over the SMs is the share in use).
extern "C" int dcs_fengine_clusters(int m, int* clusters, int* sms) {
  const size_t smem = static_cast<size_t>(kJ) * (m / 2 + m / 32 + m / 128 + 64) *
                      sizeof(float2);
  cudaError_t err = cudaFuncSetAttribute(
      fengine_kernel<3>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1024, 1);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(clusters, fengine_kernel<3>, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0;
  cudaGetDevice(&dev);
  return static_cast<int>(cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev));
}
#endif
