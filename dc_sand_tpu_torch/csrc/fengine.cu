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
// 4.3 GB of device memory (1.3 ms).  A tile of kJ = 6 spectra of one stream
// is the unit of work: its FIR reads the whole window, 16 x 8192 float32 =
// 512 KB, and its 21 frames, 172 KB, from L2 (30.5 GB a chunk), and its six
// float32 spectra (6 x 4352 padded values, 208,896 bytes, and 6,144 bytes of
// phasor tables) fill shared memory, so one CTA of 512 threads runs on an
// SM.  Six spectra a window read is the most that fits; three would double
// the window's L2 traffic.  The first design (one CTA per spectrum, radix-2
// FFT, every operation an _rn intrinsic) took 46 ms a chunk on an H100 80GB
// HBM3 at 700 W; one-shot CTAs of one tile 14.1 ms (wire layout) and 17.1 ms
// (operand layout); this design 11.4 and 14.9 ms.  Its phases build
// (bench/k1_phases.py) splits a wire tile at fx64 into about 21,500 clocks
// of waiting for the FIR's loads, 16,800 of FIR arithmetic, 25,700 of FFT
// and 21,000 of epilogue.  The FIR's 684 KB a tile come through L1 at about
// 30 B a clock an SM.  A ring of frames in shared memory fed by asynchronous
// copies, overlapping a tile's loads with the previous tile's FFT, measured
// slower: beside the spectra shared memory holds less than a slice's frames,
// and every register a prefetch took spilled (PERF.md section 6).
//
//   * From M = 2048 (one tile a CTA) CTAs are persistent, as many as the
//     card holds at once (the occupancy or cluster query, made once per card,
//     kernel and shared-memory size, so a CUDA graph's capture sees none of
//     it), and walk the tiles: CTA b takes tiles b, b + G, b + 2G, ... of the
//     grid's G, so the tiles in flight at once are neighbours that share
//     frames in L2 (ops/fengine_fused.py:k1_tiles models the walk).  The
//     kernel is built for each M, so every size and offset of the tile is a
//     constant.  Loop-invariant loads and addresses would be hoisted out of
//     the walk and spilled: the pointers they come from are made anew for
//     each tile or slice (fresh).
//   * FIR as K6 does it (csrc/pfb.cu): a thread holds the weights of 4
//     consecutive columns in registers for a column slice, walks the tile's
//     kJ + taps - 1 frames once (each byte converted once, by the exponent
//     trick, not I2F), FMA into kJ x 4 accumulators and stores them into the
//     tile's spectra in shared memory.
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
//     share a GPC, so 15 clusters (120 of the 132 SMs) run at once; each
//     walks units of kCluster consecutive tiles.  The cluster's second
//     barrier (no CTA overwrites its stage while another reads it) is
//     arrived at after the gather and waited for in the next tile's FIR,
//     before its first store to the spectra.
//   * Below M = 2048 a tile holds P = 2048 / M sub-tiles of kJ spectra, so
//     every thread has work; one-shot CTAs (fengine_kernel_subtiles) run
//     it, each storing its operand runs itself.  No configuration runs it at
//     full width.
//   * M = 65536 (the MeerKAT 32k mode, fengine_wide_kernel): a spectrum's
//     32768 complex float32 values, 256 KB (272 KB padded), do not fit the
//     227 KB of shared memory a CTA may have, and the 16-tap window grows to
//     4 MB.  A cluster of 8 CTAs holds a tile of kJ spectra of one stream in
//     its distributed shared memory, each CTA an eighth of every spectrum:
//     it runs the FIR of its 8192 contiguous columns (K1's at fx64, so the
//     window and frames cross L2 once a tile, 30.6 GB at the 32k cell's
//     chunk against 30.5 at fx64's), the cluster a radix-16 pass over DSMEM
//     that leaves each CTA two sub-sequences whose bins mirror each other
//     (N - k), each CTA two 2048-point FFTs and the epilogue of its bins
//     from its own shared memory, and the int8 bins go over DSMEM to the CTA
//     that stores them as whole 16-byte words.  Its operand layout is the
//     wire output transposed by fengine_wide_operand: at this width the
//     cluster's shared memory holds one tile's spectra, with no room to
//     gather several tiles' runs as the M <= 8192 operand layout does.  Its
//     bound at the 32k cell's chunk (128 streams x 256 spectra) is 0.183
//     TFLOP, 2.72 ms.
//   * FMA and any summation order are allowed: the kernel is held to its
//     plain version within 1-LSB boundary flips (int8) and >= 100 dB (float),
//     not bitwise.  Both kernels sum each output's taps in the same order.
//
// Built with -DDCS_K1_PHASES (dc_sand_tpu_torch/bench/k1_phases.py) thread 0
// of every CTA adds the clocks of its phases to device counters that
// dcs_fengine_phases reads: the FIR's wait for each slice's loads (in that
// build the thread waits for all of them before its first multiply) apart
// from its arithmetic and stores, the FFT and the epilogue (in the
// cluster-gathered operand layout: its compute, the exchange through shared
// memory and the gather and store, the deferred cluster wait included).  At
// M = 65536 the six counters are the FIR's wait, the FIR, the two 2048-point
// FFTs, the epilogue with the phasor tables and the store, the exchanges across
// the cluster over DSMEM (the radix-16 pass and the int8 bins), and the waits
// at the cluster's barriers.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

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
constexpr int kPersistentM = kThreads * kCols;  // 2048: one sub-tile a CTA

#ifdef DCS_K1_PHASES
// fir_wait, fir, fft, epilogue, exchange, gather + store
constexpr int kPhases = 6;
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
  int tiles;               // tiles of a stream, ceil(n_out / (subs kJ))
  int n_pass;
  int radix[kMaxPasses];
  int tw_off[kMaxPasses];
};

__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }

// The tables the FFT and the epilogue read (Params' own, or the persistent
// kernel's copies of the pointers made anew for each tile).
struct Twiddles {
  const float2* split;  // W_M^k, k < N
  const float2* pass;   // Stockham pass twiddles
  const float2* gains;  // (K,) or null
};

// Four signed bytes -> four exact floats: byte b becomes the low mantissa
// byte of 2^23 + (b + 128), and subtracting 2^23 + 128 leaves b.
__device__ __forceinline__ void unpack4(uint32_t packed, float x[kCols]) {
  const uint32_t q = packed ^ 0x80808080u;
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    x[c] = __uint_as_float(__byte_perm(q, 0x4B000000u, 0x7440 | c)) - 8388736.0f;
}

// The FIR sums of a column slice: spectra jj < kJ of this thread's kCols
// columns from its frame words and taps (zeros past taps), each output's
// taps summed in order.
__device__ __forceinline__ void fir_sums(const uint32_t (&raw)[kFrames],
                                         const float (&w)[kMaxTaps][kCols],
                                         float (&acc)[kJ][kCols]) {
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
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

__device__ __forceinline__ int8_t quant(float v) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v), -127.0f), 127.0f));
}

// The pointer, as a value the compiler cannot see through: addresses and
// loads made from it inside a loop are not hoisted out of the loop, where
// they would hold registers through it (the FIR's 21 row addresses, a
// tile's twiddles and gains) and spill.
template <typename T>
__device__ __forceinline__ T* fresh(T* ptr) {
  asm volatile("" : "+l"(ptr));
  return ptr;
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

// The FFT of the CTA's n_spec spectra, Stockham passes in place.
__device__ __forceinline__ void fft(const Params& p, const Twiddles& tw, float2* z, int stride,
                                    int n_half, int n_spec) {
  int ns = 1;
  for (int q = 0; q < p.n_pass; ++q) {
    const int r = p.radix[q];
    const float2* t = tw.pass + p.tw_off[q];
    if (r == 16) fft_pass<16>(z, stride, n_half, ns, t, n_spec);
    else if (r == 8) fft_pass<8>(z, stride, n_half, ns, t, n_spec);
    else if (r == 4) fft_pass<4>(z, stride, n_half, ns, t, n_spec);
    else fft_pass<2>(z, stride, n_half, ns, t, n_spec);
    ns *= r;
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
__host__ __device__ constexpr int phasor_per(int n_half) {
  return n_half / phasor_lo(n_half) + phasor_lo(n_half);
}

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
// sub-tile (zsub; rows row0 ...; phasor tables tab, or null): layout 2
// stores the float values, the int8 layouts get them back packed, spectrum
// jj's at bits 8 jj.
template <int kLayout>
__device__ __forceinline__ void epilogue_bin(const Params& p, const Twiddles& tw,
                                             const float2* zsub,
                                             int stride, int n_half, int k,
                                             int n_valid, size_t row0,
                                             const float2* tab,
                                             unsigned long long& re,
                                             unsigned long long& im) {
  const float2 wk = __ldg(tw.split + k);
  const float2 gk = kLayout == 2 ? make_float2(0.0f, 0.0f) : __ldg(tw.gains + k);
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

// The epilogue of a CTA's subs sub-tiles (n_spec spectra from spectrum j_cta
// of stream s) for the layouts that store per CTA: 0 wire int8, 1 operand
// int8, 2 wire float32; the phasor tables tab (or null) of their spectra.
template <int kLayout>
__device__ __forceinline__ void epilogue_store(const Params& p, const Twiddles& tw,
                                               const float2* z, int stride,
                                               int n_half, int s, int j_cta, int n_spec,
                                               const float2* tab) {
  const int per = phasor_per(n_half);
  for (int it = threadIdx.x; it < p.subs * n_half; it += kThreads) {
    const int sub = it / n_half;
    const int k = it & (n_half - 1);
    const int n_valid = min(kJ, n_spec - sub * kJ);
    if (n_valid <= 0) continue;
    const size_t row0 = static_cast<size_t>(s) * p.n_out + j_cta + sub * kJ;
    unsigned long long re, im;
    epilogue_bin<kLayout>(p, tw, z + static_cast<size_t>(sub * kJ) * stride, stride, n_half, k,
                          n_valid, row0, tab == nullptr ? nullptr : tab + sub * kJ * per, re,
                          im);
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

// ---------------------------------------------------------------------------
// M < 2048: one-shot CTAs, each a tile of subs sub-tiles read from L2.
// kLayout: 0 wire int8, 1 operand int8 stored by each CTA, 2 wire float32.
template <int kLayout>
__global__ void __launch_bounds__(kThreads, 1)
fengine_kernel_subtiles(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float2 z[];  // subs * kJ spectra of N (+ N/16 pad) values
  DCS_CLOCK(c0);
  const int m = p.m;
  const int n_half = m >> 1;
  const int stride = n_half + (n_half >> 4);
  const int s = blockIdx.y;
  const int j_cta = blockIdx.x * p.subs * kJ;
  const int n_spec = min(p.subs * kJ, p.n_out - j_cta);
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
      fir_sums(raw, w, acc);
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
  const Twiddles tw = {p.split_tw, p.pass_tw, p.gains};
  fft(p, tw, z, stride, n_half, n_spec);
  DCS_CLOCK(c2);
  float2* tab = nullptr;  // the phasor tables, after the spectra
  if (p.frac != nullptr) {
    tab = z + static_cast<size_t>(p.subs) * kJ * stride;
    phasor_tables(p, tab, n_half, static_cast<size_t>(s) * p.n_out + j_cta, n_spec);
    __syncthreads();
  }
  epilogue_store<kLayout>(p, tw, z, stride, n_half, s, j_cta, n_spec, tab);
#ifdef DCS_K1_PHASES
  if (tid == 0) {
    atomicAdd(&g_phase_clocks[1], static_cast<unsigned long long>(c1 - c0));
    atomicAdd(&g_phase_clocks[2], static_cast<unsigned long long>(c2 - c1));
    atomicAdd(&g_phase_clocks[3], static_cast<unsigned long long>(clock64() - c2));
  }
#endif
}

// ---------------------------------------------------------------------------
// M >= 2048: persistent CTAs, one tile of kJ spectra at a time.

// The tile (stream s, first spectrum j) of a CTA's step i; false past the
// end of the walk.  Layout 3: cluster c of C takes units v = c, c + C, ... of
// (stream, group of kCluster consecutive tiles), its CTA of rank r the
// group's tile r (past the stream's tiles: a tile of no spectra, whose runs
// are zeros).  Else CTA b of G takes tiles u = b, b + G, ... of the (stream,
// tile) order.  ops/fengine_fused.py:k1_tiles is the same walk.
template <int kLayout>
__device__ __forceinline__ bool walk_tile(const Params& p, int i, int& s, int& j) {
  if constexpr (kLayout == 3) {
    const int groups = (p.tiles + kCluster - 1) / kCluster;
    const int v = static_cast<int>(blockIdx.x) / kCluster + i * (gridDim.x / kCluster);
    if (v >= p.n_streams * groups) return false;
    s = v / groups;
    j = ((v - s * groups) * kCluster + static_cast<int>(blockIdx.x) % kCluster) * kJ;
  } else {
    const int u = static_cast<int>(blockIdx.x) + i * static_cast<int>(gridDim.x);
    if (u >= p.n_streams * p.tiles) return false;
    s = u / p.tiles;
    j = (u - s * p.tiles) * kJ;
  }
  return true;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// kLayout: 0 wire int8, 2 wire float32, 3 operand int8 gathered by a cluster
// of kCluster CTAs; kM the FFT size M (2048, 4096 or 8192), so that every
// size and offset of the tile is a constant.
template <int kLayout, int kM>
__global__ void __launch_bounds__(kThreads, 1)
fengine_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float2 z[];  // kJ spectra of N (+ N/16 pad) values, the tables
  constexpr int kN = kM / 2;
  constexpr int kStride = kN + kN / 16;
  constexpr int kSlice = kCols * kThreads;  // FIR columns a slice
  const int tid = threadIdx.x;
#ifdef DCS_K1_PHASES
  unsigned long long ticks[kPhases] = {};
#endif
  bool deferred = false;  // layout 3: the last tile's second cluster barrier, not yet waited
  int s, j;
#pragma unroll 1
  for (int i = 0; walk_tile<kLayout>(p, i, s, j); ++i) {
    const int n_spec = min(kJ, p.n_out - j);  // <= 0: a cluster's padding tile
    const int f0 = j + p.pad0;
    const int nf = n_spec + p.taps - 1;
    const int8_t* hist = fresh(p.hist) + (static_cast<long long>(s) * p.n_hist + f0) * kM;
    const int8_t* chunk =
        fresh(p.chunk) + (static_cast<long long>(s) * p.n_chunk + f0 - p.n_hist) * kM;
    const int split = p.n_hist - f0;  // the tile's rows [0, split) lie in hist

    // 1. FIR, column slice by column slice: this thread's kCols columns of
    // the window and of the tile's frames, then its kJ x kCols sums.
    DCS_CLOCK(c_fir);
#ifdef DCS_K1_PHASES
    unsigned long long fir_waits = 0;  // this tile's waits, counted apart from its FIR
#endif
#pragma unroll 1
    for (int n0 = kCols * tid; n_spec > 0 && n0 < kM; n0 += kSlice) {
      DCS_CLOCK(c0);
      float w[kMaxTaps][kCols];
      const float* window = fresh(p.window) + n0;
#pragma unroll
      for (int t = 0; t < kMaxTaps; ++t) {
        const float4 v = t < p.taps ? __ldg(reinterpret_cast<const float4*>(window + t * kM))
                                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        w[t][0] = v.x; w[t][1] = v.y; w[t][2] = v.z; w[t][3] = v.w;
      }
      // (the rows' addresses made anew for each slice: hoisted out of the
      // slice loop, the compiler would keep 21 of them through it)
      const int8_t* hist_n = fresh(hist) + n0;
      const int8_t* chunk_n = fresh(chunk) + n0;
      uint32_t raw[kFrames];
#pragma unroll
      for (int f = 0; f < kFrames; ++f)
        raw[f] = f < nf ? __ldg(reinterpret_cast<const unsigned int*>(
                              (f < split ? hist_n : chunk_n) + f * kM))
                        : 0u;
#ifdef DCS_K1_PHASES
      {  // wait here for the slice's loads, to tell the wait from the arithmetic
        uint32_t sink = 0;
#pragma unroll
        for (int f = 0; f < kFrames; ++f) sink ^= raw[f];
#pragma unroll
        for (int t = 0; t < kMaxTaps; ++t)
#pragma unroll
          for (int c = 0; c < kCols; ++c) sink ^= __float_as_uint(w[t][c]);
        asm volatile("" ::"r"(sink));
        const unsigned long long waited = clock64() - c0;
        ticks[0] += waited;
        fir_waits += waited;
      }
#endif
      float acc[kJ][kCols];
      fir_sums(raw, w, acc);
      if constexpr (kLayout == 3) {
        if (deferred) {
          // no CTA of the cluster still reads this CTA's stage
          DCS_CLOCK(c1);
          cluster_wait();
          deferred = false;
#ifdef DCS_K1_PHASES
          ticks[5] += clock64() - c1;
          fir_waits += clock64() - c1;
#endif
        }
      }
      const int i0 = n0 >> 1;
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        if (jj < n_spec) {
          z[jj * kStride + pad(i0)] = make_float2(acc[jj][0], acc[jj][1]);
          z[jj * kStride + pad(i0 + 1)] = make_float2(acc[jj][2], acc[jj][3]);
        }
      }
    }
    if constexpr (kLayout == 3) {
      if (deferred) {  // a tile of no spectra ran no FIR
        cluster_wait();
        deferred = false;
      }
    }
    __syncthreads();
    DCS_CLOCK(c2);

    // 2. FFT.
    const Twiddles tw = {fresh(p.split_tw), fresh(p.pass_tw), fresh(p.gains)};
    fft(p, tw, z, kStride, kN, n_spec);
    DCS_CLOCK(c3);

    // 3-5. Split, phasor, gain, rounding and the store.
    float2* tab = nullptr;  // the phasor tables, after the spectra
    if (p.frac != nullptr) {
      tab = z + kJ * kStride;
      phasor_tables(p, tab, kN, static_cast<size_t>(s) * p.n_out + j, n_spec);
      __syncthreads();
    }
    if constexpr (kLayout == 3) {
      const int n_valid = min(kJ, n_spec);
      const size_t row0 = static_cast<size_t>(s) * p.n_out + j;
      constexpr int kItems = kN / kThreads;
      unsigned long long kr[kItems], ki[kItems];
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        const int k = tid + it * kThreads;
        kr[it] = ki[it] = 0;
        if (n_valid > 0)
          epilogue_bin<kLayout>(p, tw, z, kStride, kN, k, n_valid, row0, tab, kr[it], ki[it]);
      }
      __syncthreads();  // the spectra are read: their space takes the stage
      DCS_CLOCK(c4);
      unsigned long long* stage = reinterpret_cast<unsigned long long*>(z);
#pragma unroll
      for (int it = 0; it < kItems; ++it) {
        const int k = tid + it * kThreads;
        stage[2 * k] = kr[it];
        stage[2 * k + 1] = ki[it];
      }
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();
      DCS_CLOCK(c5);
      // rank r stores rows (k, c) [r, r + 1) * 2N / kCluster of the cluster's
      // kCluster * kJ spectra, gathered from every CTA's stage
      constexpr int kWords = kCluster * kJ / 8;
      const int rank = static_cast<int>(cluster.block_rank());
      const int j_clu = j - rank * kJ;
      // the run of a row this cluster stores: its spectra, and past n_out the
      // pad's zeros up to the pitch (the stages hold zeros past n_out)
      const int n_clu = min(kCluster * kJ, p.pitch - j_clu);
      constexpr int kPerRank = 2 * kN / kCluster;
      const size_t plane = static_cast<size_t>(p.n_streams) * p.pitch;
      for (int row = rank * kPerRank + tid; row < (rank + 1) * kPerRank; row += kThreads) {
        unsigned long long run[kWords] = {};
#pragma unroll
        for (int q = 0; q < kCluster; ++q) {
          const unsigned long long piece = cluster.map_shared_rank(stage, q)[row];
          const int off = q * kJ;
          run[off / 8] |= piece << (8 * (off % 8));
          if (off % 8 + kJ > 8 && off / 8 + 1 < kWords)
            run[off / 8 + 1] |= piece >> (8 * (8 - off % 8));
        }
        int8_t* dst = static_cast<int8_t*>(p.out) + static_cast<size_t>(row) * plane +
                      static_cast<size_t>(s) * p.pitch + j_clu;
        if (n_clu == kCluster * kJ && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
#pragma unroll
          for (int q = 0; q < kCluster * kJ / 16; ++q)
            reinterpret_cast<ulonglong2*>(dst)[q] = make_ulonglong2(run[2 * q], run[2 * q + 1]);
        } else {
#pragma unroll
          for (int q = 0; q < kWords; ++q)
            if (8 * q < n_clu) store_run(dst + 8 * q, run[q], min(8, n_clu - 8 * q));
        }
      }
      // this CTA has read every stage it needs; the next tile's FIR waits for
      // the cluster before its first store to the spectra
      cluster_arrive();
      deferred = true;
#ifdef DCS_K1_PHASES
      ticks[3] += c4 - c3;
      ticks[4] += c5 - c4;
      ticks[5] += clock64() - c5;
#endif
    } else {
      epilogue_store<kLayout>(p, tw, z, kStride, kN, s, j, n_spec, tab);
      __syncthreads();  // the spectra are read before the next tile's FIR stores
#ifdef DCS_K1_PHASES
      ticks[3] += clock64() - c3;
#endif
    }
#ifdef DCS_K1_PHASES
    ticks[1] += c2 - c_fir - fir_waits;
    ticks[2] += c3 - c2;
#endif
  }
  if constexpr (kLayout == 3) {
    if (deferred) cluster_wait();  // no CTA leaves while another reads its stage
  }
#ifdef DCS_K1_PHASES
  if (tid == 0)
    for (int q = 0; q < kPhases; ++q) atomicAdd(&g_phase_clocks[q], ticks[q]);
#endif
}

// ---------------------------------------------------------------------------
// M = 65536: a spectrum's N = 32768 values (256 KB) exceed one CTA's shared
// memory, so a cluster of kCluster CTAs holds a tile of kJ spectra of one
// stream, each CTA an eighth of each spectrum.  With n = n2 + 2048 q and
// k = k1 + 16 k2 (n2, k2 < 2048; q, k1 < 16):
//
//   X[k1 + 16 k2] = sum_n2 W_2048^(n2 k2) W_N^(n2 k1) sum_q W_16^(q k1) z[n2 + 2048 q]
//
// CTA r runs the FIR of the columns [8192 r, 8192 (r + 1)) of the tile's
// frames (K1's at fx64: the window and the frames cross L2 once a tile), so
// it holds z[4096 r ...], the sub-sequences q = 2r and 2r + 1, in its two
// slots.  The cluster runs the radix-16 DFT over q with the twiddle
// W_N^(n2 k1) over DSMEM: CTA r takes n2 in [256 r, 256 (r + 1)) and writes
// the sixteen results back to the places it read, so no value is
// overwritten before it is read.  Result k1 goes to CTA k1 (k1 < 8) or
// 16 - k1 (mod 8), slot k1 >= 8: CTA r holds k1 = r and 16 - r (CTA 0: 0 and
// 8), a bin's mirror N - k with it.  Each CTA runs K1's 2048-point FFT on
// its two slots, which leaves X[k1 + 16 k2] at k2, and the epilogue of its
// bins reads only its own shared memory.  Its int8 results go over DSMEM to
// the CTA whose 4096 wire bins [4096 r', 4096 (r' + 1)) hold them, 2 bytes
// a value, and each CTA stores its bins as 16-byte words.
constexpr int kWideM = 65536;
constexpr int kWideRadix = 16;                          // the pass across the cluster
constexpr int kWideSlot = kWideM / 2 / kWideRadix;      // 2048 values of a sub-sequence
constexpr int kWideSlotStride = kWideSlot + kWideSlot / 16;
constexpr int kWideStride = 2 * kWideSlotStride;        // a spectrum's two slots, padded
constexpr int kWideCols = kWideM / kCluster;            // 8192 FIR columns a CTA
constexpr int kWideBins = kWideM / 2 / kCluster;        // 4096 wire bins a CTA stores
constexpr int kWidePlanTw = 2032;  // the 2048-point plan's pass twiddles come first
constexpr int kWideLo = 64;        // phasor tables: k2 = 64 kh + kl
constexpr int kWideHi = kWideSlot / kWideLo;            // 32 values of kh
constexpr int kWideTab = 2 * kWideHi + kWideLo;         // table values a spectrum a CTA

// The sub-sequence k1 of slot `slot` of CTA `rank`, and back.
__device__ __forceinline__ int wide_k1(int rank, int slot) {
  return slot == 0 ? rank : rank == 0 ? 8 : kWideRadix - rank;
}
__device__ __forceinline__ int wide_owner(int k1) { return k1 < 8 ? k1 : (kWideRadix - k1) & 7; }

// The phasor tables of a CTA's bins k = k1 + 16 k2 (k1 of its two slots,
// k2 = 64 kh + kl) for its n_spec spectra: exp(i ((-(2 pi / M)) (k1 + 1024 kh)
// d - p)) for each slot's 32 values of kh, then exp(i (-(2 pi / M)) 16 kl d)
// for kl < 64.
__device__ __noinline__ void wide_phasor_tables(const Params& p, float2* tab, int rank,
                                                size_t row0, int n_spec) {
  const double scale = -6.283185307179586476925286766559 / kWideM;
  for (int e = threadIdx.x; e < n_spec * kWideTab; e += kThreads) {
    const int q = e / kWideTab, i = e - q * kWideTab;
    const double d = p.frac[row0 + q];
    double a;
    if (i < 2 * kWideHi) {
      const int k1 = wide_k1(rank, i / kWideHi);
      a = scale * (k1 + kWideRadix * kWideLo * (i % kWideHi)) * d - p.phase[row0 + q];
    } else {
      a = scale * kWideRadix * (i - 2 * kWideHi) * d;
    }
    double sn, cs;
    sincos(a, &sn, &cs);
    tab[e] = make_float2(static_cast<float>(cs), static_cast<float>(sn));
  }
}

// kLayout: 0 wire int8, 2 wire float32.  CTAs are persistent, in clusters of
// kCluster: cluster c of C takes the tiles (stream, kJ spectra) u = c, c + C,
// ... (ops/fengine_fused.py:k1_tiles, m = 65536).  `split_tw` and `gains`
// are in sub-sequence order, [k1][k2] (ops/fengine_fused.py:_tables).
template <int kLayout>
__global__ void __launch_bounds__(kThreads, 1)
fengine_wide_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) float2 z[];  // kJ spectra of two slots (+ pad), the tables
  constexpr int kN = kWideM / 2;
  constexpr int kSlice = kCols * kThreads;  // FIR columns a slice
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  float2* const tab = z + kJ * kWideStride;
#ifdef DCS_K1_PHASES
  unsigned long long ticks[kPhases] = {};
#endif
#pragma unroll 1
  for (int i = 0;; ++i) {
    const int u = static_cast<int>(blockIdx.x) / kCluster + i * (gridDim.x / kCluster);
    if (u >= p.n_streams * p.tiles) break;
    const int s = u / p.tiles;
    const int j = (u - s * p.tiles) * kJ;
    const int n_spec = min(kJ, p.n_out - j);
    const int f0 = j + p.pad0;
    const int nf = n_spec + p.taps - 1;
    const int8_t* hist =
        fresh(p.hist) + (static_cast<long long>(s) * p.n_hist + f0) * kWideM + rank * kWideCols;
    const int8_t* chunk = fresh(p.chunk) +
                          (static_cast<long long>(s) * p.n_chunk + f0 - p.n_hist) * kWideM +
                          rank * kWideCols;
    const int split = p.n_hist - f0;  // the tile's rows [0, split) lie in hist

    // 1. FIR of this CTA's columns, slice by slice, as the persistent kernel's.
    DCS_CLOCK(c_fir);
#ifdef DCS_K1_PHASES
    unsigned long long fir_waits = 0;
#endif
#pragma unroll 1
    for (int n0 = kCols * tid; n0 < kWideCols; n0 += kSlice) {
#ifdef DCS_K1_PHASES
      const long long c0 = clock64();
#endif
      float w[kMaxTaps][kCols];
      const float* window = fresh(p.window) + rank * kWideCols + n0;
#pragma unroll
      for (int t = 0; t < kMaxTaps; ++t) {
        const float4 v = t < p.taps ? __ldg(reinterpret_cast<const float4*>(window + t * kWideM))
                                    : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        w[t][0] = v.x; w[t][1] = v.y; w[t][2] = v.z; w[t][3] = v.w;
      }
      const int8_t* hist_n = fresh(hist) + n0;
      const int8_t* chunk_n = fresh(chunk) + n0;
      uint32_t raw[kFrames];
#pragma unroll
      for (int f = 0; f < kFrames; ++f)
        raw[f] = f < nf ? __ldg(reinterpret_cast<const unsigned int*>(
                              (f < split ? hist_n : chunk_n) + f * kWideM))
                        : 0u;
#ifdef DCS_K1_PHASES
      {
        uint32_t sink = 0;
#pragma unroll
        for (int f = 0; f < kFrames; ++f) sink ^= raw[f];
#pragma unroll
        for (int t = 0; t < kMaxTaps; ++t)
#pragma unroll
          for (int c = 0; c < kCols; ++c) sink ^= __float_as_uint(w[t][c]);
        asm volatile("" ::"r"(sink));
        const unsigned long long waited = clock64() - c0;
        ticks[0] += waited;
        fir_waits += waited;
      }
#endif
      float acc[kJ][kCols];
      fir_sums(raw, w, acc);
      // column n of this CTA is value n / 2 of slot n / 4096
      const int i0 = (n0 >> 1) & (kWideSlot - 1);
      float2* zs = z + (n0 >> 12) * kWideSlotStride;
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        if (jj < n_spec) {
          zs[jj * kWideStride + pad(i0)] = make_float2(acc[jj][0], acc[jj][1]);
          zs[jj * kWideStride + pad(i0 + 1)] = make_float2(acc[jj][2], acc[jj][3]);
        }
      }
    }
    DCS_CLOCK(c2);
    cluster.sync();  // every CTA's eighth of the tile's spectra is in place
    DCS_CLOCK(c3);

    // 2a. The radix-16 DFT over q across the cluster, with its twiddles.
    {
      const int n2 = rank * (kWideSlot / kCluster) + (tid & (kWideSlot / kCluster - 1));
      const float2* cross = fresh(p.pass_tw) + kWidePlanTw + n2;
      float2 tw[kWideRadix];
      tw[0] = make_float2(1.0f, 0.0f);
#pragma unroll
      for (int r = 1; r < kWideRadix; ++r) tw[r] = __ldg(cross + (r - 1) * kWideSlot);
      float2* peer[kCluster];
#pragma unroll
      for (int q = 0; q < kCluster; ++q) peer[q] = cluster.map_shared_rank(z, q) + pad(n2);
      // 1536 butterflies: this thread's n2 in spectra jj = tid / 256, + 2, + 4
#pragma unroll 1
      for (int jj = tid / (kWideSlot / kCluster); jj < n_spec;
           jj += kThreads / (kWideSlot / kCluster)) {
        float2 x[kWideRadix];
#pragma unroll
        for (int q = 0; q < kWideRadix; ++q)
          x[q] = peer[q >> 1][jj * kWideStride + (q & 1) * kWideSlotStride];
        dft<kWideRadix>(x);
#pragma unroll
        for (int r = 1; r < kWideRadix; ++r) x[r] = cmul(x[r], tw[r]);
#pragma unroll
        for (int r = 0; r < kWideRadix; ++r)
          peer[wide_owner(r)][jj * kWideStride + (r >= 8) * kWideSlotStride] = x[r];
      }
    }
    DCS_CLOCK(c4);
    cluster.sync();  // each CTA holds its two twiddled sub-sequences
    DCS_CLOCK(c5);

    // 2b. The 2048-point FFT of each slot: fft_plan(2048), the slots as
    // 2 n_spec spectra of their own.
    {
      const float2* plan = fresh(p.pass_tw);
      fft_pass<16>(z, kWideSlotStride, kWideSlot, 1, plan, 2 * n_spec);
      fft_pass<16>(z, kWideSlotStride, kWideSlot, 16, plan, 2 * n_spec);
      fft_pass<8>(z, kWideSlotStride, kWideSlot, 256, plan + 240, 2 * n_spec);
    }
    DCS_CLOCK(c6);
    if (p.frac != nullptr) {
      wide_phasor_tables(p, tab, rank, static_cast<size_t>(s) * p.n_out + j, n_spec);
      __syncthreads();
    }

    // 3-5. Split, phasor, gain and rounding of the bins k = k1 + 16 k2 of this
    // thread's slot, k2 = tid % 256 + 256 e: X[k] at k2 of the slot, X[N - k]
    // at k2' of the slot of k1' (N - k = k1' + 16 k2'), both here.
    const int slot = tid / (kWideSlot / kCluster);
    const int k1 = wide_k1(rank, slot);
    const int k1b = (kWideRadix - k1) & (kWideRadix - 1);
    const int lane2 = tid & (kWideSlot / kCluster - 1);
    uint32_t res[kCluster][kJ / 2];  // [e][jj / 2]: (re, im) of spectra jj, jj + 1
    {
      const size_t row0 = static_cast<size_t>(s) * p.n_out + j;
      const float2* za = z + slot * kWideSlotStride;
      const float2* zb = z + (k1b >= 8) * kWideSlotStride;
      const float2* split_tw = fresh(p.split_tw) + k1 * kWideSlot;
      const float2* gains = fresh(p.gains) + k1 * kWideSlot;
      const float2* th = tab + slot * kWideHi;
      const float2* tl = tab + 2 * kWideHi;
#pragma unroll
      for (int e = 0; e < kCluster; ++e) {
        const int k2 = lane2 + e * (kWideSlot / kCluster);
        const int k = k1 + kWideRadix * k2;
        const int k2b = ((kN - k) & (kN - 1)) >> 4;
        const float2 wk = __ldg(split_tw + k2);
        const float2 gk = kLayout == 2 ? make_float2(0.0f, 0.0f) : __ldg(gains + k2);
#pragma unroll
        for (int q = 0; q < kJ / 2; ++q) res[e][q] = 0u;
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          if (jj < n_spec) {
            const float2 a = za[jj * kWideStride + pad(k2)];
            const float2 b = zb[jj * kWideStride + pad(k2b)];
            const float2 ev = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
            const float2 od = make_float2(0.5f * (a.y + b.y), -0.5f * (a.x - b.x));
            const float2 wo = cmul(wk, od);
            float2 v = make_float2(ev.x + wo.x, ev.y + wo.y);
            if (p.frac != nullptr)
              v = cmul(v, cmul(th[jj * kWideTab + (k2 >> 6)], tl[jj * kWideTab + (k2 & 63)]));
            if constexpr (kLayout == 2) {
              reinterpret_cast<float2*>(p.out)[(row0 + jj) * kN + k] = v;
            } else {
              v = cmul(v, gk);
              const uint32_t pair = static_cast<uint32_t>(static_cast<uint8_t>(quant(v.x))) |
                                    static_cast<uint32_t>(static_cast<uint8_t>(quant(v.y))) << 8;
              res[e][jj >> 1] |= pair << (16 * (jj & 1));
            }
          }
        }
      }
    }
    DCS_CLOCK(c7);
    cluster.sync();  // no CTA reads its spectra any more: they take the staging
    DCS_CLOCK(c8);
    // 6. The int8 bins to the CTA whose wire bins hold them, staged as
    // [jj][k1][k2 - 256 r'] (2 bytes each), then stored as 16-byte words.
    if constexpr (kLayout == 0) {
      constexpr int kStage = kWideBins * 2;  // bytes of a spectrum's staged bins
#pragma unroll
      for (int e = 0; e < kCluster; ++e) {
        uint16_t* dst = reinterpret_cast<uint16_t*>(cluster.map_shared_rank(z, e)) +
                        k1 * (kWideSlot / kCluster) + lane2;
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj)
          if (jj < n_spec)
            dst[jj * (kStage / 2)] = static_cast<uint16_t>(res[e][jj >> 1] >> (16 * (jj & 1)));
      }
    }
    DCS_CLOCK(c9);
    cluster.sync();  // this CTA's bins are staged
    DCS_CLOCK(c10);
    if constexpr (kLayout == 0) {
      constexpr int kStage = kWideBins * 2;
      const uint16_t* stage = reinterpret_cast<const uint16_t*>(z);
      const size_t row0 = static_cast<size_t>(s) * p.n_out + j;
      const int b0 = kCluster * tid;  // this thread's 8 bins of the CTA's 4096
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        if (jj < n_spec) {
          uint32_t wd[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int b = b0 + 2 * q;
            wd[q] = static_cast<uint32_t>(
                        stage[jj * (kStage / 2) + (b & 15) * (kWideSlot / kCluster) + (b >> 4)]) |
                    static_cast<uint32_t>(stage[jj * (kStage / 2) + ((b + 1) & 15) *
                                                    (kWideSlot / kCluster) + ((b + 1) >> 4)])
                        << 16;
          }
          *reinterpret_cast<uint4*>(static_cast<int8_t*>(p.out) +
                                    ((row0 + jj) * kN + rank * kWideBins + b0) * 2) =
              make_uint4(wd[0], wd[1], wd[2], wd[3]);
        }
      }
    }
    __syncthreads();  // the staged bins are read before the next tile's FIR stores
#ifdef DCS_K1_PHASES
    ticks[1] += c2 - c_fir - fir_waits;
    ticks[4] += (c4 - c3) + (c9 - c8);
    ticks[2] += c6 - c5;
    ticks[3] += (c7 - c6) + (clock64() - c10);
    ticks[5] += (c3 - c2) + (c5 - c4) + (c8 - c7) + (c10 - c9);
#endif
  }
#ifdef DCS_K1_PHASES
  if (tid == 0)
    for (int q = 0; q < kPhases; ++q) atomicAdd(&g_phase_clocks[q], ticks[q]);
#endif
}

// The operand layout of the wire output at M = 65536: (S, n_out, 2K) int8 ->
// (2K, S, pitch), zeros in spectra [n_out, pitch).  A CTA transposes a tile of
// kTileB spectra by kTileR rows (k, c) of one stream through shared memory:
// 16-byte loads along the rows, a thread's 4 rows by 16 spectra transposed in
// registers (4 x 4 byte blocks by __byte_perm) and stored as 16-byte words, 4
// threads a row's 64 bytes.  It reads and writes the output's bytes once each
// (4.3 GB at the 32k cell's chunk, 1.3 ms at the card's 3.35 TB/s).
constexpr int kTileB = 64;
constexpr int kTileR = 128;
constexpr int kTileThreads = 128;
constexpr int kTileWords = kTileR / 4 + 1;  // a spectrum's words in the tile, padded by one

__global__ void __launch_bounds__(kTileThreads)
fengine_wide_operand(const int8_t* __restrict__ wire, int8_t* __restrict__ out, int n_streams,
                     int n_out, int rows, int pitch) {
  __shared__ uint32_t tile[kTileB][kTileWords];
  const int r0 = blockIdx.x * kTileR;
  const int b0 = blockIdx.y * kTileB;
  const int s = blockIdx.z;
  constexpr int kVecs = kTileR / 16;  // 16-byte words of a spectrum's row of the tile
  for (int e = threadIdx.x; e < kTileB * kVecs; e += kTileThreads) {
    const int b = e / kVecs, q = e - b * kVecs;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (b0 + b < n_out)
      v = __ldg(reinterpret_cast<const uint4*>(
                    wire + (static_cast<size_t>(s) * n_out + b0 + b) * rows + r0) +
                q);
    tile[b][4 * q] = v.x;
    tile[b][4 * q + 1] = v.y;
    tile[b][4 * q + 2] = v.z;
    tile[b][4 * q + 3] = v.w;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int bg = lane & 3;                             // spectra [16 bg, 16 bg + 16)
  const int rg = (threadIdx.x >> 5) * 8 + (lane >> 2);  // rows [4 rg, 4 rg + 4)
  uint32_t o[4][4];                                     // [row][4 spectra]
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int b = 16 * bg + 4 * q;
    const uint32_t w0 = tile[b][rg], w1 = tile[b + 1][rg], w2 = tile[b + 2][rg],
                   w3 = tile[b + 3][rg];
    const uint32_t t0 = __byte_perm(w0, w1, 0x5140), t1 = __byte_perm(w0, w1, 0x7362);
    const uint32_t t2 = __byte_perm(w2, w3, 0x5140), t3 = __byte_perm(w2, w3, 0x7362);
    o[0][q] = __byte_perm(t0, t2, 0x5410);
    o[1][q] = __byte_perm(t0, t2, 0x7632);
    o[2][q] = __byte_perm(t1, t3, 0x5410);
    o[3][q] = __byte_perm(t1, t3, 0x7632);
  }
  const int b = b0 + 16 * bg;
  if (b >= pitch) return;
  const int n = min(16, pitch - b);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    int8_t* dst = out + (static_cast<size_t>(r0 + 4 * rg + c) * n_streams + s) * pitch + b;
    if (n == 16 && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(o[c][0], o[c][1], o[c][2], o[c][3]);
    } else {
      for (int i = 0; i < n; ++i) dst[i] = static_cast<int8_t>(o[c][i >> 2] >> (8 * (i & 3)));
    }
  }
}

// The CTAs of a kernel that the card holds at once at a shared-memory size
// (clusters times kCluster for layout 3), found once per card, kernel and
// size; the first call on a card also lets the kernel use the card's whole
// opt-in shared memory.  The occupancy and cluster queries and the attribute
// are not per launch: a CUDA graph's capture sees none of them once a call
// has run.
template <typename Kernel>
cudaError_t resident_ctas(Kernel kernel, int cluster, size_t smem, int* ctas) {
  struct Entry {
    const void* fn;
    int dev;
    size_t smem;
    int ctas;
  };
  static std::mutex mu;
  static Entry cache[32];
  static int n_cache = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  bool attr_set = false;
  for (int i = 0; i < n_cache; ++i) {
    if (cache[i].fn != fn || cache[i].dev != dev) continue;
    attr_set = true;
    if (cache[i].smem == smem) {
      *ctas = cache[i].ctas;
      return cudaSuccess;
    }
  }
  if (!attr_set) {
    cudaFuncAttributes attr;
    int optin = 0;
    if ((err = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess) return err;
    if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
        cudaSuccess)
      return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               optin - static_cast<int>(attr.sharedSizeBytes));
    if (err != cudaSuccess) return err;
  }
  int n = 0;
  if (cluster > 1) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster * 64);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute a[1];
    a[0].id = cudaLaunchAttributeClusterDimension;
    a[0].val.clusterDim.x = cluster;
    a[0].val.clusterDim.y = 1;
    a[0].val.clusterDim.z = 1;
    cfg.attrs = a;
    cfg.numAttrs = 1;
    if ((err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg)) != cudaSuccess) return err;
    n *= cluster;
  } else {
    int per_sm = 0, sms = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
        cudaSuccess)
      return err;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
      return err;
    n = per_sm * sms;
  }
  if (n < cluster) return cudaErrorInvalidConfiguration;  // the kernel fits nowhere
  if (n_cache < 32) cache[n_cache++] = {fn, dev, smem, n};
  *ctas = n;
  return cudaSuccess;
}

// The persistent kernel's shared memory: the spectra and the phasor tables.
size_t persistent_smem(int m, bool rotate) {
  const int n_half = m / 2;
  return static_cast<size_t>(kJ) * (n_half + n_half / 16 + (rotate ? phasor_per(n_half) : 0)) *
         sizeof(float2);
}

// The persistent kernel of layout L for M = 2048, 4096 or 8192.
template <int kLayout>
void (*persistent_kernel(int m))(Params) {
  if (m == 2048) return fengine_kernel<kLayout, 2048>;
  if (m == 4096) return fengine_kernel<kLayout, 4096>;
  return fengine_kernel<kLayout, 8192>;
}

// The grid of a persistent kernel for a call of `units` units of `cluster`
// CTAs each: as many whole clusters as the card holds, no more than there
// are units.
cudaError_t fill_grid(void (*kernel)(Params), int cluster, size_t smem, long long units,
                      int* grid) {
  int ctas = 0;
  const cudaError_t err = resident_ctas(kernel, cluster, smem, &ctas);
  if (err != cudaSuccess) return err;
  *grid = static_cast<int>(units < ctas / cluster ? units : ctas / cluster) * cluster;
  return cudaSuccess;
}

// Launch `kernel` on `grid` CTAs in clusters of `cluster` (1: no cluster).
int launch_grid(void (*kernel)(Params), int grid, int cluster, size_t smem, const Params& p,
                cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The grid of the persistent kernel of layout L (0, 2, 3) for a call: as
// many CTAs as the card holds (whole clusters in layout 3), no more than the
// call has units.
template <int kLayout>
cudaError_t persistent_grid(const Params& p, size_t smem, int* grid) {
  const int cluster = kLayout == 3 ? kCluster : 1;
  return fill_grid(persistent_kernel<kLayout>(p.m), cluster, smem,
                   static_cast<long long>(p.n_streams) * ((p.tiles + cluster - 1) / cluster),
                   grid);
}

template <int kLayout>
int launch_persistent(const Params& p, size_t smem, cudaStream_t st) {
  int grid = 0;
  const cudaError_t err = persistent_grid<kLayout>(p, smem, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_grid(persistent_kernel<kLayout>(p.m), grid, kLayout == 3 ? kCluster : 1, smem, p,
                     st);
}

template <int kLayout>
int launch_subtiles(const Params& p, size_t smem, cudaStream_t st) {
  int unused = 0;  // (called for the kernel's shared-memory attribute)
  const cudaError_t err = resident_ctas(fengine_kernel_subtiles<kLayout>, 1, smem, &unused);
  if (err != cudaSuccess) return static_cast<int>(err);
  fengine_kernel_subtiles<kLayout><<<dim3(p.tiles, p.n_streams), kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The shared memory of the M = 65536 kernel: the tile's sub-sequences and
// the phasor tables.
size_t wide_smem(bool rotate) {
  return static_cast<size_t>(kJ) * (kWideStride + (rotate ? kWideTab : 0)) * sizeof(float2);
}

// The grid of the M = 65536 kernel (layout 0 or 2): as many whole clusters
// as the card holds, no more than the call has tiles.
template <int kLayout>
cudaError_t wide_grid(const Params& p, size_t smem, int* grid) {
  return fill_grid(fengine_wide_kernel<kLayout>, kCluster, smem,
                   static_cast<long long>(p.n_streams) * p.tiles, grid);
}

template <int kLayout>
int launch_wide(const Params& p, size_t smem, cudaStream_t st) {
  int grid = 0;
  const cudaError_t err = wide_grid<kLayout>(p, smem, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_grid(fengine_wide_kernel<kLayout>, grid, kCluster, smem, p, st);
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
// is a power of two in [32, 8192] (a spectrum in one CTA's shared memory), or
// 65536 (a spectrum across a cluster of 8 CTAs, wire layout only: its operand
// layout is dcs_fengine_operand of the wire output, and `pass_tw` holds the
// 4096-point plan's table, then the cluster's twiddles W_N^(n2 k1), k1 =
// 1..7, n2 < 4096), taps 1..16, S 1..65535.  Returns cudaGetLastError() after
// the launch.
extern "C" int dcs_fengine(const void* hist, const void* chunk, const void* window,
                           const void* split_tw, const void* pass_tw, const void* frac,
                           const void* phase, const void* gains, void* out,
                           int n_streams, int n_hist, int n_chunk, int n_out, int m,
                           int taps, int pad0, int layout, int pitch, void* stream) {
  const bool wide = m == kWideM;
  if (m < 32 || (m & (m - 1)) || (m / 2 > kMaxHalf && !wide) || n_streams < 1 ||
      n_streams > 65535 || n_out < 1 || taps < 1 || taps > kMaxTaps || pad0 < 0 ||
      n_out - 1 + pad0 + taps > n_hist + n_chunk || (layout != 0 && layout != 1) ||
      (layout == 1 && (gains == nullptr || pitch < n_out || wide)) ||
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
  p.tiles = (n_out + p.subs * kJ - 1) / (p.subs * kJ);
  if (wide) {
    const size_t smem = wide_smem(frac != nullptr);
    return gains == nullptr ? launch_wide<2>(p, smem, static_cast<cudaStream_t>(stream))
                            : launch_wide<0>(p, smem, static_cast<cudaStream_t>(stream));
  }
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool persistent = m >= kPersistentM;  // one sub-tile a CTA
  const size_t smem = persistent ? persistent_smem(m, frac != nullptr)
                                 : static_cast<size_t>(p.subs) * kJ *
                                       (n_half + n_half / 16 +
                                        (frac != nullptr ? phasor_per(n_half) : 0)) *
                                       sizeof(float2);
  if (gains == nullptr)
    return persistent ? launch_persistent<2>(p, smem, st) : launch_subtiles<2>(p, smem, st);
  if (layout == 0)
    return persistent ? launch_persistent<0>(p, smem, st) : launch_subtiles<0>(p, smem, st);
  // the operand layout: kCluster CTAs gather their tiles' kJ-byte runs into
  // runs of kCluster * kJ bytes (M >= 2048, one sub-tile a CTA), which
  // reach the pitch when it lies within the stream's last group of kCluster
  // tiles
  const int clustered = (p.tiles + kCluster - 1) / kCluster * kCluster;
  if (pitch != n_out && (!persistent || pitch > clustered * kJ)) {
    // the pad spectra of every (k, c, stream) row, which the CMAC reads as
    // zeros
    const cudaError_t err = cudaMemset2DAsync(static_cast<int8_t*>(out) + n_out, pitch, 0,
                                              pitch - n_out,
                                              static_cast<size_t>(m) * n_streams, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return persistent ? launch_persistent<3>(p, smem, st) : launch_subtiles<1>(p, smem, st);
}

// The grid the persistent kernel launches for a call of `dcs_fengine` (0
// below M = 2048, where one-shot CTAs run): CTAs, a multiple of the
// cluster's 8 in the operand layout and at M = 65536 (both layouts).
extern "C" int dcs_fengine_grid(int n_streams, int n_out, int m, int layout, int rotate,
                                int float_out, int* grid) {
  *grid = 0;
  if (m < kPersistentM) return 0;
  if (m & (m - 1) || (m / 2 > kMaxHalf && m != kWideM) || n_streams < 1 || n_out < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.n_streams = n_streams;
  p.n_out = n_out;
  p.m = m;
  p.tiles = (n_out + kJ - 1) / kJ;
  if (m == kWideM)  // both layouts: the operand layout is the wire kernel's
    return static_cast<int>(float_out ? wide_grid<2>(p, wide_smem(rotate != 0), grid)
                                      : wide_grid<0>(p, wide_smem(rotate != 0), grid));
  const size_t smem = persistent_smem(m, rotate != 0);
  cudaError_t err;
  if (float_out) err = persistent_grid<2>(p, smem, grid);
  else if (layout == 0) err = persistent_grid<0>(p, smem, grid);
  else err = persistent_grid<3>(p, smem, grid);
  return static_cast<int>(err);
}

// The operand layout (K, 2, S, pitch) of the wire output `wire` (S, n_out, K,
// 2) int8 at M = 65536 (K = 32768; any K a multiple of 64), zeros in spectra
// [n_out, pitch).  Returns cudaGetLastError() after the launch.
extern "C" int dcs_fengine_operand(const void* wire, void* out, int n_streams, int n_out,
                                   int n_chans, int pitch, void* stream) {
  const int rows = 2 * n_chans;
  if (n_streams < 1 || n_streams > 65535 || n_out < 1 || pitch < n_out || n_chans < 1 ||
      rows % kTileR || (pitch + kTileB - 1) / kTileB > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(rows / kTileR, (pitch + kTileB - 1) / kTileB, n_streams);
  fengine_wide_operand<<<grid, kTileThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(wire), static_cast<int8_t*>(out), n_streams, n_out, rows, pitch);
  return static_cast<int>(cudaGetLastError());
}

#ifdef DCS_K1_PHASES
// The summed phase clocks of thread 0 of every CTA since the last call (which
// zeroes them), into clocks[6]: fir_wait, fir, fft, epilogue, exchange,
// gather + store.
extern "C" int dcs_fengine_phases(unsigned long long* clocks) {
  cudaError_t err = cudaMemcpyFromSymbol(clocks, g_phase_clocks, sizeof(g_phase_clocks));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[kPhases] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_phase_clocks, zero, sizeof(zero)));
}
#endif
