// Fused F-engine kernel (K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel dc_sand_tpu/ops/fengine_fused.py:_kernel (launched
// by _launch_fused from fengine_fused / _fused_split).  It computes what that
// kernel computes, not its block plan (the bf16x3 stage-2 matmul, the
// identity-dot shifts and the native planes exist for the TPU's Mosaic
// compiler).  One CTA per (stream s, output spectrum j):
//
//   1. FIR:   y[n] = sum_t w[t, n] * x[j + pad0 + t, n] in float32, taps summed
//             in order t = 0 .. taps-1 (the JAX jnp arm's order).  Frame f of
//             the virtual stream [hist | chunk] comes from `hist` when
//             f < n_hist and from `chunk` otherwise.
//   2. FFT:   the M-point real FFT as an N = M/2 point complex FFT of the
//             packed even/odd samples z[n] = y[2n] + i y[2n+1]: bit-reversed
//             load, then log2(N) in-place radix-2 passes in shared memory.
//             Twiddles come from a table W_M^k = exp(-2 pi i k / M), k < N,
//             computed in float64 on the host and stored as float32.
//   3. Split: X[k] = E[k] + W_M^k O[k] for k < N = K (the Nyquist bin is
//             dropped, as golden/chain.py:channelize does).
//   4. Phase: theta = (-(2 pi / M) * k) * d_j - p_j in float32, accurate
//             sincosf (no fast math), X *= (cos, sin).
//   5. Quant (kQuant, gains given): X *= gain[k], rintf (round half to
//             even), saturate to [-127, 127] (never -128: the X-engine
//             negates int8 values), int8 wire layout (S, n_out, K, 2).
//             Without gains (the JAX package's float-output mode, config
//             pfb1k) X is stored as float32 (S, n_out, K, 2) instead.
//
// Every float multiply and add is an explicit _rn intrinsic, so nvcc cannot
// contract them into FMAs and the order of operations is the plain version's.
//
// What bounds it on the H100: at fx64 (M = 8192, 16 taps) each spectrum reads
// 16 int8 frames (128 KB) and the whole float32 window (512 KB) through L2
// for 8 KB of new input, and its FFT makes 12 passes over a 32 KB shared
// memory tile.  L2 and shared-memory traffic bound this kernel, not device
// memory (2.15 GB in and 2.15 GB out per chunk).  What the design does about
// it: no intermediate ever leaves the CTA (int8 in, int8 out, as the TPU
// kernel keeps its intermediates in VMEM); loads are 16 bytes a thread;
// neighbouring spectra of one stream run in neighbouring CTAs so their
// shared frames hit in L2.  A CTA that reuses frames and window across
// several spectra, and larger FFT radices, are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxHalf = 4096;  // N = M / 2 <= 4096, i.e. M <= 8192

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                     __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

__device__ __forceinline__ int8_t quant(float v) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(v), -127.0f), 127.0f));
}

template <bool kQuant, typename Out>
__global__ void __launch_bounds__(kMaxThreads)
fengine_kernel(const int8_t* __restrict__ hist, const int8_t* __restrict__ chunk,
               const float* __restrict__ window, const float2* __restrict__ tw,
               const float* __restrict__ frac, const float* __restrict__ phase,
               const float2* __restrict__ gains, Out* __restrict__ out,
               int n_hist, int n_chunk, int n_out, int m, int log2n, int taps,
               int pad0, float theta_scale) {
  extern __shared__ float2 z[];  // N complex values
  const int n_half = m >> 1;
  const int j = blockIdx.x;
  const int s = blockIdx.y;

  // 1. FIR, 16 samples (8 complex values) per thread and pass.
  for (int g = threadIdx.x; g < m / 16; g += blockDim.x) {
    const int n = 16 * g;
    float y[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) y[e] = 0.0f;
    for (int t = 0; t < taps; ++t) {
      const int f = j + pad0 + t;
      const int8_t* src =
          f < n_hist ? hist + (static_cast<size_t>(s) * n_hist + f) * m
                     : chunk + (static_cast<size_t>(s) * n_chunk + (f - n_hist)) * m;
      const int4 raw = __ldg(reinterpret_cast<const int4*>(src + n));
      const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
      const float4* wrow = reinterpret_cast<const float4*>(window + static_cast<size_t>(t) * m + n);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 w = __ldg(wrow + q);
        y[4 * q + 0] = __fadd_rn(y[4 * q + 0], __fmul_rn(w.x, static_cast<float>(x[4 * q + 0])));
        y[4 * q + 1] = __fadd_rn(y[4 * q + 1], __fmul_rn(w.y, static_cast<float>(x[4 * q + 1])));
        y[4 * q + 2] = __fadd_rn(y[4 * q + 2], __fmul_rn(w.z, static_cast<float>(x[4 * q + 2])));
        y[4 * q + 3] = __fadd_rn(y[4 * q + 3], __fmul_rn(w.w, static_cast<float>(x[4 * q + 3])));
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const unsigned i = static_cast<unsigned>(8 * g + e);
      z[__brev(i) >> (32 - log2n)] = make_float2(y[2 * e], y[2 * e + 1]);
    }
  }
  __syncthreads();

  // 2. In-place radix-2 decimation-in-time passes on the bit-reversed data.
  for (int stage = 1; stage <= log2n; ++stage) {
    const int half = 1 << (stage - 1);
    const int tw_stride = (n_half >> stage) << 1;  // W_N^e = W_M^(2e)
    for (int b = threadIdx.x; b < n_half / 2; b += blockDim.x) {
      const int pos = b & (half - 1);
      const int i0 = ((b >> (stage - 1)) << stage) + pos;
      const int i1 = i0 + half;
      const float2 u = z[i0];
      const float2 v = cmul(__ldg(tw + pos * tw_stride), z[i1]);
      z[i0] = make_float2(__fadd_rn(u.x, v.x), __fadd_rn(u.y, v.y));
      z[i1] = make_float2(__fsub_rn(u.x, v.x), __fsub_rn(u.y, v.y));
    }
    __syncthreads();
  }

  // 3-5. Real-FFT split, phasor, then gain and requantisation or the
  // float store.
  const size_t row = static_cast<size_t>(s) * n_out + j;
  const bool rotate = frac != nullptr;
  const float d = rotate ? frac[row] : 0.0f;
  const float p = rotate ? phase[row] : 0.0f;
  for (int k = threadIdx.x; k < n_half; k += blockDim.x) {
    const float2 a = z[k];
    const float2 b = z[(n_half - k) & (n_half - 1)];
    // E = (Z[k] + conj(Z[N-k])) / 2,  O = -i (Z[k] - conj(Z[N-k])) / 2
    const float2 e = make_float2(__fmul_rn(0.5f, __fadd_rn(a.x, b.x)),
                                 __fmul_rn(0.5f, __fsub_rn(a.y, b.y)));
    const float2 o = make_float2(__fmul_rn(0.5f, __fadd_rn(a.y, b.y)),
                                 __fmul_rn(-0.5f, __fsub_rn(a.x, b.x)));
    const float2 wo = cmul(__ldg(tw + k), o);
    float2 v = make_float2(__fadd_rn(e.x, wo.x), __fadd_rn(e.y, wo.y));
    if (rotate) {
      const float theta =
          __fsub_rn(__fmul_rn(__fmul_rn(theta_scale, static_cast<float>(k)), d), p);
      float sn, cs;
      sincosf(theta, &sn, &cs);
      v = cmul(v, make_float2(cs, sn));
    }
    if constexpr (kQuant) {
      v = cmul(v, __ldg(gains + k));
      out[row * n_half + k] = make_char2(quant(v.x), quant(v.y));
    } else {
      out[row * n_half + k] = v;
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Pointers are device pointers;
// `frac` and `phase` are both null (no rotation) or both valid, (S, n_out)
// float32; `gains` is (K, 2) float32 and `out` (S, n_out, K, 2) int8, or
// `gains` is null and `out` (S, n_out, K, 2) float32.
// Returns cudaGetLastError() after the launch.
extern "C" int dcs_fengine(const void* hist, const void* chunk, const void* window,
                           const void* twiddle, const void* frac, const void* phase,
                           const void* gains, void* out, int n_streams, int n_hist,
                           int n_chunk, int n_out, int m, int taps, int pad0,
                           float theta_scale, void* stream) {
  if (m < 32 || (m & (m - 1)) || m / 2 > kMaxHalf || n_streams < 1 ||
      n_streams > 65535 || n_out < 1 || taps < 1 ||
      n_out - 1 + pad0 + taps > n_hist + n_chunk)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_half = m / 2;
  int log2n = 0;
  while ((1 << log2n) < n_half) ++log2n;
  const int threads = n_half / 2 < kMaxThreads ? n_half / 2 : kMaxThreads;
  const size_t smem = static_cast<size_t>(n_half) * sizeof(float2);
  const dim3 grid(n_out, n_streams);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* h = static_cast<const int8_t*>(hist);
  const int8_t* c = static_cast<const int8_t*>(chunk);
  const float* w = static_cast<const float*>(window);
  const float2* t = static_cast<const float2*>(twiddle);
  const float* fd = static_cast<const float*>(frac);
  const float* ph = static_cast<const float*>(phase);
  const float2* g = static_cast<const float2*>(gains);
  if (g != nullptr)
    fengine_kernel<true><<<grid, threads, smem, st>>>(
        h, c, w, t, fd, ph, g, static_cast<char2*>(out), n_hist, n_chunk, n_out, m,
        log2n, taps, pad0, theta_scale);
  else
    fengine_kernel<false><<<grid, threads, smem, st>>>(
        h, c, w, t, fd, ph, g, static_cast<float2*>(out), n_hist, n_chunk, n_out, m,
        log2n, taps, pad0, theta_scale);
  return static_cast<int>(cudaGetLastError());
}
