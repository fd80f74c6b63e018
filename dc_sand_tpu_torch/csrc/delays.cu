// A chunk's delay terms for Hopper, sm_90a: one launch a chunk.
//
// The port's own kernel, not the port of a TPU kernel: the JAX package
// evaluates the delay polynomials on the host in numpy
// (dc_sand_tpu/runtime/delays.py, DelayModel.evaluate_chunk), and the
// runner used to do the same and copy the tables up each chunk.  Here the
// coefficients stay on the card and each chunk's terms are computed there.
//
// Per stream row s, with x = tr at the chunk's first sample and
// x = tr + (b + 0.5) * fft_size at the centre of spectrum b:
//
//   delay(x) = (d0 + d1*x) + (d2*x)*x      phase(x) = (p0 + p1*x) + (p2*x)*x
//   coarse   = clip(rint(delay(tr)), 0, max_delay)          int32 (S,)
//   frac     = float(delay(x_b) - coarse)                   float32 (S, B)
//   phase    = float(phase(x_b))                            float32 (S, B)
//
// Design.  The answer must be numpy's to the bit: every operation is a
// float64 intrinsic (__dmul_rn, __dadd_rn, __dsub_rn), which the compiler
// never contracts into an FMA, in numpy's order; rint rounds half to even
// as np.rint does, and __double2float_rn rounds as numpy's astype.  One
// thread a (row, spectrum); each recomputes its row's coarse delay, and the
// thread of spectrum 0 stores it.
//
// What bounds it on the H100: nothing of note.  At the fx64 chunk (128 rows,
// 2048 spectra) it writes 2.1 MB and does some 5 M float64 operations, a
// few microseconds; what it saves is the host's evaluation and the
// pageable upload, which waited for the previous chunk.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// (c0 + c1*x) + (c2*x)*x, as numpy evaluates c0 + c1 * x + c2 * x * x
__device__ __forceinline__ double quadratic(double c0, double c1, double c2, double x) {
  return __dadd_rn(__dadd_rn(c0, __dmul_rn(c1, x)), __dmul_rn(__dmul_rn(c2, x), x));
}

// grid (ceil(B / kThreads), S)
__global__ void __launch_bounds__(kThreads)
    delay_terms_kernel(const double* __restrict__ coef, long long s_total, double tr, int b_total,
                       int fft_size, int max_delay, int* __restrict__ coarse,
                       float* __restrict__ frac, float* __restrict__ phase) {
  const int s = blockIdx.y;
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= b_total) return;
  const double d0 = coef[s], d1 = coef[s_total + s], d2 = coef[2 * s_total + s];
  const double p0 = coef[3 * s_total + s], p1 = coef[4 * s_total + s],
               p2 = coef[5 * s_total + s];
  const double c = fmin(fmax(rint(quadratic(d0, d1, d2, tr)), 0.0),
                        static_cast<double>(max_delay));
  const int ci = static_cast<int>(c);
  if (b == 0) coarse[s] = ci;
  const double x = __dadd_rn(tr, __dmul_rn(__dadd_rn(static_cast<double>(b), 0.5),
                                           static_cast<double>(fft_size)));
  const long long o = static_cast<long long>(s) * b_total + b;
  frac[o] = __double2float_rn(__dsub_rn(quadratic(d0, d1, d2, x), static_cast<double>(ci)));
  phase[o] = __double2float_rn(quadratic(p0, p1, p2, x));
}

}  // namespace

// coef: float64 (6, s) rows d0, d1, d2, p0, p1, p2, contiguous; tr: the
// chunk's first sample less the model's epoch; coarse: int32 (s,); frac and
// phase: float32 (s, b) contiguous.  Needs 1 <= s <= 65535, b >= 1,
// max_delay >= 0.  Launches on the current device, which must own `stream`;
// returns cudaGetLastError().
extern "C" int dcs_delay_terms(const void* coef, int s, double tr, int b, int fft_size,
                               int max_delay, void* coarse, void* frac, void* phase,
                               void* stream) {
  if (coef == nullptr || coarse == nullptr || frac == nullptr || phase == nullptr || s < 1 ||
      s > 65535 || b < 1 || max_delay < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  delay_terms_kernel<<<dim3((b + kThreads - 1) / kThreads, s), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(coef), s, tr, b, fft_size, max_delay,
      static_cast<int*>(coarse), static_cast<float*>(frac), static_cast<float*>(phase));
  return static_cast<int>(cudaGetLastError());
}
