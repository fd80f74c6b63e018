// Coherent beamformer + incoherent sum (K4/K4p/K5) for Hopper, sm_90a.
//
// Replaces the TPU kernels of dc_sand_tpu/ops/beamform.py: _beam_native_kernel
// and its pol-merged variant _beam_native_kernel_pmerge (launched by
// beamform_native on the fused F-engine's native planes), and _bf_kernel
// (launched by _beamform_pallas on the wire layout).  All three compute, per
// channel k, the complex contraction
//
//   y[e, p, b, k] = sum_a w[e, a, k] * x[a, p, b, k]
//
// and the step adds the incoherent beam sum_a |x[a, p, b, k]|^2.  The Hopper
// F-engine writes the wire layout (a*p, B, K, 2) int8, so this kernel reads
// it directly: the TPU kernels' identity-dot relayout of the native planes has
// no counterpart here.
//
// Arithmetic: full fp32 FMA on the CUDA cores, where the TPU kernels split the
// weights into bf16 hi/lo halves for the MXU; this is at least as accurate.
// The incoherent sum adds integers below 2 * 127^2 * 64 < 2^24 in float32, so
// it is exact in any order and equals the plain version bitwise.  With
// qs > 0 each beam value is quantised in the epilogue as the TPU kernel's kq
// path does: clip(rint(y * qs), -127, 127) to int8, rounding half to even.
//
// Design: one thread per (channel k, pol p, pair of spectra, group of up to
// kNB beams).  The 32 lanes of a warp take 32 consecutive channels, so the
// int8 sample reads, the weight reads and the output stores all coalesce
// along k.  The kRows warps of a block share their 32 channels and so their
// weights: the block stages the weights of kAC antennas x kNB beams in shared
// memory (32 KB), and each thread then loops over those antennas with its
// kAC x kTB samples in registers, each weight read from shared memory once
// per (beam, antenna) and reused across the thread's kTB spectra.  A thread
// holds 2 * kNB * kTB = 64 fp32 accumulators.
//
// What bounds it on the H100: at beam64 (a = 64, p = 2, B = 256, K = 4096,
// 16 beams) a call is 2.15e9 complex MACs = 8.6e9 FMAs, about 0.26 ms at the
// 67 TFLOP/s fp32 data-sheet peak, against 268 MB of samples in and 268 MB of
// float32 beams out, about 0.16 ms at 3.35 TB/s, so the FMA rate is the
// floor.  Where the weights come from decides how close the kernel gets: a
// first cut that read them straight from global memory (through L1) in every
// thread took 7.74 ms; staged in shared memory, 1.28 ms (both on an H100
// 80GB HBM3 at 700 W).  Per antenna a warp now issues 16 shared-memory reads
// of 256 B against 128 FMAs, which puts the shared-memory pipe level with the
// FMA pipe; the sample loads after each stage's barrier are not overlapped.
// Tensor cores (a 3xTF32 or split-bf16 mma), TMA and a pipelined stage ring
// are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLanes = 32;  // channels per warp
constexpr int kRows = 16;   // warps per block, each on its own spectra
constexpr int kTB = 2;      // spectra per thread
constexpr int kNB = 16;     // beams per thread
constexpr int kAC = 8;      // antennas per shared-memory weight stage

template <bool kQuant>
__global__ void __launch_bounds__(kLanes* kRows)
beam_kernel(const int8_t* __restrict__ q, const float* __restrict__ w,
            void* __restrict__ out, float* __restrict__ inc, int n_ants, int n_pols,
            int n_b, int n_k, int n_beams, float qs) {
  __shared__ float2 ws[kAC][kNB][kLanes];
  const int k = blockIdx.x * kLanes + threadIdx.x;
  const int b0 = (blockIdx.y * kRows + threadIdx.y) * kTB;
  const int p = blockIdx.z % n_pols;
  const int e0 = (blockIdx.z / n_pols) * kNB;
  const int ne = min(kNB, n_beams - e0);
  // threads past the edges compute nothing but still stage weights
  const int nt = (k < n_k && b0 < n_b) ? min(kTB, n_b - b0) : 0;

  // x[a, p, b, k] of the wire layout, as (re, im) byte pairs
  const char2* x = reinterpret_cast<const char2*>(q);
  const size_t x_ant = static_cast<size_t>(n_pols) * n_b * n_k;
  const size_t x0 = (static_cast<size_t>(p) * n_b + b0) * n_k + k;
  // w[e, a, k] as (re, im) float pairs
  const float2* w2 = reinterpret_cast<const float2*>(w);

  float yr[kNB][kTB], yi[kNB][kTB], pw[kTB];
#pragma unroll
  for (int t = 0; t < kTB; ++t) {
    pw[t] = 0.f;
#pragma unroll
    for (int e = 0; e < kNB; ++e) yr[e][t] = yi[e][t] = 0.f;
  }

  for (int a0 = 0; a0 < n_ants; a0 += kAC) {
    __syncthreads();  // the previous stage's weights are no longer read
    for (int i = threadIdx.y; i < kAC * kNB; i += kRows) {
      const int a = a0 + i / kNB, e = i % kNB;
      ws[i / kNB][e][threadIdx.x] =
          (a < n_ants && e < ne && k < n_k)
              ? __ldg(w2 + (static_cast<size_t>(e0 + e) * n_ants + a) * n_k + k)
              : make_float2(0.f, 0.f);
    }
    __syncthreads();
    char2 xv[kAC][kTB];
#pragma unroll
    for (int j = 0; j < kAC; ++j)
#pragma unroll
      for (int t = 0; t < kTB; ++t)
        xv[j][t] = (a0 + j < n_ants && t < nt)
                       ? x[(a0 + j) * x_ant + x0 + static_cast<size_t>(t) * n_k]
                       : make_char2(0, 0);
#pragma unroll
    for (int j = 0; j < kAC; ++j) {
      float xr[kTB], xi[kTB];
#pragma unroll
      for (int t = 0; t < kTB; ++t) {
        xr[t] = xv[j][t].x;
        xi[t] = xv[j][t].y;
        pw[t] = fmaf(xr[t], xr[t], fmaf(xi[t], xi[t], pw[t]));
      }
#pragma unroll
      for (int e = 0; e < kNB; ++e) {
        const float2 ww = ws[j][e][threadIdx.x];
#pragma unroll
        for (int t = 0; t < kTB; ++t) {
          yr[e][t] = fmaf(ww.x, xr[t], fmaf(-ww.y, xi[t], yr[e][t]));
          yi[e][t] = fmaf(ww.x, xi[t], fmaf(ww.y, xr[t], yi[e][t]));
        }
      }
    }
  }

  // out[e, p, b, k] as (re, im) pairs
#pragma unroll
  for (int e = 0; e < kNB; ++e) {
    if (e >= ne) continue;
    const size_t row = (static_cast<size_t>(e0 + e) * n_pols + p) * n_b + b0;
#pragma unroll
    for (int t = 0; t < kTB; ++t) {
      if (t >= nt) continue;
      const size_t idx = (row + t) * n_k + k;
      if constexpr (kQuant) {
        const float r = fminf(fmaxf(rintf(__fmul_rn(yr[e][t], qs)), -127.f), 127.f);
        const float i = fminf(fmaxf(rintf(__fmul_rn(yi[e][t], qs)), -127.f), 127.f);
        reinterpret_cast<char2*>(out)[idx] =
            make_char2(static_cast<signed char>(r), static_cast<signed char>(i));
      } else {
        reinterpret_cast<float2*>(out)[idx] = make_float2(yr[e][t], yi[e][t]);
      }
    }
  }
  if (inc != nullptr && e0 == 0) {
#pragma unroll
    for (int t = 0; t < kTB; ++t)
      if (t < nt) inc[(static_cast<size_t>(p) * n_b + b0 + t) * n_k + k] = pw[t];
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  q: int8 (a*p, B, K, 2) wire
// spectra, 2-byte aligned; w: float32 (nb, a, K, 2), 8-byte aligned; out:
// (nb, p, B, K, 2) float32 when qs == 0, int8 when qs > 0; inc: float32
// (p, B, K) or null.  Returns cudaGetLastError() after the launch.
extern "C" int dcs_beamform(const void* q, const void* w, void* out, void* inc,
                            int n_ants, int n_pols, int n_b, int n_k, int n_beams,
                            float qs, void* stream) {
  const int groups = (n_beams + kNB - 1) / kNB;
  const int rows = (n_b + kTB * kRows - 1) / (kTB * kRows);
  if (n_ants < 1 || n_pols < 1 || n_b < 1 || n_k < 1 || n_beams < 1 || !(qs >= 0.f) ||
      rows > 65535 || static_cast<long long>(groups) * n_pols > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_k + kLanes - 1) / kLanes, rows, groups * n_pols);
  const dim3 block(kLanes, kRows);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* wp = static_cast<const float*>(w);
  float* ip = static_cast<float*>(inc);
  if (qs > 0.f)
    beam_kernel<true><<<grid, block, 0, s>>>(qp, wp, out, ip, n_ants, n_pols, n_b,
                                             n_k, n_beams, qs);
  else
    beam_kernel<false><<<grid, block, 0, s>>>(qp, wp, out, ip, n_ants, n_pols, n_b,
                                              n_k, n_beams, qs);
  return static_cast<int>(cudaGetLastError());
}
