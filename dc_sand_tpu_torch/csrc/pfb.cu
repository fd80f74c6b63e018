// Standalone PFB-FIR kernel (K6) for Hopper, sm_90a.
//
// Replaces the TPU kernel dc_sand_tpu/ops/pfb.py:_pfb_kernel (launched by
// _pfb_fir_pallas).  It computes
//
//   y[s, j, n] = sum_t w[t, n] * x[s, j + pad0 + t, n]      (float32)
//
// over the frames of the virtual stream [hist | chunk]: frame f comes from
// `hist` when f < n_hist and from `chunk` otherwise (one stream: hist is the
// whole frame array and n_chunk = 0).  Taps are summed in order t = 0..taps-1
// as __fmul_rn then __fadd_rn from 0, the plain version's order, so the two
// are bitwise equal.  Any B and M: the ragged edges are masked, there is no
// fallback.  The TPU kernel's roll and 8-aligned history tricks exist only for
// Mosaic and are not carried over.
//
// What bounds it on the H100: the float32 store.  At the fx64 chunk shape
// (128 streams, 2048 spectra, M = 8192) it reads 2.15 GB of int8 frames and
// writes 8.59 GB of float32, 3.2 ms at 3.35 TB/s; its 68.7 GFLOP of separate
// multiplies and adds (no FMA: the order is pinned) take about 2.3 ms at
// the fp32 instruction rate.  What the design does about it: one thread per
// (stream, run of kTilesPerThread tiles of kTile spectra, kCols consecutive
// columns) keeps the columns' taps weights in registers for all its tiles and a
// tile's kTile accumulators beside them, and walks the tile's
// kTile + taps - 1 frames once, so every int8 frame value is converted once
// per thread (an exponent-trick conversion, not I2F) and feeds all the
// outputs it belongs to.  The frame words of the next tile are copied into
// the thread's own shared-memory slots with cp.async while the current tile
// computes, so a warp keeps some 30 loads in flight, and each output is
// stored as soon as its last frame is in, so the stores spread over the
// tile's compute; the frames shared with the neighbouring tile are re-read
// from L1/L2.  A warp reads 128 contiguous bytes of a frame and writes 512
// contiguous bytes of an output row with 16-byte streaming stores.  The
// first cut (each frame loaded just before its use, every store at the end
// of the tile, no register cap) ran at 3.5x the bound.  The multiplies and
// adds, in the pinned order and without FMA, are what is left: a kernel
// faster than this one needs fewer instructions per term, not fewer bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTaps = 16;
constexpr int kTile = 16;            // output spectra per tile
constexpr int kFrames = kTile + kMaxTaps - 1;
constexpr int kTilesPerThread = 4;   // tiles a thread runs with one weight load
constexpr int kCols = 4;             // consecutive columns per thread
constexpr int kThreads = 128;
constexpr int kMinBlocks = 3;        // caps registers at 168: 12 warps an SM

// Four signed bytes -> four exact floats: byte b becomes the low mantissa
// byte of 2^23 + (b + 128), and subtracting 2^23 + 128 leaves b.
__device__ __forceinline__ void unpack4(uint32_t packed, float x[kCols]) {
  const uint32_t q = packed ^ 0x80808080u;
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    x[c] = __fsub_rn(__uint_as_float(__byte_perm(q, 0x4B000000u, 0x7440 | c)),
                     8388736.0f);
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

struct Frames {
  const int8_t* hist;
  const int8_t* chunk;
  int n_hist, n_chunk, m, s;
  // frame `fa` of stream s in the virtual stream [hist | chunk]
  __device__ __forceinline__ const int8_t* row(int fa) const {
    return fa < n_hist ? hist + (static_cast<size_t>(s) * n_hist + fa) * m
                       : chunk + (static_cast<size_t>(s) * n_chunk + (fa - n_hist)) * m;
  }
};

// kVec: M % 4 == 0, 4-byte frame words staged through shared memory and
// 16-byte stores; otherwise byte loads and stores masked at the ragged M edge.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
pfb_kernel(const int8_t* __restrict__ hist, const int8_t* __restrict__ chunk,
           const float* __restrict__ window, float* __restrict__ out, int n_hist,
           int n_chunk, int n_out, int m, int taps, int pad0) {
  // each thread reads back only the words it copied itself: no barrier
  __shared__ uint32_t stage[2][kFrames][kThreads];
  const int n0 = (blockIdx.x * kThreads + threadIdx.x) * kCols;
  if (n0 >= m) return;
  const int s = blockIdx.z;
  const int j_first = blockIdx.y * kTile * kTilesPerThread;
  const int n_tiles = min(kTilesPerThread, (n_out - j_first + kTile - 1) / kTile);
  const Frames fr{hist, chunk, n_hist, n_chunk, m, s};

  // Weights past `taps` are zero: their terms add +-0 to a sum that is never
  // -0, so the result stays bitwise that of the taps-term sum.
  float w[kMaxTaps][kCols];
#pragma unroll
  for (int t = 0; t < kMaxTaps; ++t) {
    if (t < taps && kVec) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(
          window + static_cast<size_t>(t) * m + n0));
      w[t][0] = v.x; w[t][1] = v.y; w[t][2] = v.z; w[t][3] = v.w;
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        w[t][c] = (t < taps && n0 + c < m)
                      ? __ldg(window + static_cast<size_t>(t) * m + n0 + c) : 0.0f;
    }
  }

  // frames a tile's valid outputs read: min(kTile, n_out - j0) + taps - 1
  auto n_frames = [&](int tile) {
    return min(kTile, n_out - (j_first + tile * kTile)) + taps - 1;
  };
  auto fetch = [&](int tile) {
    if (kVec) {
      const int j0 = j_first + tile * kTile;
      const int nf = n_frames(tile);
#pragma unroll
      for (int f = 0; f < kFrames; ++f)
        if (f < nf) cp_async4(&stage[tile & 1][f][threadIdx.x], fr.row(j0 + pad0 + f) + n0);
      cp_async_commit();
    }
  };

  fetch(0);
#pragma unroll 1
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) {
      fetch(tile + 1);
      if (kVec) cp_async_wait<1>();
    } else if (kVec) {
      cp_async_wait<0>();
    }
    const int j0 = j_first + tile * kTile;
    const int n_valid = min(kTile, n_out - j0);
    const int nf = n_valid + taps - 1;
    float acc[kTile][kCols];
#pragma unroll
    for (int jj = 0; jj < kTile; ++jj)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[jj][c] = 0.0f;
#pragma unroll
    for (int f = 0; f < kFrames; ++f) {
      float x[kCols] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (f < nf) {
        if (kVec) {
          unpack4(stage[tile & 1][f][threadIdx.x], x);
        } else {
          const int8_t* src = fr.row(j0 + pad0 + f);
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            if (n0 + c < m) x[c] = static_cast<float>(__ldg(src + n0 + c));
        }
      }
      // frame f is tap t = f - jj of output jj: for each output the taps
      // arrive in increasing t
#pragma unroll
      for (int t = 0; t < kMaxTaps; ++t) {
        const int jj = f - t;
        if (jj >= 0 && jj < kTile) {
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            acc[jj][c] = __fadd_rn(acc[jj][c], __fmul_rn(w[t][c], x[c]));
        }
      }
      // output jj has all its terms after frame jj + kMaxTaps - 1: store it
      // there, so the stores spread over the tile's compute
      const int jj = f - (kMaxTaps - 1);
      if (jj >= 0 && jj < n_valid) {
        float* dst = out + (static_cast<size_t>(s) * n_out + j0 + jj) * m + n0;
        if (kVec) {
          __stcs(reinterpret_cast<float4*>(dst),
                 make_float4(acc[jj][0], acc[jj][1], acc[jj][2], acc[jj][3]));
        } else {
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            if (n0 + c < m) dst[c] = acc[jj][c];
        }
      }
    }
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  Device pointers: `hist` (S,
// n_hist, M) and `chunk` (S, n_chunk, M) int8, `window` (taps, M) float32,
// `out` (S, n_out, M) float32.  The 16-byte path needs M % 4 == 0 and `hist`,
// `chunk` 4-byte and `window`, `out` 16-byte aligned; `vec` = 0 takes any M.
// Returns cudaGetLastError() after the launch.
extern "C" int dcs_pfb(const void* hist, const void* chunk, const void* window,
                       void* out, int n_streams, int n_hist, int n_chunk,
                       int n_out, int m, int taps, int pad0, int vec, void* stream) {
  const int tiles = (n_out + kTile * kTilesPerThread - 1) / (kTile * kTilesPerThread);
  const int groups = (m + kCols - 1) / kCols;
  if (m < 1 || n_streams < 1 || n_streams > 65535 || n_out < 1 || tiles > 65535 ||
      taps < 1 || taps > kMaxTaps || pad0 < 0 ||
      n_out - 1 + pad0 + taps > n_hist + n_chunk || (vec && m % kCols))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((groups + kThreads - 1) / kThreads, tiles, n_streams);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* h = static_cast<const int8_t*>(hist);
  const int8_t* c = static_cast<const int8_t*>(chunk);
  const float* w = static_cast<const float*>(window);
  float* o = static_cast<float*>(out);
  if (vec)
    pfb_kernel<true><<<grid, kThreads, 0, st>>>(h, c, w, o, n_hist, n_chunk, n_out,
                                                m, taps, pad0);
  else
    pfb_kernel<false><<<grid, kThreads, 0, st>>>(h, c, w, o, n_hist, n_chunk, n_out,
                                                 m, taps, pad0);
  return static_cast<int>(cudaGetLastError());
}
