// Coarse delay gather for Hopper, sm_90a: one launch a card.
//
// The port's own kernel, not the port of a TPU kernel: the JAX package
// computes the gather outside any Pallas kernel, as a vmapped
// dynamic_slice (dc_sand_tpu/models/fengine.py:21-46, coarse_delay).
//
// Each stream row s is the virtual row [lead_s | chunk_s] of lead_len + n_c
// int8 samples.  The stream delayed by d_s reads n_h + n_c samples of it from
// offset off = md - clamp(d_s, 0, md), where n_h = lead_len - md:
//
//   out sample j < n_h  -> hist[s * hist_stride + j]
//   out sample j >= n_h -> out[s * out_stride + j - n_h]
//
// The wrapper points hist at the first frame of the FIR history that the
// F-engine reads (behind the frames it skips) and out at the chunk's frames,
// so the delayed stream lands in the frame form that the F-engine kernel's
// split I/O reads.  The device coarse mode has lead_len = md + (taps-1)*M (a
// lead-in history) and the host mode lead_len = md (the previous chunk's
// tail) with no hist output.
//
// Design.  The offset is any byte, so a 16-byte output vector starts at any
// source alignment.  Each thread writes 16-byte vectors; for each it loads
// the aligned 16-byte word that holds the vector's first source byte and,
// unless that byte is aligned, the next word, and funnel-shifts the two
// into place.  Both words hold a source byte of the row, so no load leaves
// the sectors the row lies in; the shift is the same for every vector of a
// row's lead or chunk part, so the warps do not diverge.  The next word of a
// thread is the first word of its neighbour: the L1 serves it, and HBM sees
// each source byte once.  The one vector a row that straddles lead and chunk
// gathers its bytes one by one.  Rows whose parts are not whole vectors, or
// outputs that are not 16-byte aligned, take a byte path.
//
// What bounds it on the H100: bytes, each sample read once and written once.
// At the fx64 chunk (128 streams x 16.8 M samples) that is 2 x 2.15 GB, about
// 1.28 ms at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;   // vectors a thread, kThreads apart

// bytes k..k+15 of the 32 bytes a:b (k in 0..15)
__device__ __forceinline__ uint4 shift16(const uint4 a, const uint4 b, int k) {
  const int r = (k & 3) * 8;
  uint32_t x0, x1, x2, x3, x4;
  switch (k >> 2) {
    case 0: x0 = a.x; x1 = a.y; x2 = a.z; x3 = a.w; x4 = b.x; break;
    case 1: x0 = a.y; x1 = a.z; x2 = a.w; x3 = b.x; x4 = b.y; break;
    case 2: x0 = a.z; x1 = a.w; x2 = b.x; x3 = b.y; x4 = b.z; break;
    default: x0 = a.w; x1 = b.x; x2 = b.y; x3 = b.z; x4 = b.w; break;
  }
  return make_uint4(__funnelshift_r(x0, x1, r), __funnelshift_r(x1, x2, r),
                    __funnelshift_r(x2, x3, r), __funnelshift_r(x3, x4, r));
}

// 16 bytes from any address p of the row
__device__ __forceinline__ uint4 load16(const int8_t* p) {
  const uintptr_t u = reinterpret_cast<uintptr_t>(p);
  const uint4* base = reinterpret_cast<const uint4*>(u & ~static_cast<uintptr_t>(15));
  const int k = static_cast<int>(u & 15);
  const uint4 w0 = __ldg(base);
  if (k == 0) return w0;
  return shift16(w0, __ldg(base + 1), k);
}

struct Rows {
  const int8_t* lead;
  const int8_t* chunk;
  const int* coarse;
  int8_t* hist;
  int8_t* out;
  long long lead_stride, chunk_stride, hist_stride, out_stride;
  long long lead_len, n_h, n_c;
  int md;
};

__device__ __forceinline__ int8_t src_byte(const Rows& r, int s, long long a) {
  return a < r.lead_len ? r.lead[s * r.lead_stride + a]
                        : r.chunk[s * r.chunk_stride + (a - r.lead_len)];
}

__device__ __forceinline__ long long offset(const Rows& r, int s) {
  const int d = min(max(r.coarse[s], 0), r.md);
  return static_cast<long long>(r.md - d);
}

// grid (ceil(n_out / (16 * kThreads * kUnroll)), S)
__global__ void __launch_bounds__(kThreads) gather_vec(const Rows r) {
  const int s = blockIdx.y;
  const long long off = offset(r, s);
  const long long n16 = (r.n_h + r.n_c) / 16;
  const int8_t* lead = r.lead + s * r.lead_stride;
  const int8_t* chunk = r.chunk + s * r.chunk_stride;
  const long long v0 = static_cast<long long>(blockIdx.x) * kThreads * kUnroll + threadIdx.x;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long v = v0 + static_cast<long long>(u) * kThreads;
    if (v >= n16) break;
    const long long j = v * 16;
    const long long a = off + j;
    uint4 val;
    if (a + 16 <= r.lead_len) {
      val = load16(lead + a);
    } else if (a >= r.lead_len) {
      val = load16(chunk + (a - r.lead_len));
    } else {
      alignas(16) int8_t tmp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) tmp[i] = src_byte(r, s, a + i);
      val = *reinterpret_cast<const uint4*>(tmp);
    }
    int8_t* dst = j < r.n_h ? r.hist + s * r.hist_stride + j
                            : r.out + s * r.out_stride + (j - r.n_h);
    *reinterpret_cast<uint4*>(dst) = val;
  }
}

// grid (ceil(n_out / kThreads), S): one byte a thread
__global__ void __launch_bounds__(kThreads) gather_byte(const Rows r) {
  const int s = blockIdx.y;
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= r.n_h + r.n_c) return;
  const int8_t v = src_byte(r, s, offset(r, s) + j);
  if (j < r.n_h)
    r.hist[s * r.hist_stride + j] = v;
  else
    r.out[s * r.out_stride + (j - r.n_h)] = v;
}

}  // namespace

// lead: int8 rows of lead_len samples, lead_stride bytes apart; chunk: rows of
// n_c samples, chunk_stride apart; coarse: int32 (s,) delays, clamped to
// [0, md]; hist: the first written byte of row 0 of the history output (rows
// hist_stride apart; null when lead_len == md); out: rows out_stride apart.
// Needs 0 <= md <= lead_len, s <= 65535.  Launches on the current device,
// which must own `stream`; returns cudaGetLastError().
extern "C" int dcs_coarse_gather(const void* lead, long long lead_stride, long long lead_len,
                                 const void* chunk, long long chunk_stride, long long n_c,
                                 const void* coarse, int md, void* hist,
                                 long long hist_stride, void* out, long long out_stride,
                                 int s, void* stream) {
  const long long n_h = lead_len - md;
  if (chunk == nullptr || coarse == nullptr || out == nullptr || s < 1 || s > 65535 ||
      md < 0 || n_h < 0 || n_c < 0 || (lead_len > 0 && lead == nullptr) ||
      (n_h > 0 && hist == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Rows r{static_cast<const int8_t*>(lead), static_cast<const int8_t*>(chunk),
         static_cast<const int*>(coarse), static_cast<int8_t*>(hist),
         static_cast<int8_t*>(out), lead_stride, chunk_stride, hist_stride,
         out_stride, lead_len, n_h, n_c, md};
  const long long n_out = n_h + n_c;
  if (n_out == 0) return static_cast<int>(cudaGetLastError());
  const bool vec = n_h % 16 == 0 && n_c % 16 == 0 && out_stride % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                   (n_h == 0 || (hist_stride % 16 == 0 &&
                                 reinterpret_cast<uintptr_t>(hist) % 16 == 0));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    const long long per = 16LL * kThreads * kUnroll;
    gather_vec<<<dim3(static_cast<unsigned>((n_out + per - 1) / per), s), kThreads, 0, st>>>(r);
  } else {
    gather_byte<<<dim3(static_cast<unsigned>((n_out + kThreads - 1) / kThreads), s), kThreads,
                  0, st>>>(r);
  }
  return static_cast<int>(cudaGetLastError());
}
