// Packed X-engine CMAC (K2/K3) for Hopper, sm_90a.
//
// Replaces the TPU kernels of dc_sand_tpu/ops/xcorr.py: the native CMAC family
// _cmac_native_kernel_pipe, _cmac_native_kernel_single and _cmac_native_kernel
// (launched by xcorr_accumulate_native), and _cmac_kernel (launched by
// _xcorr_accumulate_pallas).  The operand is K3's stacked a2 = [Ar; Ai],
// int8 (K, 2ap, B); the Hopper F-engine writes the wire layout, so the TPU's
// identity-dot relayout of the native planes has no counterpart here.  Per
// channel k the packed int32 plane acc (K, ap, ap) is updated in place:
//
//   acc[k, r, c] = acc[k, r, c] * keep + sum_b Ar[r]Ar[c] + Ai[r]Ai[c]   (r <= c)
//   acc[k, r, c] = acc[k, r, c] * keep + sum_b Ai[r]Ar[c] - Ar[r]Ai[c]   (r >  c)
//
// keep = 0 is the integration-window reset of K2 (xcorr.py:555-557).  All
// arithmetic is integer, so the result equals the plain version bitwise.
//
// Design: one CTA of 4 warps per (64 x 64 output tile, channel).  The spectra
// axis b streams through shared memory in 64-byte stages, double-buffered
// with cp.async; each warp computes a 32 x 32 sub-tile with
// mma.sync.m16n8k32 s8 x s8 -> s32.  A tile wholly above the diagonal
// computes only vr, one wholly below only vi, and a diagonal tile both, then
// selects per element; the TPU kernels formed the full (2ap x 2ap) quadrant
// product and kept half of it.  vi's negative term uses -Ai, negated per byte
// in registers (__vneg4): the quantiser never emits -128, so it cannot wrap.
//
// What bounds it on the H100: at fx64 (K = 4096, ap = 128, B = 2048) a call
// is 0.82 T int8 ops (12 of the 16 64x64 products per channel) against
// 2.15 GB of operand and 0.54 GB of accumulator traffic: about 0.4 ms of
// int8 tensor-core time at the 1979 TOP/s data-sheet peak and 0.8 ms of
// device-memory time at 3.35 TB/s, so the call is memory-bound at the
// roofline.  This first cut is further bounded by its 32-bit shared-memory
// fragment loads and by mma.sync's rate; ldmatrix, wgmma and TMA are later
// work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;         // output tile edge
constexpr int kBK = 64;           // spectra per pipeline stage (bytes of a row)
constexpr int kLd = kBK + 16;     // padded shared-memory row stride (bytes)
constexpr int kThreads = 128;     // 4 warps as 2 x 2 sub-tiles of 32 x 32

// The four operand tiles of one stage: rows' Ar and Ai, columns' Ar and Ai.
struct Stage {
  int8_t t[4][kTile][kLd];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int bytes) {
  const unsigned saddr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(saddr),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// acc[mi][ni] += A(rows) . B(cols)^T over one 32-deep step at column kk.
// neg_b negates B per byte.
__device__ __forceinline__ void product(int (&acc)[2][4][4], const int8_t (*ta)[kLd],
                                        const int8_t (*tb)[kLd], int kk, int wm,
                                        int wn, int g, int t4, bool neg_b) {
  unsigned a[2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int r = 32 * wm + 16 * mi + g;
    a[mi][0] = lds32(&ta[r][kk + 4 * t4]);
    a[mi][1] = lds32(&ta[r + 8][kk + 4 * t4]);
    a[mi][2] = lds32(&ta[r][kk + 16 + 4 * t4]);
    a[mi][3] = lds32(&ta[r + 8][kk + 16 + 4 * t4]);
  }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int c = 32 * wn + 8 * ni + g;
    unsigned b0 = lds32(&tb[c][kk + 4 * t4]);
    unsigned b1 = lds32(&tb[c][kk + 16 + 4 * t4]);
    if (neg_b) {
      b0 = __vneg4(b0);
      b1 = __vneg4(b1);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) mma_s8(acc[mi][ni], a[mi], b0, b1);
  }
}

__global__ void __launch_bounds__(kThreads)
cmac_kernel(const int8_t* __restrict__ a2, int* __restrict__ acc, int ap, int n_b,
            int n_tiles, int keep) {
  __shared__ __align__(16) Stage st[2];
  const int tr = blockIdx.x / n_tiles;
  const int tc = blockIdx.x % n_tiles;
  const int k = blockIdx.y;
  // 0: vr only (above the diagonal), 1: vi only (below), 2: both (diagonal)
  const int mode = tr < tc ? 0 : (tr > tc ? 1 : 2);
  const int r0 = tr * kTile, c0 = tc * kTile;
  const int8_t* base = a2 + static_cast<size_t>(k) * 2 * ap * n_b;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 1, wn = warp & 1;
  const int g = lane >> 2, t4 = lane & 3;

  auto load = [&](int buf, int b0) {
    // 4 tiles x 64 rows x 4 chunks of 16 bytes = 1024 chunks
#pragma unroll
    for (int i = 0; i < (4 * kTile * kBK / 16) / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int tile = idx / (kTile * kBK / 16);
      const int row = (idx / (kBK / 16)) % kTile;
      const int ch = idx % (kBK / 16);
      const int sr = (tile < 2 ? r0 : c0) + row;     // stream (antpol) index
      const int part = tile & 1;                      // 0: Ar, 1: Ai
      const int b = b0 + 16 * ch;
      const bool ok = sr < ap && b < n_b;
      const int8_t* src =
          ok ? base + (static_cast<size_t>(part * ap + sr) * n_b + b) : a2;
      cp_async16(&st[buf].t[tile][row][16 * ch], src, ok ? 16 : 0);
    }
  };

  int vr[2][4][4], vi[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) vr[mi][ni][e] = vi[mi][ni][e] = 0;

  const int n_stages = (n_b + kBK - 1) / kBK;
  load(0, 0);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int it = 0; it < n_stages; ++it) {
    if (it + 1 < n_stages) load((it + 1) & 1, (it + 1) * kBK);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();
    const Stage& s = st[it & 1];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      if (mode != 1) {  // vr = Ar Ar^T + Ai Ai^T
        product(vr, s.t[0], s.t[2], kk, wm, wn, g, t4, false);
        product(vr, s.t[1], s.t[3], kk, wm, wn, g, t4, false);
      }
      if (mode != 0) {  // vi = Ai Ar^T - Ar Ai^T
        product(vi, s.t[1], s.t[2], kk, wm, wn, g, t4, false);
        product(vi, s.t[0], s.t[3], kk, wm, wn, g, t4, true);
      }
    }
    __syncthreads();
  }

  int* plane = acc + static_cast<size_t>(k) * ap * ap;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + 32 * wm + 16 * mi + g + (e >= 2 ? 8 : 0);
        const int c = c0 + 32 * wn + 8 * ni + 2 * t4 + (e & 1);
        if (r < ap && c < ap) {
          const int v = r <= c ? vr[mi][ni][e] : vi[mi][ni][e];
          int* dst = plane + static_cast<size_t>(r) * ap + c;
          *dst = keep ? *dst + v : v;
        }
      }
}

}  // namespace

// Plain C entry point (bound with ctypes).  a2: int8 (K, 2ap, B) device
// pointer, rows 16-byte aligned (B % 16 == 0); acc: int32 (K, ap, ap),
// updated in place; keep: 0 or 1.  Returns cudaGetLastError() after the
// launch.
extern "C" int dcs_cmac(const void* a2, void* acc, int n_chans, int ap, int n_b,
                        int keep, void* stream) {
  if (n_chans < 1 || n_chans > 65535 || ap < 1 || n_b < 16 || n_b % 16 ||
      (keep != 0 && keep != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_tiles = (ap + kTile - 1) / kTile;
  const dim3 grid(n_tiles * n_tiles, n_chans);
  cmac_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(a2), static_cast<int*>(acc), ap, n_b, n_tiles, keep);
  return static_cast<int>(cudaGetLastError());
}
