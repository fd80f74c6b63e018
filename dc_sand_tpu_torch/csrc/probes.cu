// Bandwidth probes P1 (read) and P2 (write) for Hopper, sm_90a.
//
// Replaces the TPU kernels of scripts/sweep_s10_micro.py, which split the
// fused F-engine's memory traffic into its input and output sides over the
// grid and blocks of the 4k wire shape:
//
//   P1 _read_kernel: x int8 (S, NF, M) read in (TB, M) blocks, grid (S, NB),
//       double-buffered DMA; it writes one (8, 128) int8 tile, rows 0-7 and
//       columns 0-127 of the last block read;
//   P2 _write_kernel: out int8 (S, 2*M2, NB*TB, K1N), block (1, 2*M2, TB, K1N)
//       at (s, 0, b, 0) filled with b.
//
// dcs_read_probe: kSplit CTAs per (s, b) block.  The block is one contiguous
// run of TB*M bytes; each CTA reads a kSplit-th of it with 16-byte loads,
// kUnroll independent loads in flight per thread (the counterpart of the
// TPU's double-buffered DMA), and sums its bytes exactly: __dp4a turns 16
// bytes into an int32, each thread adds those into an int64, warp shuffles
// and one pass over the warps' partials give the CTA's sum, which it adds to
// sums[s, b] with one atomicAdd (the wrapper zeroes sums).  The sum keeps
// every load live: a probe that wrote only the tile would let the compiler
// drop the rest of the block's loads.  Integer sums are exact in any order,
// so the kernel is bitwise equal to its plain version.  The first CTA of the
// last block also stores the tile.
//
// dcs_write_probe: one CTA per output block (s, b), 2*M2 runs of TB*K1N
// contiguous bytes, written with 16-byte stores of b.
//
// What bounds them on the H100: bytes.  At the script's shapes (S 16, NB 8,
// TB 64, M 8192; M2 = K1N = 64) each moves 67.1 MB, 0.020 ms at 3.35 TB/s,
// about the length of a launch, so they are timed with many launches and
// with the 50 MB L2 flushed between launches (67 MB is not much more than
// the L2, and a back-to-back launch finds part of its input there).  The
// design does nothing but keep enough wide, coalesced accesses in flight:
// for the read, 4 CTAs of 512 threads a block (512 CTAs at the script's
// shapes, all resident at once on the 132 SMs), 64 bytes a thread in
// flight; for the write, 1024 threads a CTA.  Blocks
// whose rows are not a multiple of 16 bytes, or whose base is not 16-byte
// aligned, take a byte path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;  // the write
constexpr int kReadThreads = 512;
constexpr int kSplit = 4;       // CTAs a block for the read
constexpr int kUnroll = 4;

__device__ __forceinline__ int sum16(const uint4 v) {
  const int ones = 0x01010101;
  int s = __dp4a(static_cast<int>(v.x), ones, 0);
  s = __dp4a(static_cast<int>(v.y), ones, s);
  s = __dp4a(static_cast<int>(v.z), ones, s);
  return __dp4a(static_cast<int>(v.w), ones, s);
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// grid (nb * kSplit, S): CTA (b * kSplit + c, s) reads part c of rows
// [b*tb, (b+1)*tb) of x[s].
__global__ void __launch_bounds__(kReadThreads)
    read_probe(const int8_t* __restrict__ x, int8_t* __restrict__ tile,
               long long* __restrict__ sums, int nf, int m, int nb, int tb, int vec) {
  const int b = blockIdx.x / kSplit;
  const int c = blockIdx.x % kSplit;
  const int s = blockIdx.y;
  const int8_t* blk =
      x + (static_cast<long long>(s) * nf + static_cast<long long>(b) * tb) * m;
  const long long nbytes = static_cast<long long>(tb) * m;
  const long long n16 = vec ? nbytes / 16 : 0;
  // this CTA's 16-byte vectors [v0, v1), and the bytes past them for the last
  const long long v0 = n16 * c / kSplit;
  const long long v1 = n16 * (c + 1) / kSplit;
  long long acc = 0;
  const uint4* v = reinterpret_cast<const uint4*>(blk);
  long long i = v0 + threadIdx.x;
  for (; i + (kUnroll - 1) * kReadThreads < v1; i += kUnroll * kReadThreads) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) r[u] = __ldg(v + i + u * kReadThreads);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc += sum16(r[u]);
  }
  for (; i < v1; i += kReadThreads) acc += sum16(__ldg(v + i));
  if (c == kSplit - 1)
    for (long long j = n16 * 16 + threadIdx.x; j < nbytes; j += kReadThreads)
      acc += blk[j];

  __shared__ long long part[kReadThreads / 32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  acc = warp_sum(acc);
  if (lane == 0) part[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = warp_sum(lane < kReadThreads / 32 ? part[lane] : 0);
    if (lane == 0)
      atomicAdd(reinterpret_cast<unsigned long long*>(sums) +
                    static_cast<long long>(s) * nb + b,
                static_cast<unsigned long long>(acc));
  }
  if (c == 0 && b == nb - 1 && s == static_cast<int>(gridDim.y) - 1) {
    for (int j = threadIdx.x; j < 8 * 128; j += kReadThreads)
      tile[j] = blk[static_cast<long long>(j / 128) * m + j % 128];
  }
}

// grid (nb, S): CTA (b, s) fills out[s, :, b*tb:(b+1)*tb, :] with b.  seg =
// tb*k1n bytes a run, two_m2 runs nb*seg bytes apart; seg * two_m2 < 2**31.
__global__ void __launch_bounds__(kThreads)
    write_probe(int8_t* __restrict__ out, int two_m2, int nb, int seg, int vec) {
  const int b = blockIdx.x;
  const int s = blockIdx.y;
  const long long plane = static_cast<long long>(nb) * seg;
  int8_t* base = out + static_cast<long long>(s) * two_m2 * plane +
                 static_cast<long long>(b) * seg;
  if (vec) {
    const uint32_t w = 0x01010101u * static_cast<uint32_t>(b & 0xff);
    const uint4 v = make_uint4(w, w, w, w);
    const int n16 = seg / 16;
    const int total = n16 * two_m2;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int k2 = i / n16;
      reinterpret_cast<uint4*>(base + k2 * plane)[i - k2 * n16] = v;
    }
  } else {
    const int total = seg * two_m2;
    for (int i = threadIdx.x; i < total; i += kThreads) {
      const int k2 = i / seg;
      base[k2 * plane + (i - k2 * seg)] = static_cast<int8_t>(b);
    }
  }
}

}  // namespace

// P1.  x: int8 (s, nf, m); tile: int8 (8, 128); sums: int64 (s, nb), zeroed
// (each CTA adds its part).  Needs tb >= 8, m >= 128, nb * tb <= nf,
// s <= 65535.  Launches on the current device, which must own `stream`;
// returns cudaGetLastError().
extern "C" int dcs_read_probe(const void* x, void* tile, void* sums, int s, int nf,
                              int m, int nb, int tb, void* stream) {
  if (x == nullptr || tile == nullptr || sums == nullptr || s < 1 || s > 65535 ||
      nb < 1 || nb > (1 << 28) || tb < 8 || m < 128 ||
      static_cast<long long>(nb) * tb > nf)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = reinterpret_cast<uintptr_t>(x) % 16 == 0 && m % 16 == 0;
  read_probe<<<dim3(nb * kSplit, s), kReadThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<int8_t*>(tile),
      static_cast<long long*>(sums), nf, m, nb, tb, vec);
  return static_cast<int>(cudaGetLastError());
}

// P2.  out: int8 (s, two_m2, nb * tb, k1n); out[s, k2, t, k] = t / tb.  Needs
// nb <= 128 (the values are int8), s <= 65535, two_m2 * tb * k1n < 2**31.
extern "C" int dcs_write_probe(void* out, int s, int two_m2, int nb, int tb, int k1n,
                               void* stream) {
  const long long seg = static_cast<long long>(tb) * k1n;
  if (out == nullptr || s < 1 || s > 65535 || two_m2 < 1 || nb < 1 || nb > 128 ||
      seg < 1 || seg * two_m2 >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = reinterpret_cast<uintptr_t>(out) % 16 == 0 && seg % 16 == 0;
  write_probe<<<dim3(nb, s), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(out), two_m2, nb, static_cast<int>(seg), vec);
  return static_cast<int>(cudaGetLastError());
}
