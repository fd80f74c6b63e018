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
// What bounds it on the H100: bytes.  At beam64 (a = 64, p = 2, B = 256,
// K = 4096, 16 beams) a call reads 268 MB of samples and 34 MB of weights and
// writes 268 MB of float32 beams and 8 MB of incoherent beam, 0.173 ms at
// 3.35 TB/s; its 2.15e9 complex MACs are 17 GFLOP, which the fp32 FMA pipe
// (67 TFLOP/s) would need 0.26 ms for but the tensor cores (989 TFLOP/s in
// bf16) 0.05 ms even at three passes.  The first version of this kernel ran
// the sum as fp32 FMAs on the CUDA cores, weights staged in shared memory:
// 1.25 ms on an H100 80GB HBM3 at 700 W.  This one takes 0.33 ms there.
//
// Design: each channel is a real GEMM on the tensor cores.  With the reduction
// axis ordered (antenna, re/im),
//
//   Y'[(b), (e, c)] = sum_{a, c'} X'[(b), 2a + c'] * W'[2a + c', (e, c)]
//
// where X' is the int8 samples as they lie in memory (one (re, im) byte pair
// is one packed bf16x2 register of the A fragment, no shuffle), and W' holds
// (wr, -wi) in the column of the real output and (wi, wr) in that of the
// imaginary.  M = 64 spectra a warpgroup, N = 2 * 16 beams, depth 2 * 8
// antennas a step: wgmma.mma_async m64n32k16, A from registers (the int8 ->
// bf16 conversion happens there anyway), B from shared memory.
//
// Exact operands give fp32 accuracy from bf16 tensor cores: |x| <= 127 is
// exact in bf16, and each float32 weight is split into three bf16 pieces
// hi = bf16(w), mid = bf16(w - hi), lo = bf16(w - hi - mid), 8 + 8 + 8
// significant bits that add up to w exactly.  Every product piece * x is
// exact in the fp32 accumulator, so only the accumulation rounds: three
// wgmma per channel and step into one accumulator.  The split is done in the
// kernel as it stages the weights.
//
// A block of 256 threads (two warpgroups) takes a tile of 16 channels x 64
// spectra of one pol and up to 16 beams (more beams are further tiles), each
// warpgroup 8 of the channels (8 x 16 = 128 accumulators a thread).  It walks
// the antennas 8 at a time through a ring of kStages stages in shared memory.
// One thread fills a stage with two tensor (TMA) copies that complete on the
// stage's mbarrier: the box of the samples (8 antennas x 64 spectra x 32 B)
// and that of the raw float32 weights (8 antennas x 16 beams x 128 B, under
// the 128-byte swizzle), zero-filled past the edges of a ragged shape.  (A
// 16-byte cp.async per thread, the first form of the ring, spent 2000 clocks
// a step handing over its 2048 requests.)  Per step the threads read their A
// fragments (16 bytes: 8 channels of one (antenna, spectrum)), turn the bytes
// into bf16 with byte permutes and one float subtraction each, and start the
// step's 24 wgmma in two batches; behind the first batch goes the start of
// the copy two steps ahead, behind each batch half of the split of the NEXT
// step's weights into a second buffer of the canonical (no-swizzle, K-major)
// 8 x 16 B core matrices that the wgmma descriptor reads, so the tensor cores
// work while the other pipes do.  Blocks are persistent: a block walks tiles
// blockIdx.x, + gridDim.x, ... with the ring running across tile borders.
// Tiles that share channels (pols, spectra blocks, beam groups) are
// neighbours in that order, so the weights are re-read from the L2.
//
// The incoherent sum stays fused: fp32 FMAs on the converted samples (2 a
// sample), integers below 2 * 127^2 * 64 < 2^24, so exact in any order and
// bitwise equal to the plain version; a 4-lane shuffle sums the antennas a
// fragment spreads over lanes.  With qs > 0 each beam value is quantised in
// the epilogue as the TPU kernel's kq path does: clip(rint(y * qs), -127, 127)
// to int8, rounding half to even.  The tile leaves through shared memory (the
// weight buffer the wgmma have finished with and the ring slot the step has
// used up) in tensor copies that clip at the edges of the outputs and run on
// while the block starts its next tile.
//
// A shape whose rows are not 16-byte aligned (K not a multiple of 8) cannot
// have tensor maps: it takes the same kernel with the stages filled and the
// tile stored element by element by all threads.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kKT = 16;       // channels per tile (8 per warpgroup)
constexpr int kBT = 64;       // spectra per tile (the wgmma M)
constexpr int kAS = 8;        // antennas per stage (one k16 step)
constexpr int kNB = 16;       // beams per tile (N = 32)
constexpr int kStages = 3;    // ring depth
constexpr int kThreads = 256;

// sample stage, as the tensor copy writes its box: [antenna][spectrum] rows
// of the tile's 16 channels, 32 B
constexpr int kXAnt = kBT * 32;
constexpr int kXBytes = kAS * kXAnt;
// raw weight stage: rows (a, e) of 16 channels x float2 = 128 B, the 16-byte
// chunk kc2 of row (a, e) at column kc2 ^ (e & 7): the copy's 128-byte swizzle
constexpr int kWRawBytes = kNB * kAS * 128;
constexpr int kRawStage = kXBytes + kWRawBytes;
// split weights of one step: [channel][piece][n-block 4][k-half 2] core
// matrices of 8 rows (n) x 16 B (8 k), K-major
constexpr int kWpPiece = 1024;
constexpr int kWpChan = 3 * kWpPiece;
constexpr int kWpBytes = kKT * kWpChan;
// + 1024: the kernel aligns its base, the swizzled box needs it
constexpr int kSmemBytes = kStages * kRawStage + 2 * kWpBytes + 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarrier of a ring slot: one arrival (the thread that starts the copies)
// and the copies' bytes complete a phase
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Wait for the phase of the given parity; a copy that never completes (a
// refused tensor map) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (int tries = 0; tries < (1 << 24); ++tries) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
  }
  __trap();
}
// Tensor (TMA) copies of one box into shared memory, whatever of the box lies
// outside the tensor zero-filled; they complete on the mbarrier.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], "
      "[%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], "
      "[%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ uint4 ld_shared16(uint32_t src) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(src)
               : "memory");
  return v;
}

__device__ __forceinline__ uint32_t ld_shared4(uint32_t src) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(src) : "memory");
  return v;
}
__device__ __forceinline__ uint16_t ld_shared2(uint32_t src) {
  uint16_t v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(src) : "memory");
  return v;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory made visible to the wgmma's reads
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory matrix descriptor, no swizzle, K-major: core matrices of
// 8 rows x 16 B; lbo = bytes between the two core matrices along K, sbo =
// bytes between 8-row groups along N.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d (64 x 32 fp32, 16 registers a thread) += a (64 x 16 bf16, registers) *
// b (16 x 32 bf16, shared memory)
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"  // scale-d: accumulate into d
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// A complex weight (wr, wi) as three packed bf16 pairs (lo half: the piece of
// wr, hi half: that of wi): w = hi + mid + lo exactly in each component (the
// residuals are exact in fp32; a bf16 is the upper half of its float).
__device__ __forceinline__ void split3(float wr, float wi, uint32_t (&piece)[3]) {
#pragma unroll
  for (int pc = 0; pc < 3; ++pc) {
    const __nv_bfloat162 b2 = __floats2bfloat162_rn(wr, wi);
    piece[pc] = *reinterpret_cast<const uint32_t*>(&b2);
    wr = __fsub_rn(wr, __uint_as_float(piece[pc] << 16));
    wi = __fsub_rn(wi, __uint_as_float(piece[pc] & 0xffff0000u));
  }
}

struct Shape {
  int n_ants, n_pols, n_b, n_k, n_beams;
  int n_bt, groups, n_st;  // spectra tiles, beam groups, antenna stages
  int n_tiles;
  int vec;  // rows 16-byte aligned: vector copies and stores
};

struct Tile {
  int k0, b0, p, e0;
};

__device__ __forceinline__ Tile tile_of(const Shape& s, int tile) {
  unsigned t = tile;
  Tile r;
  r.b0 = static_cast<int>(t % s.n_bt) * kBT;
  t /= s.n_bt;
  r.p = static_cast<int>(t % s.n_pols);
  t /= s.n_pols;
  r.e0 = static_cast<int>(t % s.groups) * kNB;
  r.k0 = static_cast<int>(t / s.groups) * kKT;
  return r;
}

// Where the copies of a block stand: the tile and antenna stage copied next
// and the ring slot it goes to.  The tile's coordinates are kept (tile_of
// divides, a long chain a step could not hide).
struct Cursor {
  int tile, stage, slot;
  Tile at;
};

__device__ __forceinline__ void advance(Cursor& c, const Shape& s) {
  if (++c.stage == s.n_st) {
    c.stage = 0, c.tile += gridDim.x;
    if (c.tile < s.n_tiles) c.at = tile_of(s, c.tile);
  }
  if (++c.slot == kStages) c.slot = 0;
}

// Tensor (TMA) copies of one box from shared memory, clipped at the edges of
// the tensor; they are grouped, and a group is waited for until it has read
// its shared memory.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::
          "l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kPending) : "memory");
}

// One 16-byte piece of a stage for shapes the tensor copies cannot take:
// `bytes` (0 ... 16) from src, the rest zeros, read 2 bytes at a time (both
// the samples and the weights are at least 2-byte aligned).
__device__ __noinline__ void copy16_slow(uint32_t dst, const void* src, int bytes) {
  uint32_t v[4] = {0, 0, 0, 0};
  const uint16_t* s2 = static_cast<const uint16_t*>(src);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (2 * j < bytes) v[j >> 1] |= static_cast<uint32_t>(s2[j]) << (16 * (j & 1));
  st_shared16(dst, make_uint4(v[0], v[1], v[2], v[3]));
}

// Copy antennas 8 * at.stage ... of tile at.tile into ring slot at.slot
// (shared address sm + slot * kRawStage); past the last tile nothing is
// copied.  Everything outside the shape is zero-filled.  Rows that are
// 16-byte aligned: one thread starts two tensor copies, which complete on the
// slot's mbarrier.  Other shapes: every thread copies its pieces itself.
__device__ __forceinline__ void load_stage(const Shape& s, const CUtensorMap* tmx,
                                           const CUtensorMap* tmw,
                                           const int8_t* __restrict__ q,
                                           const float* __restrict__ w, uint32_t sm,
                                           uint32_t bars, const Cursor& at) {
  if (at.tile >= s.n_tiles) return;
  const Tile& tl = at.at;
  const int a0 = at.stage * kAS, tid = threadIdx.x;
  const uint32_t xs = sm + at.slot * kRawStage, ws = xs + kXBytes;
  if (s.vec) {
    if (tid == 0) {
      const uint32_t bar = bars + at.slot * 8;
      bulk_wait_read<0>();  // a tile's last stores may still read this slot
      mbar_expect(bar, kRawStage);
      tma_load_4d(xs, tmx, bar, 2 * tl.k0, tl.b0, tl.p, a0);
      tma_load_3d(ws, tmw, bar, 2 * tl.k0, tl.e0, a0);
    }
    return;
  }
#pragma unroll 1
  for (int c = tid; c < kAS * kBT * 2; c += kThreads) {
    // samples: (antenna a, spectrum b, half h of the channels)
    const int h = c & 1, b = (c >> 1) & (kBT - 1), a = c / (2 * kBT);
    const int k = tl.k0 + 8 * h;
    const bool in = a0 + a < s.n_ants && tl.b0 + b < s.n_b;
    const int bytes = in ? 2 * max(0, min(8, s.n_k - k)) : 0;
    const size_t row = (static_cast<size_t>(a0 + a) * s.n_pols + tl.p) * s.n_b + tl.b0 + b;
    copy16_slow(xs + a * kXAnt + b * 32 + h * 16, bytes ? q + (row * s.n_k + k) * 2 : q, bytes);
  }
#pragma unroll 1
  for (int c = tid; c < kNB * kAS * 8; c += kThreads) {
    // weights: (beam e, antenna a, channel pair kc2)
    const int kc2 = c & 7, a = (c >> 3) & (kAS - 1), e = c / (8 * kAS);
    const int k = tl.k0 + 2 * kc2;
    const bool in = a0 + a < s.n_ants && tl.e0 + e < s.n_beams;
    const int bytes = in ? 8 * max(0, min(2, s.n_k - k)) : 0;
    const size_t row = static_cast<size_t>(tl.e0 + e) * s.n_ants + a0 + a;
    copy16_slow(ws + (a * kNB + e) * 128 + ((kc2 ^ (e & 7)) * 16),
                bytes ? static_cast<const void*>(w + (row * s.n_k + k) * 2) : q, bytes);
  }
}

// Split the raw weights of ring slot `slot` into the bf16 pieces of W' in
// buffer `wp`.  Thread = (beam e, antenna quad aq, channel pair kc2): warp =
// kc2, so each warpgroup splits the channels it multiplies.  Call c (0, 1)
// does the even or the odd channel of the pair.
__device__ __forceinline__ void split_weights(uint32_t sm, int slot, int wp, int c) {
  const int lane = threadIdx.x & 31, kc2 = threadIdx.x >> 5;
  const int e = lane & 15, aq = lane >> 4;
  const uint32_t raw = sm + slot * kRawStage + kXBytes + (4 * aq * kNB + e) * 128 +
                       ((kc2 ^ (e & 7)) * 16) + 8 * c;
  // rows n = 2e (real output: wr, -wi) and 2e + 1 (imaginary: wi, wr)
  uint32_t re_row[3][4], im_row[3][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t piece[3];
    split3(__uint_as_float(ld_shared4(raw + j * kNB * 128)),
           __uint_as_float(ld_shared4(raw + j * kNB * 128 + 4)), piece);
#pragma unroll
    for (int pc = 0; pc < 3; ++pc) {
      re_row[pc][j] = piece[pc] ^ 0x80000000u;            // (wr, -wi)
      im_row[pc][j] = __byte_perm(piece[pc], 0, 0x1032);  // (wi, wr)
    }
  }
  // half the lanes store the odd row first so that a store's 8-lane phases
  // hit 8 different 16-byte bank groups
  const int odd_first = (lane >> 2) & 1;
  const uint32_t out = sm + kStages * kRawStage + wp * kWpBytes + (e >> 2) * 256 + aq * 128 +
                       (e & 3) * 32 + (2 * kc2 + c) * kWpChan;
#pragma unroll
  for (int pc = 0; pc < 3; ++pc) {
    const uint32_t at = out + pc * kWpPiece;
    const uint4 v0 = make_uint4(re_row[pc][0], re_row[pc][1], re_row[pc][2], re_row[pc][3]);
    const uint4 v1 = make_uint4(im_row[pc][0], im_row[pc][1], im_row[pc][2], im_row[pc][3]);
    st_shared16(at + (odd_first ? 16 : 0), odd_first ? v1 : v0);
    st_shared16(at + (odd_first ? 0 : 16), odd_first ? v0 : v1);
  }
}

template <bool kQuant>
__global__ void __launch_bounds__(kThreads, 1)
beam_kernel(const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
            const __grid_constant__ CUtensorMap tmo, const __grid_constant__ CUtensorMap tmi,
            const int8_t* __restrict__ q, const float* __restrict__ w,
            void* __restrict__ out, float* __restrict__ inc, const Shape s, float qs) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_mem[kStages];
  const uint32_t sm = (smem_u32(smem_raw) + 1023u) & ~1023u, bars = smem_u32(bar_mem);
  const int tid = threadIdx.x, lane = tid & 31;
  const int h = tid >> 7;             // warpgroup: channels 8h .. 8h + 7 of the tile
  const int wl = (tid >> 5) & 3;      // warp of the warpgroup: spectra 16wl ..
  const int g = lane >> 2, t = lane & 3;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kStages; ++i) mbar_init(bars + i * 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  Cursor ld = {static_cast<int>(blockIdx.x), 0, 0, tile_of(s, blockIdx.x)};
  for (int st = 0; st < kStages - 1; ++st) {
    load_stage(s, &tmx, &tmw, q, w, sm, bars, ld);
    advance(ld, s);
  }
  if (s.vec) mbar_wait(bars, 0);
  __syncthreads();
  split_weights(sm, 0, 0, 0);
  split_weights(sm, 0, 0, 1);
  fence_async_proxy();
  __syncthreads();

  float acc[8][16], pw[8][2];
  const uint32_t wp_base = sm + kStages * kRawStage;
  // this thread's A fragment: antennas t and t + 4, spectra 16wl + g and + 8
  const uint32_t frag = t * kXAnt + (16 * wl + g) * 32 + h * 16;
  // `uses` counts the times the ring has gone round: the parity of a slot's
  // mbarrier phase
  int tile = blockIdx.x, stage = 0, slot = 0, wp = 0, uses = 0;
  while (tile < s.n_tiles) {
    if (stage == 0) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        pw[c][0] = pw[c][1] = 0.f;
#pragma unroll
        for (int i = 0; i < 16; ++i) acc[c][i] = 0.f;
      }
    }
    uint32_t a[8][4];
    {
      const uint32_t xs = sm + slot * kRawStage + frag;
      uint4 raw[4];
      raw[0] = ld_shared16(xs);
      raw[1] = ld_shared16(xs + 8 * 32);
      raw[2] = ld_shared16(xs + 4 * kXAnt);
      raw[3] = ld_shared16(xs + 4 * kXAnt + 8 * 32);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t words[4] = {raw[r].x, raw[r].y, raw[r].z, raw[r].w};
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          // int8 -> float without a conversion instruction: the byte, its
          // sign bit flipped (x + 128), set into the mantissa of 2^23 + 2^22,
          // less 2^23 + 2^22 + 128; the bf16 pair is the floats' upper halves
          // (|x| <= 128 has 8 significant bits: exact)
          const uint32_t u = words[c >> 1] ^ 0x80808080u;
          const float re = __uint_as_float(__byte_perm(u, 0x4B400000u, 0x7640 + 2 * (c & 1))) -
                           12583040.f;
          const float im = __uint_as_float(__byte_perm(u, 0x4B400000u, 0x7641 + 2 * (c & 1))) -
                           12583040.f;
          a[c][r] = __byte_perm(__float_as_uint(re), __float_as_uint(im), 0x7632);
          if (inc != nullptr) pw[c][r & 1] = fmaf(re, re, fmaf(im, im, pw[c][r & 1]));
        }
      }
    }
    // the next step's stage, started a step ago, must have landed before its
    // weights are split below (no waiting loop may stand between the wgmma
    // and their wait)
    const int next_slot = slot + 1 == kStages ? 0 : slot + 1;
    const bool last_stage = stage + 1 == s.n_st;
    const bool more = !last_stage || tile + static_cast<int>(gridDim.x) < s.n_tiles;
    if (next_slot == 0) ++uses;
    if (s.vec && more) mbar_wait(bars + next_slot * 8, uses & 1);
    // two batches of 12 wgmma; behind each, while the tensor cores work it
    // off: the start of the copy two steps ahead and half of the split of
    // the next step's weights into the other buffer
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < 8; ++c) {
#pragma unroll
      for (int pc = 2; pc >= 0; --pc)
        wgmma_m64n32k16(acc[c], a[c],
                        wgmma_desc(wp_base + wp * kWpBytes + (8 * h + c) * kWpChan +
                                       pc * kWpPiece,
                                   128, 256));
      if (c == 3) {
        wgmma_commit();
        load_stage(s, &tmx, &tmw, q, w, sm, bars, ld);
        advance(ld, s);
        if (!s.vec) __syncthreads();  // the threads' own copies of the next stage
        if (more) split_weights(sm, next_slot, wp ^ 1, 0);
      }
    }
    wgmma_commit();
    if (more) split_weights(sm, next_slot, wp ^ 1, 1);
    fence_async_proxy();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
      for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(acc[c][i])::"memory");

    if (last_stage) {
      // The tile leaves through shared memory: the weight buffer the wgmma
      // are done with and the ring slot this step has used up.  There each
      // row holds the tile's 16 channels of one (beam, spectrum) (128 B of
      // float32 pairs, 32 B of int8 pairs) or spectrum (64 B of incoherent
      // power), and tensor copies store the boxes, clipped at the edges of
      // the outputs, while the block goes on.  Shapes whose rows are not
      // 16-byte aligned are stored from there element by element.
      __syncthreads();  // every warp's wgmma and fragment reads are done
      const Tile tl = tile_of(s, tile);
      const bool with_inc = inc != nullptr && tl.e0 == 0;
      const int bl = 16 * wl + g;  // this thread: beams 4j + t, spectra bl, bl + 8
      const uint32_t stg = wp_base + wp * kWpBytes, stg_inc = stg + 32768;
      const uint32_t stg2 = sm + slot * kRawStage;
      const size_t beam_stride = static_cast<size_t>(s.n_pols) * s.n_b * s.n_k;
      const size_t row0 = (static_cast<size_t>(tl.p) * s.n_b + tl.b0) * s.n_k + tl.k0;
      if (with_inc) {
        // a fragment holds antennas t and t + 4 of each step: sum the 4 lanes
        // of a spectrum, lane t keeps channels 2t and 2t + 1
#pragma unroll
        for (int c = 0; c < 8; ++c)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            float v = pw[c][half];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            if ((c >> 1) == t)
              asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(
                               stg_inc + (bl + 8 * half) * 64 + (8 * h + c) * 4),
                           "f"(v)
                           : "memory");
          }
      }
      if constexpr (kQuant) {
        // rows (b, e) of 32 B, the warpgroups' halves side by side, in the
        // used-up ring slot (waited for before the slot's next copy)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
            for (int c = 0; c < 8; ++c) {
              const float r = fminf(
                  fmaxf(rintf(__fmul_rn(acc[c][4 * j + 2 * half], qs)), -127.f), 127.f);
              const float i = fminf(
                  fmaxf(rintf(__fmul_rn(acc[c][4 * j + 2 * half + 1], qs)), -127.f), 127.f);
              const uint32_t pair = (static_cast<uint32_t>(static_cast<int>(r)) & 0xff) |
                                    ((static_cast<uint32_t>(static_cast<int>(i)) & 0xff) << 8);
              v[c >> 1] |= pair << (16 * (c & 1));
            }
            st_shared16(stg2 + ((bl + 8 * half) * kNB + 4 * j + t) * 32 + h * 16,
                        make_uint4(v[0], v[1], v[2], v[3]));
          }
        fence_async_proxy();
        __syncthreads();
        if (s.vec) {
          if (tid == 0) {
            if (with_inc) tma_store_3d(&tmi, stg_inc, tl.k0, tl.b0, tl.p);
            bulk_commit();
            tma_store_4d(&tmo, stg2, 2 * tl.k0, tl.e0, tl.b0, tl.p);
            bulk_commit();
            bulk_wait_read<1>();  // the split of the next step writes stg_inc
          }
        } else {
          uint16_t* o = reinterpret_cast<uint16_t*>(out) + row0;
#pragma unroll 1
          for (uint32_t i = tid; i < kNB * kBT * kKT; i += kThreads) {
            const int bb = i >> 8, el = (i >> 4) & (kNB - 1), ch = i & (kKT - 1);
            if (tl.e0 + el < s.n_beams && tl.b0 + bb < s.n_b && tl.k0 + ch < s.n_k)
              o[(tl.e0 + el) * beam_stride + static_cast<size_t>(bb) * s.n_k + ch] =
                  ld_shared2(stg2 + (i >> 4) * 32 + ch * 2);
          }
        }
      } else {
        // four rounds of 4 beams, in turn through the two buffers: rows
        // (b, t) of 8 chunks, chunk u of a row stored at u ^ (row & 7) (the
        // copies' 128-byte swizzle, conflict-free here)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (tl.e0 + 4 * j >= s.n_beams) break;
          const uint32_t buf = !s.vec || (j & 1) == 0 ? stg : stg2;
          if (s.vec ? j >= 2 : j >= 1) {
            if (s.vec && tid == 0) bulk_wait_read<1>();  // this buffer's last round
            __syncthreads();
          }
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const uint32_t row = (bl + 8 * half) * 4 + t, key = (g & 1) * 4 + t;
#pragma unroll
            for (int c = 0; c < 8; c += 2)
              st_shared16(buf + row * 128 + (((4 * h + (c >> 1)) ^ key) * 16),
                          make_uint4(__float_as_uint(acc[c][4 * j + 2 * half]),
                                     __float_as_uint(acc[c][4 * j + 2 * half + 1]),
                                     __float_as_uint(acc[c + 1][4 * j + 2 * half]),
                                     __float_as_uint(acc[c + 1][4 * j + 2 * half + 1])));
          }
          fence_async_proxy();
          __syncthreads();
          if (s.vec) {
            if (tid == 0) {
              tma_store_4d(&tmo, buf, 2 * tl.k0, tl.e0 + 4 * j, tl.b0, tl.p);
              if (j == 0 && with_inc) tma_store_3d(&tmi, stg_inc, tl.k0, tl.b0, tl.p);
              bulk_commit();
            }
          } else {
            float2* o = reinterpret_cast<float2*>(out) + row0 + (tl.e0 + 4 * j) * beam_stride;
#pragma unroll 1
            for (uint32_t i = tid; i < 4 * kBT * kKT; i += kThreads) {
              const uint32_t row = i >> 4, ch = i & (kKT - 1);
              const int bb = row >> 2, tt = row & 3;
              const uint32_t at = buf + row * 128 + (((ch >> 1) ^ (row & 7)) * 16) + (ch & 1) * 8;
              if (tl.e0 + 4 * j + tt < s.n_beams && tl.b0 + bb < s.n_b && tl.k0 + ch < s.n_k)
                o[tt * beam_stride + static_cast<size_t>(bb) * s.n_k + ch] = make_float2(
                    __uint_as_float(ld_shared4(at)), __uint_as_float(ld_shared4(at + 4)));
            }
          }
        }
        // the weight buffer's last round must be read before the next step's
        // split writes it; the slot's is waited for before its next copy
        if (s.vec && tid == 0) {
          if (tl.e0 + 4 * 3 < s.n_beams || ((s.n_beams - tl.e0 + 3) / 4) % 2 == 0)
            bulk_wait_read<1>();  // the newest round lies in the slot
          else
            bulk_wait_read<0>();
        }
      }
      if (with_inc && !s.vec) {
        float* oi = inc + row0;
#pragma unroll 1
        for (uint32_t i = tid; i < kBT * kKT; i += kThreads) {
          const int bb = i >> 4, ch = i & (kKT - 1);
          if (tl.b0 + bb < s.n_b && tl.k0 + ch < s.n_k)
            oi[static_cast<size_t>(bb) * s.n_k + ch] =
                __uint_as_float(ld_shared4(stg_inc + i * 4));
        }
      }
    }
    if (last_stage) stage = 0, tile += gridDim.x;
    else ++stage;
    slot = next_slot, wp ^= 1;
    __syncthreads();
  }
  if (tid == 0) bulk_wait_read<0>();  // shared memory must outlive the stores' reads
}

struct Maps {
  CUtensorMap x, w, out, inc;
};

template <bool kQuant>
int launch(const Maps& m, const int8_t* q, const float* w, void* out, float* inc,
           const Shape& s, float qs, int blocks, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      beam_kernel<kQuant>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  beam_kernel<kQuant><<<blocks, kThreads, kSmemBytes, stream>>>(m.x, m.w, m.out, m.inc, q, w,
                                                                out, inc, s, qs);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled of libcuda, looked up at run time: the library is
// not linked against libcuda, which the CUDA runtime has loaded by then.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    return lib == nullptr ? nullptr
                          : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// The tensor maps of a call: the samples as bytes (2K, B, pols, antennas) with
// a box of one stage's (32 B, 64 spectra, 1 pol, 8 antennas); the weights as
// float32 (2K, beams, antennas) with a box of (32 floats, 16 beams, 8
// antennas) under the 128-byte swizzle; the beams as float32 (2K, beams, B,
// pols) with a box of one round's (32 floats, 4 beams, 64 spectra, 1 pol),
// swizzled, or as bytes with a box of (32 B, 16 beams, 64 spectra, 1 pol);
// the incoherent beam as float32 (K, B, pols) with a box of (16, 64, 1).
int make_maps(const Shape& s, const void* q, const void* w, void* out, void* inc, bool quant,
              Maps* m) {
  CUtensorMap* tmx = &m->x;
  CUtensorMap* tmw = &m->w;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t k2 = 2ull * s.n_k;
  const cuuint64_t xdim[4] = {k2, static_cast<cuuint64_t>(s.n_b),
                              static_cast<cuuint64_t>(s.n_pols),
                              static_cast<cuuint64_t>(s.n_ants)};
  const cuuint64_t xstr[3] = {k2, k2 * s.n_b, k2 * s.n_b * s.n_pols};
  const cuuint32_t xbox[4] = {2 * kKT, kBT, 1, kAS}, one[4] = {1, 1, 1, 1};
  if (encode(tmx, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, const_cast<void*>(q), xdim, xstr, xbox, one,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t wdim[3] = {k2, static_cast<cuuint64_t>(s.n_beams),
                              static_cast<cuuint64_t>(s.n_ants)};
  const cuuint64_t wstr[2] = {4 * k2 * s.n_ants, 4 * k2};
  const cuuint32_t wbox[3] = {2 * kKT, kNB, kAS};
  if (encode(tmw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(w), wdim, wstr, wbox, one,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t row = quant ? k2 : 4 * k2;  // bytes of one (beam, pol, spectrum)
  const cuuint64_t odim[4] = {k2, static_cast<cuuint64_t>(s.n_beams),
                              static_cast<cuuint64_t>(s.n_b), static_cast<cuuint64_t>(s.n_pols)};
  const cuuint64_t ostr[3] = {row * s.n_b * s.n_pols, row, row * s.n_b};
  const cuuint32_t obox[4] = {2 * kKT, quant ? kNB : 4u, kBT, 1};
  if (encode(&m->out, quant ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
             out, odim, ostr, obox, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
             quant ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (inc == nullptr) return 0;
  const cuuint64_t idim[3] = {static_cast<cuuint64_t>(s.n_k), static_cast<cuuint64_t>(s.n_b),
                              static_cast<cuuint64_t>(s.n_pols)};
  const cuuint64_t istr[2] = {4ull * s.n_k, 4ull * s.n_k * s.n_b};
  const cuuint32_t ibox[3] = {kKT, kBT, 1};
  if (encode(&m->inc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, inc, idim, istr, ibox, one,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

}  // namespace

// Plain C entry point (bound with ctypes).  q: int8 (a*p, B, K, 2) wire
// spectra, 2-byte aligned; w: float32 (nb, a, K, 2), 8-byte aligned; out:
// (nb, p, B, K, 2) float32 when qs == 0, int8 when qs > 0; inc: float32
// (p, B, K) or null.  Launches on the current device, which must own
// `stream`.  Returns cudaGetLastError() after the launch.
extern "C" int dcs_beamform(const void* q, const void* w, void* out, void* inc,
                            int n_ants, int n_pols, int n_b, int n_k, int n_beams,
                            float qs, void* stream) {
  if (n_ants < 1 || n_pols < 1 || n_b < 1 || n_k < 1 || n_beams < 1 || !(qs >= 0.f))
    return static_cast<int>(cudaErrorInvalidValue);
  Shape s;
  s.n_ants = n_ants, s.n_pols = n_pols, s.n_b = n_b, s.n_k = n_k, s.n_beams = n_beams;
  s.n_bt = (n_b + kBT - 1) / kBT;
  s.groups = (n_beams + kNB - 1) / kNB;
  s.n_st = (n_ants + kAS - 1) / kAS;
  const long long n_tiles =
      static_cast<long long>((n_k + kKT - 1) / kKT) * s.groups * n_pols * s.n_bt;
  if (n_tiles > (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  s.n_tiles = static_cast<int>(n_tiles);
  s.vec = n_k % 8 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(inc) % 16 == 0;
  Maps maps = {};
  if (s.vec) {
    const int bad = make_maps(s, q, w, out, inc, qs > 0.f, &maps);
    if (bad) return bad;
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = s.n_tiles < sms ? s.n_tiles : sms;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* wp = static_cast<const float*>(w);
  float* ip = static_cast<float*>(inc);
  return qs > 0.f ? launch<true>(maps, qp, wp, out, ip, s, qs, blocks, st)
                  : launch<false>(maps, qp, wp, out, ip, s, qs, blocks, st);
}
