// Packed X-engine CMAC (K2/K3) for Hopper, sm_90a.
//
// Replaces the TPU kernels of dc_sand_tpu/ops/xcorr.py: the native CMAC family
// _cmac_native_kernel_pipe, _cmac_native_kernel_single and _cmac_native_kernel
// (launched by xcorr_accumulate_native), and _cmac_kernel (launched by
// _xcorr_accumulate_pallas).  The operand is K3's stacked a2 = [Ar; Ai],
// int8 (K, 2ap, B), the fused F-engine's operand layout (K, 2, S, B) viewed.
// Per channel k the packed int32 plane acc (K, ap, ap) is updated in place:
//
//   acc[k, r, c] = acc[k, r, c] * keep + sum_b Ar[r]Ar[c] + Ai[r]Ai[c]   (r <= c)
//   acc[k, r, c] = acc[k, r, c] * keep + sum_b Ai[r]Ar[c] - Ar[r]Ai[c]   (r >  c)
//
// keep = 0 is the integration-window reset of K2 (xcorr.py:555-557).  All
// arithmetic is integer (the int32 sums wrap as the plain version's add_), so
// the result equals the plain version bitwise.
//
// What bounds it on the H100: bytes.  At fx64 (K = 4096, ap = 128, B = 2048)
// a call reads 2.15 GB of operand and reads and writes 0.27 GB of
// accumulator: 0.80 ms at 3.35 TB/s, against 0.28 ms for its 0.55 T useful
// int8 operations at the 1979 TOP/s data-sheet peak.  The first cut (one CTA
// a 64 x 64 tile, cp.async, mma.sync fed by 32-bit shared loads) took 2.2 ms:
// each operand byte crossed the L2 four times, and its own load and fragment
// instructions held the SM.
//
// Design: persistent CTAs, one an SM, walk work units (channel, 128-row
// block I, 128-column block J); for ap <= 128 a unit is a channel's whole
// plane, so each operand byte reaches an SM once.  A producer warp streams
// the unit's operand through a ring of kSlots slots with tensor (TMA)
// copies that complete on the slots' mbarriers: a slot holds 128 spectra
// of the 128 Ar rows and the 128 Ai rows of a block (2 x 16 KB, one
// 128-byte swizzled row a stream), rows past ap and spectra past B
// zero-filled by the copy.  Two consumer warpgroups multiply from shared
// memory with wgmma.mma_async m64nNk32 s8.s8 -> s32 (the spectra axis is
// K-major, as int8 wgmma needs) and free each slot when its products are
// done.  A diagonal unit (I = J: every unit when ap <= 128) forms
// vr = Ar Ar^T + Ai Ai^T where the packed plane keeps it and W = Ai Ar^T
// once, vi = W - W^T being taken in the epilogue (int8 wgmma cannot
// negate an operand); the warpgroups split its 10 of 16 64 x 64 products
// evenly:
//
//   warpgroup 0, rows 0-63:   vr cols 0-127 (2 x n128), W cols 0-63 (n64)
//   warpgroup 1, rows 64-127: W cols 0-127 (n128), vr cols 64-127 (2 x n64),
//                             W rows 0-63 cols 64-127 (n64)
//
// An off-diagonal unit (ap > 128) holds the rows' and the columns' blocks in
// two slots a stage: above the diagonal it forms vr (2 x n128 a
// warpgroup), below it vi = Ai_I Ar_J^T - Ar_I Ai_J^T as two sums
// (n128 + 2 x n64).  The epilogue selects the packed element in registers
// and stages the tile in shared memory under the 128-byte swizzle (each W
// element that another thread needs for W - W^T is written to the place
// of its transpose first), and one thread a warpgroup hands its 64 rows
// to tensor stores: with keep = 1 a reduce-add (cp.reduce.async.bulk
// .tensor .add on s32), so the SM never reads the accumulator; with keep =
// 0 a plain store.  They run on while the warpgroups start the next unit,
// into which the producer has already run ahead.  A plane whose rows are
// not 16-byte aligned (ap % 4 != 0) cannot have a tensor map: its tile is
// stored element by element from the staging by the warpgroup.
//
// Built with -DDCS_CMAC_PHASES (dc_sand_tpu_torch/bench/cmac_phases.py) the
// producer thread and thread 0 of each consumer warpgroup add the clock64
// ticks of their phases to device counters that dcs_cmac_phases reads.

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int kT = 128;                      // rows and columns of a unit
constexpr int kBK = 128;                     // spectra a stage: one swizzled row
constexpr int kTileBytes = kT * kBK;         // one block's Ar (or Ai) of a stage
constexpr int kSlotBytes = 2 * kTileBytes;   // Ar then Ai
constexpr int kSlots = 4;                    // ring depth (a power of 2)
constexpr int kColBox = 32;                  // int32 columns of a staging box (128 B)
constexpr int kBoxBytes = kT * kColBox * 4;  // staging: 4 boxes of 128 rows
constexpr int kStagingBytes = 4 * kBoxBytes;
constexpr int kConsumers = 256;              // two warpgroups
constexpr int kThreads = kConsumers + 128;   // and the producer's warpgroup
// + 1024: the kernel aligns its base, the swizzled boxes need it
constexpr int kSmemBytes = kSlots * kSlotBytes + kStagingBytes + 1024;

// what a warpgroup computes of a unit (the file's header)
enum Role { kDiag0, kDiag1, kUpper, kLower };

#ifdef DCS_CMAC_PHASES
// producer: waiting for a free slot, issuing; consumers: waiting for a full
// slot, the products (issue and the wait for the previous stage's), epilogue
constexpr int kPhases = 5;
__device__ unsigned long long g_phase_clocks[kPhases];
#endif

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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

// Tensor (TMA) copy of one box into shared memory, whatever of the box lies
// outside the tensor zero-filled; it completes on the mbarrier.
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], "
      "[%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
// Tensor copies of one box from shared memory, clipped at the edges of the
// tensor: a plain store, or an element-wise add into what is there.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_reduce_add_3d(const CUtensorMap* map, uint32_t src, int c0,
                                                  int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group [%0, {%2, %3, %4}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// the stores so far have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// the stores so far are done
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// generic-proxy writes to shared memory made visible to the tensor stores
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// barrier of one warpgroup (ids 1, 2; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

__device__ __forceinline__ void st_shared4(uint32_t dst, int v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(dst), "r"(v) : "memory");
}
__device__ __forceinline__ void st_shared8(uint32_t dst, int v0, int v1) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(dst), "r"(v0), "r"(v1) : "memory");
}
__device__ __forceinline__ int ld_shared4(uint32_t src) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(src) : "memory");
  return v;
}
__device__ __forceinline__ int2 ld_shared8(uint32_t src) {
  int2 v;
  asm volatile("ld.shared.v2.b32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(src) : "memory");
  return v;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Shared-memory matrix descriptor of a K-major operand under the 128-byte
// swizzle (as the tensor copy writes it): rows of 128 B, 8-row groups 1024 B
// apart (SBO), the leading offset unused; the start advances 32 B a k-step.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// d (64 x 128 s32, 64 registers a thread) += A (64 rows) . B (128 rows)^T over 32
// spectra, both K-major in shared memory under the 128-byte swizzle; acc = 0
// overwrites d
__device__ __forceinline__ void mma_n128(int (&d)[64], uint32_t a, uint32_t b, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]),
        "+r"(d[63])
      : "l"(desc_sw128(a)), "l"(desc_sw128(b)), "r"(acc));
}

// d (64 x 64 s32, 32 registers a thread) += A (64 rows) . B (64 rows)^T over 32
// spectra, both K-major in shared memory under the 128-byte swizzle; acc = 0
// overwrites d
__device__ __forceinline__ void mma_n64(int (&d)[32], uint32_t a, uint32_t b, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),
        "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]),
        "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(desc_sw128(a)), "l"(desc_sw128(b)), "r"(acc));
}

struct Shape {
  int ap;
  int n_st;     // stages a unit: ceil(B / kBK)
  int nb;       // 128-blocks a side: ceil(ap / kT)
  int n_units;  // channels x nb x nb
  int keep;
  int tma_out;  // the accumulator has a tensor map (rows 16-byte aligned)
};

#ifdef DCS_CMAC_PHASES
#define DCS_CLOCK(name) const long long name = clock64()
#else
#define DCS_CLOCK(name)
#endif

// What a consumer thread keeps across units: where the ring, its barriers
// and the staging lie, its place in the warpgroup, and its phase ticks.
struct Consumer {
  const CUtensorMap* tmo;
  int* acc;
  Shape s;
  uint32_t ring, stg, full, empty;
  int wg, wl, g, t4, lane;
  unsigned long long wait_ticks, mma_ticks, epi_ticks;
};

// Shared address of element (r, c) of the staged 128 x 128 int32 tile:
// four boxes of 32 columns, row r of a box at 128 r, its 16-byte chunk u at
// u ^ (r & 7) (the tensor copies' 128-byte swizzle; a warp's fragment
// stores and transposed stores are conflict-free under it).
__device__ __forceinline__ uint32_t stg_at(uint32_t stg, int r, int c) {
  return stg + (c >> 5) * kBoxBytes + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) + (c & 3) * 4;
}

// Free the ring slots of the stage whose first slot use was `it`: one
// arrival a consumer warp.
template <int kPer>
__device__ __forceinline__ void release(const Consumer& x, int it) {
  if (x.lane == 0) {
#pragma unroll
    for (int h = 0; h < kPer; ++h) mbar_arrive(x.empty + 8 * ((it + h) & (kSlots - 1)));
  }
}

// The epilogue of a unit: the packed element selected in registers and
// staged, then stored (keep = 0) or added (keep = 1) to block (bi, bj) of
// channel k.  Fragment element 4i + 2h + e of an accumulator is row
// 16 wl + g + 8h of the warpgroup's 64 and column 8i + 2 t4 + e.
template <int kRole>
__device__ __forceinline__ void epilogue(const Consumer& x, const int (&d0)[64],
                                         const int (&d1)[32], const int (&d2)[32], int k, int bi,
                                         int bj) {
  const int tw = threadIdx.x & 127;
  if (tw == 0 && x.s.tma_out) bulk_wait_read();  // the last unit's stores have read the staging
  wg_sync(x.wg);
  const int r0 = 64 * x.wg + 16 * x.wl + x.g;  // tile row of this thread's h = 0 elements
  // 1. Diagonal units: each W element above the diagonal goes to the place
  // of its transpose, where the thread that holds the element below reads it.
  if constexpr (kRole == kDiag0) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = r0 + 8 * h, c = 8 * i + 2 * x.t4 + e;
          if (r < c) st_shared4(stg_at(x.stg, c, r), d1[4 * i + 2 * h + e]);
        }
  } else if constexpr (kRole == kDiag1) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = r0 + 8 * h, c = 64 + 8 * i + 2 * x.t4 + e;
          st_shared4(stg_at(x.stg, c, r - 64), d2[4 * i + 2 * h + e]);  // W rows 0-63
          if (r < c) st_shared4(stg_at(x.stg, c, r), d0[32 + 4 * i + 2 * h + e]);
        }
  }
  if constexpr (kRole == kDiag0 || kRole == kDiag1) wg_sync(x.wg);
  // 2. The packed element into its place.
#pragma unroll
  for (int i = 0; i < 16; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h, c = 8 * i + 2 * x.t4, q = 4 * i + 2 * h;
      const uint32_t at = stg_at(x.stg, r, c);
      int v0 = d0[q], v1 = d0[q + 1];
      if constexpr (kRole == kDiag0) {
        if (i < 8) {  // vr on and above the diagonal, W - W^T below it
          const int2 t = ld_shared8(at);
          if (r > c) v0 = d1[q] - t.x;
          if (r > c + 1) v1 = d1[q + 1] - t.y;
        }
      } else if constexpr (kRole == kDiag1) {
        const int2 t = ld_shared8(at);
        if (i < 8) {  // below the diagonal
          v0 -= t.x, v1 -= t.y;
        } else {
          v0 = r <= c ? d1[q - 32] : v0 - t.x;
          v1 = r <= c + 1 ? d1[q - 31] : v1 - t.y;
        }
      } else if constexpr (kRole == kLower) {
        if (i < 8) {
          v0 -= d1[q], v1 -= d1[q + 1];
        } else {
          v0 -= d2[q - 32], v1 -= d2[q - 31];
        }
      }
      st_shared8(at, v0, v1);
    }
  fence_async_proxy();
  wg_sync(x.wg);
  // 3. The warpgroup's 64 rows to the accumulator.
  const int ap = x.s.ap, row0 = bi * kT + 64 * x.wg, col0 = bj * kT;
  if (x.s.tma_out) {
    if (tw == 0) {
      if (row0 < ap) {
#pragma unroll 1
        for (int b = 0; b < kT / kColBox && col0 + kColBox * b < ap; ++b) {
          const uint32_t src = x.stg + b * kBoxBytes + 64 * x.wg * 128;
          if (x.s.keep)
            tma_reduce_add_3d(x.tmo, src, col0 + kColBox * b, row0, k);
          else
            tma_store_3d(x.tmo, src, col0 + kColBox * b, row0, k);
        }
      }
      bulk_commit();
    }
  } else {
#pragma unroll 1
    for (int i = tw; i < 64 * kT; i += 128) {
      const int rr = i / kT, c = i % kT;
      if (row0 + rr < ap && col0 + c < ap) {
        const int v = ld_shared4(stg_at(x.stg, 64 * x.wg + rr, c));
        int* dst = x.acc + (static_cast<size_t>(k) * ap + row0 + rr) * ap + col0 + c;
        *dst = x.s.keep ? *dst + v : v;
      }
    }
  }
}

// One unit of a consumer warpgroup: its products over every stage (the
// file's header has who computes what), then the epilogue.  `it` counts
// the ring's slot uses; a slot's uses / kSlots gives its mbarrier's parity.
template <int kRole>
__device__ __forceinline__ void run_unit(Consumer& x, int& it, int k, int bi, int bj) {
  constexpr int kPer = kRole == kUpper || kRole == kLower ? 2 : 1;  // slots a stage
  const uint32_t rw = x.wg * 64 * kBK;  // this warpgroup's rows of a block's tile
  int d0[64], d1[32], d2[32];
#pragma unroll 1
  for (int st = 0; st < x.s.n_st; ++st) {
    DCS_CLOCK(c0);
    const int sr = it & (kSlots - 1), sc = (it + kPer - 1) & (kSlots - 1);
    mbar_wait(x.full + 8 * sr, (it / kSlots) & 1);
    if (kPer == 2) mbar_wait(x.full + 8 * sc, ((it + 1) / kSlots) & 1);
    DCS_CLOCK(c1);
    // rows' blocks (I) in slot sr, columns' (J) in slot sc: the same slot
    // for a diagonal unit
    const uint32_t ar = x.ring + sr * kSlotBytes, ai = ar + kTileBytes;
    const uint32_t cr = x.ring + sc * kSlotBytes, ci = cr + kTileBytes;
    constexpr uint32_t kHalf = 64 * kBK;  // rows 64-127 of a tile
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      const uint32_t o = 32 * kk;
      const int f = (st | kk) != 0;  // 0: the unit's first product overwrites
      if constexpr (kRole == kDiag0) {
        mma_n128(d0, ar + o, cr + o, f);  // vr rows 0-63, cols 0-127
        mma_n128(d0, ai + o, ci + o, 1);
        mma_n64(d1, ai + o, cr + o, f);  // W rows 0-63, cols 0-63
      } else if constexpr (kRole == kDiag1) {
        mma_n128(d0, ai + kHalf + o, cr + o, f);  // W rows 64-127, cols 0-127
        mma_n64(d1, ar + kHalf + o, cr + kHalf + o, f);  // vr rows 64-127, cols 64-127
        mma_n64(d1, ai + kHalf + o, ci + kHalf + o, 1);
        mma_n64(d2, ai + o, cr + kHalf + o, f);  // W rows 0-63, cols 64-127
      } else if constexpr (kRole == kUpper) {
        mma_n128(d0, ar + rw + o, cr + o, f);  // vr
        mma_n128(d0, ai + rw + o, ci + o, 1);
      } else {
        mma_n128(d0, ai + rw + o, cr + o, f);  // Ai_I Ar_J^T
        mma_n64(d1, ar + rw + o, ci + o, f);  // Ar_I Ai_J^T, cols 0-63
        mma_n64(d2, ar + rw + o, ci + kHalf + o, f);  // and 64-127
      }
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous stage's products are done: free its slots
    if (st > 0) release<kPer>(x, it - kPer);
    it += kPer;
#ifdef DCS_CMAC_PHASES
    x.wait_ticks += c1 - c0;
    x.mma_ticks += clock64() - c1;
#endif
  }
  wgmma_wait<0>();
  release<kPer>(x, it - kPer);
  // the products are in the registers now, not before
#pragma unroll
  for (int q = 0; q < 64; ++q) asm volatile("" : "+r"(d0[q])::"memory");
  if constexpr (kRole != kUpper) {
#pragma unroll
    for (int q = 0; q < 32; ++q) asm volatile("" : "+r"(d1[q])::"memory");
  }
  if constexpr (kRole == kDiag1 || kRole == kLower) {
#pragma unroll
    for (int q = 0; q < 32; ++q) asm volatile("" : "+r"(d2[q])::"memory");
  }
  DCS_CLOCK(c2);
  epilogue<kRole>(x, d0, d1, d2, k, bi, bj);
#ifdef DCS_CMAC_PHASES
  x.epi_ticks += clock64() - c2;
#endif
}

__global__ void __launch_bounds__(kThreads, 1)
cmac_kernel(const __grid_constant__ CUtensorMap tma, const __grid_constant__ CUtensorMap tmo,
            int* __restrict__ acc, const Shape s) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bar_mem[2 * kSlots];
  const uint32_t sm = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = smem_u32(bar_mem), empty = full + 8 * kSlots;
  const int tid = threadIdx.x, per_chan = s.nb * s.nb;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      mbar_init(full + 8 * i, 1);                  // the producer's arrival and the bytes
      mbar_init(empty + 8 * i, kConsumers / 32);   // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid >= kConsumers) {
    // The producer: one thread streams every unit's stages into the ring.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == kConsumers) {
#ifdef DCS_CMAC_PHASES
      unsigned long long wait_ticks = 0, issue_ticks = 0;
#endif
      int it = 0;
#pragma unroll 1
      for (int u = blockIdx.x; u < s.n_units; u += gridDim.x) {
        const int k = u / per_chan, t = u % per_chan, bi = t / s.nb, bj = t % s.nb;
#pragma unroll 1
        for (int st = 0; st < s.n_st; ++st)
#pragma unroll 1
          for (int h = 0; h < (bi == bj ? 1 : 2); ++h, ++it) {
            const int slot = it & (kSlots - 1);
            DCS_CLOCK(c0);
            mbar_wait(empty + 8 * slot, ((it / kSlots) & 1) ^ 1);
            DCS_CLOCK(c1);
            const uint32_t dst = sm + slot * kSlotBytes, bar = full + 8 * slot;
            const int row = (h ? bj : bi) * kT;
            mbar_expect(bar, kSlotBytes);
            tma_load_3d(dst, &tma, bar, st * kBK, row, 2 * k);                // Ar
            tma_load_3d(dst + kTileBytes, &tma, bar, st * kBK, row, 2 * k + 1);  // Ai
#ifdef DCS_CMAC_PHASES
            wait_ticks += c1 - c0;
            issue_ticks += clock64() - c1;
#endif
          }
      }
#ifdef DCS_CMAC_PHASES
      atomicAdd(&g_phase_clocks[0], wait_ticks);
      atomicAdd(&g_phase_clocks[1], issue_ticks);
#endif
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    Consumer x;
    x.tmo = &tmo, x.acc = acc, x.s = s;
    x.ring = sm, x.stg = sm + kSlots * kSlotBytes, x.full = full, x.empty = empty;
    x.wg = tid >> 7, x.wl = (tid >> 5) & 3, x.lane = tid & 31;
    x.g = x.lane >> 2, x.t4 = x.lane & 3;
    x.wait_ticks = x.mma_ticks = x.epi_ticks = 0;
    int it = 0;
#pragma unroll 1
    for (int u = blockIdx.x; u < s.n_units; u += gridDim.x) {
      const int k = u / per_chan, t = u % per_chan, bi = t / s.nb, bj = t % s.nb;
      if (bi == bj) {
        if (x.wg == 0)
          run_unit<kDiag0>(x, it, k, bi, bj);
        else
          run_unit<kDiag1>(x, it, k, bi, bj);
      } else if (bi < bj) {
        run_unit<kUpper>(x, it, k, bi, bj);
      } else {
        run_unit<kLower>(x, it, k, bi, bj);
      }
    }
    if ((tid & 127) == 0) {
      bulk_wait();  // the stores are done before the CTA's shared memory goes
#ifdef DCS_CMAC_PHASES
      atomicAdd(&g_phase_clocks[2], x.wait_ticks);
      atomicAdd(&g_phase_clocks[3], x.mma_ticks);
      atomicAdd(&g_phase_clocks[4], x.epi_ticks);
#endif
    }
  }
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

}  // namespace

// Plain C entry point (bound with ctypes).  a2: int8 (K, 2ap, B) device
// pointer, 16-byte aligned, B % 16 == 0; acc: int32 (K, ap, ap), updated in
// place; keep: 0 or 1.  Launches on the current device, which must own
// `stream`.  Returns cudaGetLastError() after the launch.
extern "C" int dcs_cmac(const void* a2, void* acc, int n_chans, int ap, int n_b, int keep,
                        void* stream) {
  if (n_chans < 1 || n_chans > 65535 || ap < 1 || n_b < 16 || n_b % 16 ||
      (keep != 0 && keep != 1) || reinterpret_cast<uintptr_t>(a2) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  Shape s;
  s.ap = ap, s.keep = keep;
  s.n_st = (n_b + kBK - 1) / kBK;
  s.nb = (ap + kT - 1) / kT;
  const long long n_units = static_cast<long long>(n_chans) * s.nb * s.nb;
  if (n_units > (1 << 30)) return static_cast<int>(cudaErrorInvalidValue);
  s.n_units = static_cast<int>(n_units);
  s.tma_out = ap % 4 == 0 && reinterpret_cast<uintptr_t>(acc) % 16 == 0;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  // the operand as bytes (B, ap, 2K): plane 2k is channel k's Ar, 2k + 1 its
  // Ai; a box is one stage of one block, 128 spectra x 128 rows, swizzled
  CUtensorMap tma, tmo = {};
  const cuuint32_t one[3] = {1, 1, 1};
  const cuuint64_t adim[3] = {static_cast<cuuint64_t>(n_b), static_cast<cuuint64_t>(ap),
                              2ull * n_chans};
  const cuuint64_t astr[2] = {static_cast<cuuint64_t>(n_b),
                              static_cast<cuuint64_t>(n_b) * static_cast<cuuint64_t>(ap)};
  const cuuint32_t abox[3] = {kBK, kT, 1};
  if (encode(&tma, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(a2), adim, astr, abox, one,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  // the accumulator as int32 (ap, ap, K); a box is 32 columns x 64 rows
  if (s.tma_out) {
    const cuuint64_t odim[3] = {static_cast<cuuint64_t>(ap), static_cast<cuuint64_t>(ap),
                                static_cast<cuuint64_t>(n_chans)};
    const cuuint64_t ostr[2] = {4ull * ap, 4ull * ap * ap};
    const cuuint32_t obox[3] = {kColBox, 64, 1};
    if (encode(&tmo, CU_TENSOR_MAP_DATA_TYPE_INT32, 3, acc, odim, ostr, obox, one,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cmac_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = s.n_units < sms ? s.n_units : sms;
  cmac_kernel<<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      tma, tmo, static_cast<int*>(acc), s);
  return static_cast<int>(cudaGetLastError());
}

#ifdef DCS_CMAC_PHASES
extern "C" const char* dcs_cmac_phase_names() {
  return "producer.wait_empty,producer.issue,consumer.wait_full,consumer.mma,consumer.epilogue";
}

// The summed phase clocks since the last call (which zeroes them).
extern "C" int dcs_cmac_phases(unsigned long long* clocks) {
  cudaError_t err = cudaMemcpyFromSymbol(clocks, g_phase_clocks, sizeof(g_phase_clocks));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[kPhases] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_phase_clocks, zero, sizeof(zero)));
}
#endif
