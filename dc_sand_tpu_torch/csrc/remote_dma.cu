// Peer-copy collectives (K7a, K7b) for Hopper, sm_90a.
//
// Replaces the TPU kernels of dc_sand_tpu/parallel/remote_dma.py:
//
//   K7a _ring_kernel (ring_permute_right): one ring step, shard i's block goes
//       whole to shard (i + 1) mod n;
//   K7b _a2a_kernel (all_to_all_pallas): a direct-send all-to-all on the
//       leading axis, row-block s of shard my's input lands in row-block my of
//       shard s's output (its own block included).
//
// The TPU kernels issue make_async_remote_copy DMAs to the other chips and
// wait on DMA semaphores.  Here a launch copies blocks with ordinary loads and
// stores into the receivers' output buffers, addressed by raw device pointers:
// the shards of a mesh may share one card (every shard is an allocation of its
// own, and the kernel still does all the cross-shard copying) or sit on
// different cards, where the stores go to the peer card's memory over NVLink
// (unified addressing, peer access enabled by dcs_enable_peer), or, in
// another process of the node, into its buffer mapped through CUDA IPC into
// the context of the sending card (dcs_ipc_open): every launch runs on the
// card that holds its senders, and every byte crosses NVLink once.  The
// wrapper (dc_sand_tpu_torch/parallel/remote_dma.py) orders the launches with
// stream waits within a process and with device flags between processes in
// place of the DMA semaphores.
//
// Between ranks on different nodes (the staged route,
// dc_sand_tpu_torch/parallel/staged.py) the receiver launches the same
// kernel: each pair's source is the block that arrived in a pinned host
// slot and was copied whole onto the card (a copy-engine transfer into a
// landing buffer), its destination the receiver's own buffer at the
// sender's offset and pitch.  The kernel can read the slot across the bus
// in place (dcs_device_pointer gives its address), and on an H100 80GB HBM3
// at 700 W it placed the fx64 corner-turn's blocks about as fast as the
// landing copy and the kernel together (PERF.md §6); but in place it holds
// the SMs for the whole transfer, landed only for the HBM pass.
//
// Both kernels take, by value, up to 16 (source, destination) pointer pairs
// (the JAX package's contract mesh has 16 shards; 256 B of the 4 KB a launch
// may carry).  K7b's (copy_rows) moves `rows` rows of `row_bytes` a pair: the
// source rows contiguous, the destination rows `dst_pitch` bytes apart.
// One launch carries every pair whose sender sits on the launching card:
// K7a's ring step (one block a pair) and K7b's blocks.  K7b in block mode is
// one row a pair (row-block s of sender my lands whole in row-block my of
// receiver s); in corner-turn mode the sender's block for receiver r is its
// channels [r k_l, (r + 1) k_l) of the F-engine's operand layout (K, 2, s_l,
// b), 2 k_l rows of s_l b bytes, and row (k, c) lands at row (k - r k_l, c),
// streams [my s_l, (my + 1) s_l), of the receiver's (k_l, 2, n s_l, b) CMAC
// operand (pitch n s_l b): no permute before the copy, no reassembly after
// it.  On one card a 4-shard all-to-all (16 pairs) or both 2-shard rings of
// a (2, 2) mesh is one launch.
//
// One block a tile of kUnroll x kThreads 16-byte units; a thread loads all
// kUnroll of its units before it stores them, so a warp keeps kUnroll
// 512-byte loads in flight.  On one card (every pair an HBM copy) the tiles
// are numbered pair after pair, so the card streams through one block at a
// time as back-to-back copies do: on an H100 80GB HBM3 at 700 W one block a
// tile took 1.458 ms for block mode at the fx64 corner-turn against copy_'s
// 1.476, where a grid sized to the SMs walking the tiles took 1.750.  A
// launch whose addresses, row length or pitch are not all multiples of 16
// bytes copies byte by byte.
//
// Across cards the schedule is the TPU kernel's (_a2a_kernel): the wrapper
// passes each sender's pairs to other cards first, in the reference's
// symmetric order, receiver my + j at offset j (Mesh.all_to_all_sends), so
// that at each moment the senders of a group write into different
// receivers (a Latin square), and the local pair (same card: an HBM copy)
// last, a CTA range of its own that runs beside the tail of the remote
// stores instead of taking SM slots from their start.  Before this order,
// every sender of a group wrote into receiver 0 first, then 1, and so on,
// and one receiver's NVLink ingress carried three cards' bytes.  (Tiles
// spread over the remote pairs, tile t to pair t mod their count, were 1-2%
// slower alone on four H100s: PERF.md §6.)  The tile shape was timed for
// the NVLink stores too (dc_sand_tpu_torch/bench/k7b_sizing.py builds the
// kernel with other DCS_K7_THREADS and DCS_K7_UNROLL: PERF.md §6).
//
// What bounds it on the H100: bytes.  Each byte is read once and written
// once, so on one card a call moves 2x its payload at 3.35 TB/s: K7b at the
// fx64 corner-turn (4 shards of int8 (4096, 2, 32, 2048), 537 MB each,
// 2.15 GB in all) has a bound of 2 x 2.15 GB / 3.35 TB/s = 1.282 ms.  Across
// cards the stores of the blocks for other shards cross NVLink at 450 GB/s
// each way per card: 402.7 MB a card, 0.895 ms.  K7a at the SP halo (4
// blocks of 8.4 MB, bound 0.020 ms) is small enough that the launches and
// the host work around them, not the bytes, decide its time: one launch for
// the ring takes 0.054-0.069 ms where four took 0.126 ms (an H100 80GB HBM3
// at 700 W), which is why the pairs of a card share a launch.
//
// Between processes of one node the TPU kernels' DMA semaphores become
// device flags (dc_sand_tpu_torch/parallel/ipc.py): a small uint32 buffer a
// card (dcs_flags_alloc), exported and mapped like the data buffers
// (dcs_ipc_handle, dcs_ipc_open in the context of each card that writes into
// it), waited on by the reader's stream (dcs_wait, cuStreamWaitValue32 ">=
// seq"): the host takes no part, and no kernel spins (two ranks may
// time-slice one card).  K7b's flags are written by the writer's stream
// after its kernel (dcs_signal, cuStreamWriteValue32 with its default memory
// barrier, so the kernel's NVLink stores are visible before the flag), to
// every card of the node's other ranks.
//
// K7a has a kernel of its own (ring_rows) whose semaphores are pairwise, as
// _ring_kernel's send_sem and recv_sem are: a card waits only on its ring
// neighbours in other ranks, and the kernel signals its receiver itself, the
// counterpart of the TPU's DMA engine signalling recv_sem when the copy
// lands (put with signal).  A launch gets, per pair whose receiver is in
// another rank of the node, the receiver card's SENT word mapped in the
// sending card's context, the round's number and a counter on the sending
// card.  Each CTA stores its tile, __syncthreads(), and one thread runs
// fence.acq_rel.sys and counts the tile on the counter of the pair's word; the
// CTA whose add completes the word's tiles resets the counter (the next
// launch on the stream starts after this one) and writes the round's number
// with st.release.sys.  Pairs that write one word (two shards of a card into
// two of one peer card) share its counter, so the word is written once all
// of them have landed.  Without flags ring_rows is a plain copy, launched the
// same way for one process and for the staged route's receivers.  Its tile
// schedule is one CTA a tile, as K7b's: at the SP halo (8.4 MB a card, 512
// tiles of 16 KB, one wave) grids of 1, 2 and 4 CTAs an SM walking the
// tiles took the same time alone within the spread between runs on four
// H100 80GB HBM3 at 700 W (0.034-0.057 ms, PERF.md §6).

#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#define DCS_MAX_PEERS 16

// The (source, destination) pairs of one launch, passed by value.
struct DcsPairs {
  const char* src[DCS_MAX_PEERS];
  char* dst[DCS_MAX_PEERS];
};

// K7a's signals, one entry a pair of a launch, passed by value: flag[d] the
// receiver card's SENT word for pair d, mapped in the sending card's context
// (null: the pair takes no flag), `count` DCS_MAX_PEERS zeroed counters on
// the sending card, `value` the round's number.
struct DcsRingFlags {
  unsigned* flag[DCS_MAX_PEERS];
  unsigned* count;
  unsigned value;
};

namespace {

// the tile: kUnroll x kThreads 16-byte units (DCS_K7_THREADS and
// DCS_K7_UNROLL at build time, for dc_sand_tpu_torch/bench/k7b_sizing.py)
#ifndef DCS_K7_THREADS
#define DCS_K7_THREADS 256
#endif
#ifndef DCS_K7_UNROLL
#define DCS_K7_UNROLL 4
#endif
constexpr int kThreads = DCS_K7_THREADS;
constexpr int kUnroll = DCS_K7_UNROLL;

// `rows` rows of `row_units` units (16 bytes when kVec, else 1) from
// pairs.src[d] (contiguous) to pairs.dst[d] (rows `pitch` units apart), for
// every pair d < n_pairs, one block a tile, the tiles numbered pair after
// pair.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    copy_rows(const __grid_constant__ DcsPairs pairs, int n_pairs, unsigned rows,
              long long row_units, long long pitch) {
  using Unit = typename std::conditional<kVec, uint4, char>::type;
  constexpr int kTile = kUnroll * kThreads;
  // tile indices fit 32 bits (the launch checks): the divisions that place a
  // tile stay short beside its loads
  const unsigned tiles_per_row = static_cast<unsigned>((row_units + kTile - 1) / kTile);
  const unsigned tiles_per_pair = rows * tiles_per_row;
  const unsigned tile = blockIdx.x;
  const unsigned d = n_pairs == 1 ? 0u : tile / tiles_per_pair;
  const unsigned in_pair = tile - d * tiles_per_pair;
  const unsigned row = rows == 1 ? 0u : in_pair / tiles_per_row;
  const long long c0 =
      static_cast<long long>(in_pair - row * tiles_per_row) * kTile + threadIdx.x;
  const Unit* src = reinterpret_cast<const Unit*>(pairs.src[d]) + row * row_units;
  Unit* dst = reinterpret_cast<Unit*>(pairs.dst[d]) + row * pitch;
  Unit v[kUnroll];
#pragma unroll
  for (int i = 0; i < kUnroll; ++i)
    if (c0 + i * kThreads < row_units) v[i] = src[c0 + i * kThreads];
#pragma unroll
  for (int i = 0; i < kUnroll; ++i)
    if (c0 + i * kThreads < row_units) dst[c0 + i * kThreads] = v[i];
}

int launch(const DcsPairs& pairs, int n_pairs, long long rows, long long row_bytes,
           long long dst_pitch, void* stream) {
  if (n_pairs < 1 || n_pairs > DCS_MAX_PEERS || rows < 0 || row_bytes < 0 ||
      (rows > 1 && dst_pitch < row_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  bool vec = row_bytes % 16 == 0 && dst_pitch % 16 == 0;
  for (int d = 0; d < n_pairs; ++d) {
    if (pairs.src[d] == nullptr || pairs.dst[d] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    vec = vec && reinterpret_cast<uintptr_t>(pairs.src[d]) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(pairs.dst[d]) % 16 == 0;
  }
  if (rows == 0 || row_bytes == 0) return static_cast<int>(cudaGetLastError());
  const long long units = vec ? row_bytes / 16 : row_bytes;
  const long long per = kUnroll * kThreads;
  const long long tiles = n_pairs * rows * ((units + per - 1) / per);
  if (tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned grid = static_cast<unsigned>(tiles);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec)
    copy_rows<true><<<grid, kThreads, 0, st>>>(pairs, n_pairs, static_cast<unsigned>(rows),
                                                units, dst_pitch / 16);
  else
    copy_rows<false><<<grid, kThreads, 0, st>>>(pairs, n_pairs, static_cast<unsigned>(rows),
                                                 units, dst_pitch);
  return static_cast<int>(cudaGetLastError());
}

constexpr unsigned char kNoGroup = 0xFF;

// ring_rows' view of the flags: the pairs that write one word form a group,
// numbered in the order of their first pair; need[g] is the group's tiles.
struct RingSignal {
  unsigned* flag[DCS_MAX_PEERS];
  unsigned* count;
  unsigned need[DCS_MAX_PEERS];
  unsigned char group[DCS_MAX_PEERS];
  unsigned value;
};

__device__ __forceinline__ void fence_acq_rel_sys() {
  asm volatile("fence.acq_rel.sys;" ::: "memory");
}

__device__ __forceinline__ void store_release_sys(unsigned* at, unsigned value) {
  asm volatile("st.release.sys.u32 [%0], %1;" ::"l"(at), "r"(value) : "memory");
}

// This CTA's tile of group g is stored: one thread makes it visible to the
// whole system, then counts it; the CTA that completes the group resets its
// counter and writes the round's number into the receiver's word.  Every
// thread of the CTA calls it with the same g.
__device__ __forceinline__ void signal_tile(const RingSignal& sig, unsigned g) {
  if (g == kNoGroup) return;
  __syncthreads();
  if (threadIdx.x == 0) {
    fence_acq_rel_sys();
    if (atomicAdd(sig.count + g, 1u) + 1 == sig.need[g]) {
      fence_acq_rel_sys();  // the other CTAs' counted stores come first
      sig.count[g] = 0;
      store_release_sys(sig.flag[g], sig.value);
    }
  }
}

// K7a: the whole block of `units` units (16 bytes when kVec, else 1) at
// pairs.src[d] to pairs.dst[d], one tile a CTA, the tiles numbered pair
// after pair.  kSignal: the pairs of each group signal their receiver once
// all of them are stored.
template <bool kVec, bool kSignal>
__global__ void __launch_bounds__(kThreads)
    ring_rows(const __grid_constant__ DcsPairs pairs, const __grid_constant__ RingSignal sig,
              unsigned tiles_per_pair, long long units) {
  using Unit = typename std::conditional<kVec, uint4, char>::type;
  constexpr int kTile = kUnroll * kThreads;
  const unsigned d = blockIdx.x / tiles_per_pair;
  const long long c0 =
      static_cast<long long>(blockIdx.x - d * tiles_per_pair) * kTile + threadIdx.x;
  const Unit* src = reinterpret_cast<const Unit*>(pairs.src[d]);
  Unit* dst = reinterpret_cast<Unit*>(pairs.dst[d]);
  Unit v[kUnroll];
#pragma unroll
  for (int i = 0; i < kUnroll; ++i)
    if (c0 + i * kThreads < units) v[i] = src[c0 + i * kThreads];
#pragma unroll
  for (int i = 0; i < kUnroll; ++i)
    if (c0 + i * kThreads < units) dst[c0 + i * kThreads] = v[i];
  if (kSignal) signal_tile(sig, sig.group[d]);
}

int launch_ring(const DcsPairs& pairs, int n_pairs, long long nbytes, const DcsRingFlags& flags,
                void* stream) {
  if (n_pairs < 1 || n_pairs > DCS_MAX_PEERS || nbytes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  bool vec = nbytes % 16 == 0;
  RingSignal sig{};
  sig.count = flags.count;
  sig.value = flags.value;
  unsigned groups = 0, members[DCS_MAX_PEERS] = {};
  for (int d = 0; d < n_pairs; ++d) {
    if (pairs.src[d] == nullptr || pairs.dst[d] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    vec = vec && reinterpret_cast<uintptr_t>(pairs.src[d]) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(pairs.dst[d]) % 16 == 0;
    sig.group[d] = kNoGroup;
    if (flags.flag[d] == nullptr) continue;
    unsigned g = 0;
    while (g < groups && sig.flag[g] != flags.flag[d]) ++g;
    if (g == groups) sig.flag[groups++] = flags.flag[d];
    sig.group[d] = static_cast<unsigned char>(g);
    ++members[g];
  }
  // a flag that no tile would write leaves its receiver waiting: refuse it
  if (groups > 0 && (flags.count == nullptr || nbytes == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (nbytes == 0) return static_cast<int>(cudaGetLastError());
  const long long units = vec ? nbytes / 16 : nbytes;
  const long long per = kUnroll * kThreads;
  const long long tiles_per_pair = (units + per - 1) / per;
  const long long tiles = n_pairs * tiles_per_pair;
  if (tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  for (unsigned g = 0; g < groups; ++g)
    sig.need[g] = members[g] * static_cast<unsigned>(tiles_per_pair);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(tiles),
                 tp = static_cast<unsigned>(tiles_per_pair);
  if (vec && groups > 0)
    ring_rows<true, true><<<grid, kThreads, 0, st>>>(pairs, sig, tp, units);
  else if (vec)
    ring_rows<true, false><<<grid, kThreads, 0, st>>>(pairs, sig, tp, units);
  else if (groups > 0)
    ring_rows<false, true><<<grid, kThreads, 0, st>>>(pairs, sig, tp, units);
  else
    ring_rows<false, false><<<grid, kThreads, 0, st>>>(pairs, sig, tp, units);
  return static_cast<int>(cudaGetLastError());
}

// The driver's stream memory operations and address range, looked up at run
// time in the libcuda.so.1 that the CUDA runtime has loaded (the library is
// not linked against libcuda).  The _v2 entry points are the ones a CUDA 12
// driver serves without the v1 memory-operation switch.
using WriteValue32 = CUresult (*)(CUstream, CUdeviceptr, cuuint32_t, unsigned int);
using WaitValue32 = CUresult (*)(CUstream, CUdeviceptr, cuuint32_t, unsigned int);
using GetAttribute = CUresult (*)(int*, CUdevice_attribute, CUdevice);
using AddressRange = CUresult (*)(CUdeviceptr*, size_t*, CUdeviceptr);

struct Driver {
  WriteValue32 write32 = nullptr;
  WaitValue32 wait32 = nullptr;
  GetAttribute attribute = nullptr;
  AddressRange range = nullptr;
};

void* symbol(void* lib, const char* v2, const char* v1) {
  void* fn = dlsym(lib, v2);
  return fn != nullptr || v1 == nullptr ? fn : dlsym(lib, v1);
}

const Driver& driver() {
  static const Driver drv = [] {
    Driver d;
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (lib == nullptr) return d;
    d.write32 = reinterpret_cast<WriteValue32>(
        symbol(lib, "cuStreamWriteValue32_v2", "cuStreamWriteValue32"));
    d.wait32 = reinterpret_cast<WaitValue32>(
        symbol(lib, "cuStreamWaitValue32_v2", "cuStreamWaitValue32"));
    d.attribute = reinterpret_cast<GetAttribute>(symbol(lib, "cuDeviceGetAttribute", nullptr));
    d.range = reinterpret_cast<AddressRange>(
        symbol(lib, "cuMemGetAddressRange_v2", "cuMemGetAddressRange"));
    return d;
  }();
  return drv;
}

// CUDA_ERROR_NOT_FOUND's value: a driver entry point this library needs is
// missing
constexpr int kMissing = 500;

}  // namespace

// K7b, every sender of one card: pair d moves `rows` rows of `row_bytes`
// from pairs.src[d] (contiguous) to pairs.dst[d] (rows `dst_pitch` bytes
// apart), d < n_pairs, in the order given.  Launches on the current device,
// which must own `stream`; returns cudaGetLastError().
extern "C" int dcs_all_to_all(DcsPairs pairs, int n_pairs, long long rows, long long row_bytes,
                              long long dst_pitch, void* stream) {
  return launch(pairs, n_pairs, rows, row_bytes, dst_pitch, stream);
}

// K7a, every sender of one card: the whole block of nbytes at pairs.src[d]
// goes to pairs.dst[d] (its right neighbour's output), d < n_pairs, and each
// pair with a flag (flags.flag[d] not null) writes flags.value into it once
// every pair of that flag is stored (ring_rows).  Launches on the current
// device, which must own `stream`; returns cudaGetLastError().
extern "C" int dcs_ring(DcsPairs pairs, int n_pairs, long long nbytes, DcsRingFlags flags,
                        void* stream) {
  return launch_ring(pairs, n_pairs, nbytes, flags, stream);
}

// What `device` offers the device flags: `memops` the driver's
// CU_DEVICE_ATTRIBUTE_CAN_USE_STREAM_MEM_OPS_V1 (92), `flush`
// CU_DEVICE_ATTRIBUTE_CAN_FLUSH_REMOTE_WRITES (98); then a write and a
// ">=" wait on a word of the device's own memory, on `stream`, whose
// results are returned (0 both: the operations run).  kMissing when the
// driver lacks an entry point.
extern "C" int dcs_memops_probe(int device, int* memops, int* flush, void* word, void* stream) {
  const Driver& drv = driver();
  if (drv.write32 == nullptr || drv.wait32 == nullptr || drv.attribute == nullptr)
    return kMissing;
  CUresult r = drv.attribute(memops, static_cast<CUdevice_attribute>(92), device);
  if (r == CUDA_SUCCESS) r = drv.attribute(flush, static_cast<CUdevice_attribute>(98), device);
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  CUstream st = static_cast<CUstream>(stream);
  const CUdeviceptr at = reinterpret_cast<CUdeviceptr>(word);
  r = drv.write32(st, at, 1u, 0);
  if (r == CUDA_SUCCESS) r = drv.wait32(st, at, 1u, CU_STREAM_WAIT_VALUE_GEQ);
  return static_cast<int>(r);
}

// `bytes` of zeroed device memory of its own allocation on the current
// device, for the flags, and its IPC handle (64 bytes at `handle`).
extern "C" int dcs_flags_alloc(long long bytes, void** ptr, void* handle) {
  cudaError_t err = cudaMalloc(ptr, static_cast<size_t>(bytes));
  if (err == cudaSuccess) err = cudaMemset(*ptr, 0, static_cast<size_t>(bytes));
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  return static_cast<int>(err);
}

extern "C" int dcs_free(void* ptr) { return static_cast<int>(cudaFree(ptr)); }

// The IPC handle (64 bytes at `handle`) of the allocation that holds device
// address `ptr`, and `ptr`'s byte offset in it: a tensor of PyTorch's caching
// allocator may lie inside a larger allocation.
extern "C" int dcs_ipc_handle(const void* ptr, void* handle, long long* offset) {
  const Driver& drv = driver();
  if (drv.range == nullptr) return kMissing;
  CUdeviceptr base = 0;
  size_t size = 0;
  CUresult r = drv.range(&base, &size, reinterpret_cast<CUdeviceptr>(ptr));
  if (r != CUDA_SUCCESS) return static_cast<int>(r);
  *offset = static_cast<long long>(reinterpret_cast<CUdeviceptr>(ptr) - base);
  return static_cast<int>(
      cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), reinterpret_cast<void*>(base)));
}

// Map another process's allocation (its 64-byte IPC handle) into the current
// device's context, the card whose kernels and streams write into it or read
// it: parallel/ipc.py maps each peer buffer once a handle and card this way,
// for the writers' kernels and the readers' views alike.
extern "C" int dcs_ipc_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return static_cast<int>(cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

// Unmap what dcs_ipc_open mapped, in the same device's context.
extern "C" int dcs_ipc_close(void* ptr) { return static_cast<int>(cudaIpcCloseMemHandle(ptr)); }

// After the work enqueued so far on `stream`: write `value` into each of the
// `n` 32-bit words at `addrs` (peers' flag slots mapped into this device's
// context, which must be current), each write preceded by the default memory
// barrier.
extern "C" int dcs_signal(void* stream, const unsigned long long* addrs, int n, unsigned value) {
  const Driver& drv = driver();
  if (drv.write32 == nullptr) return kMissing;
  for (int k = 0; k < n; ++k) {
    CUresult r = drv.write32(static_cast<CUstream>(stream), static_cast<CUdeviceptr>(addrs[k]),
                             value, CU_STREAM_WRITE_VALUE_DEFAULT);
    if (r != CUDA_SUCCESS) return static_cast<int>(r);
  }
  return 0;
}

// Make `stream` wait until each of the `n` words at `addrs` (this device's own
// flag slots) reads >= `value` in the driver's cyclic comparison.  No flush of
// remote writes (CAN_FLUSH_REMOTE_WRITES reads 0 on the H100): the writer's
// memory barrier orders its stores before the flag.
extern "C" int dcs_wait(void* stream, const unsigned long long* addrs, int n, unsigned value) {
  const Driver& drv = driver();
  if (drv.wait32 == nullptr) return kMissing;
  for (int k = 0; k < n; ++k) {
    CUresult r = drv.wait32(static_cast<CUstream>(stream), static_cast<CUdeviceptr>(addrs[k]),
                            value, CU_STREAM_WAIT_VALUE_GEQ);
    if (r != CUDA_SUCCESS) return static_cast<int>(r);
  }
  return 0;
}

// The address at which the current device's kernels read the pinned host
// memory at `host` (a staged route's receive slot, read in place across the
// bus: the alternative to landing it that chip_smoke.py times):
// cudaErrorInvalidValue unless it is host memory the card can address.
extern "C" int dcs_device_pointer(const void* host, void** dev) {
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, host);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (attr.type != cudaMemoryTypeHost || attr.devicePointer == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  *dev = attr.devicePointer;
  return static_cast<int>(cudaSuccess);
}

// Let the current device's kernels address `peer`'s memory (both on this host,
// torch.cuda.can_device_access_peer true).  An access already enabled is not
// an error.
extern "C" int dcs_enable_peer(int peer) {
  cudaError_t err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the error it recorded
    err = cudaSuccess;
  }
  return static_cast<int>(err);
}
