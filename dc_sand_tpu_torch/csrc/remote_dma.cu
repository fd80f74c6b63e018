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
// (unified addressing, peer access enabled by dcs_enable_peer).  The wrapper
// (dc_sand_tpu_torch/parallel/remote_dma.py) orders the launches with stream
// events in place of the DMA semaphores.
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
// One kernel serves both: it takes, by value, up to 16 (source, destination)
// pointer pairs (the JAX package's contract mesh has 16 shards; 256 B of the
// 4 KB a launch may carry), and every pair moves `rows` rows of `row_bytes`:
// the source rows contiguous, the destination rows `dst_pitch` bytes apart.
// One launch carries every pair whose sender sits on the launching card:
// K7a's ring step (one row a pair) and K7b's blocks.  K7b in block mode is
// one row a pair (row-block s of sender my lands whole in row-block my of
// receiver s); in corner-turn mode the sender's block for receiver r is its
// channels [r k_l, (r + 1) k_l) of the F-engine's operand layout (K, 2, s_l,
// b), 2 k_l rows of s_l b bytes, and row (k, c) lands at row (k - r k_l, c),
// streams [my s_l, (my + 1) s_l), of the receiver's (k_l, 2, n s_l, b) CMAC
// operand (pitch n s_l b): no permute before the copy, no reassembly after
// it.  On one card a 4-shard all-to-all (16 pairs) or both 2-shard rings of
// a (2, 2) mesh is one launch.
//
// One block a tile of kUnroll x kThreads 16-byte units, the tiles of all
// pairs numbered pair after pair (two short divisions a tile find its pair
// and row), so the card streams through one block at a time as back-to-back
// copies do.  A thread loads all kUnroll of its units before it stores
// them, so a warp keeps kUnroll 512-byte loads in flight.  On an H100 80GB
// HBM3 at 700 W a grid sized to the SMs (8 blocks each) walking the tiles
// in a loop took 1.750 ms for block mode at the fx64 corner-turn, where the
// same run's copy_ of the 16 blocks took 1.713; one block a tile takes 1.458
// against copy_'s 1.476 (another run).  A launch whose addresses, row length
// or pitch are not all multiples of 16 bytes copies byte by byte.
//
// What bounds it on the H100: bytes.  Each byte is read once and written
// once, so on one card a call moves 2x its payload at 3.35 TB/s: K7b at the
// fx64 corner-turn (4 shards of int8 (4096, 2, 32, 2048), 537 MB each,
// 2.15 GB in all) has a bound of 2 x 2.15 GB / 3.35 TB/s = 1.282 ms.  Across
// cards the stores of the blocks for other shards cross NVLink at 450 GB/s
// each way per card.  K7a at the SP halo (4 blocks of 8.4 MB, bound 0.020 ms)
// is small enough that the launches and the host work around them, not the
// bytes, decide its time: one launch for the ring takes 0.054-0.069 ms where
// four took 0.126 ms (an H100 80GB HBM3 at 700 W), which is why the pairs of
// a card share a launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define DCS_MAX_PEERS 16

// The (source, destination) pairs of one launch, passed by value.
struct DcsPairs {
  const char* src[DCS_MAX_PEERS];
  char* dst[DCS_MAX_PEERS];
};

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

// `rows` rows of `row_units` units (16 bytes when kVec, else 1) from
// pairs.src[d] (contiguous) to pairs.dst[d] (rows `pitch` units apart), for
// every pair d < n_pairs.  The tiles of all pairs form one sequence, one
// block a tile, so the card streams through one pair's block at a time.
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

}  // namespace

// K7b, every sender of one card: pair d moves `rows` rows of `row_bytes`
// from pairs.src[d] (contiguous) to pairs.dst[d] (rows `dst_pitch` bytes
// apart), d < n_pairs.  Launches on the current device, which must own
// `stream`; returns cudaGetLastError().
extern "C" int dcs_all_to_all(DcsPairs pairs, int n_pairs, long long rows,
                              long long row_bytes, long long dst_pitch, void* stream) {
  return launch(pairs, n_pairs, rows, row_bytes, dst_pitch, stream);
}

// K7a, every sender of one card: the whole block of nbytes at pairs.src[d]
// goes to pairs.dst[d] (its right neighbour's output), d < n_pairs.
extern "C" int dcs_ring(DcsPairs pairs, int n_pairs, long long nbytes, void* stream) {
  return launch(pairs, n_pairs, 1, nbytes, nbytes, stream);
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
