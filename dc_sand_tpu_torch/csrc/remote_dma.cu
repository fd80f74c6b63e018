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
// One kernel serves both: it takes, by value, up to 16 (source, destination)
// pointer pairs (the JAX package's contract mesh has 16 shards; 256 B of the
// 4 KB a launch may carry) and the block size, blockIdx.y picks the pair.  A
// thread copies 16 bytes at a time, grid-stride; the tail of a block that is
// not a multiple of 16 bytes, or a launch with an address that is not 16-byte
// aligned, is copied byte by byte.  K7b launches once per SENDING shard (its
// n row-blocks to the n receivers).  K7a launches once per CARD: the pairs of
// every sender that sits on the card ride in one launch, so the 4-shard ring
// of the SP halo on one card, or both rings of a (2, 2) mesh, is one launch.
//
// What bounds it on the H100: bytes.  Each byte is read once and written
// once, so on one card a call moves 2x its payload at 3.35 TB/s: K7b at the
// fx64 corner-turn (4 shards of int8 (4096, 16, 2, 2048, 2), 537 MB each,
// 2.15 GB in all) has a bound of 2 x 2.15 GB / 3.35 TB/s = 1.282 ms.  Across
// cards the stores of the blocks for other shards cross NVLink at 450 GB/s
// each way per card.  What the design does about it: nothing but wide,
// coalesced accesses (a warp moves 512 contiguous bytes) and a grid large
// enough to keep every SM's loads in flight; there is no arithmetic to hide.
// K7a at the SP halo (4 blocks of 8.4 MB, bound 0.020 ms) is small enough
// that the launches and the host work around them, not the bytes, decide its
// time: one launch for the ring takes 0.054-0.069 ms where four took 0.126 ms
// (an H100 80GB HBM3 at 700 W), which is why the pairs share a launch; the
// wrapper's host work, about 0.04-0.05 ms a call, is what is left.

#include <cuda_runtime.h>
#include <stdint.h>

#define DCS_MAX_PEERS 16

// Destination base pointers of one K7b launch, passed by value.
struct DcsPeers {
  char* dst[DCS_MAX_PEERS];
};

// The (source, destination) block pairs of one launch, passed by value.
struct DcsPairs {
  const char* src[DCS_MAX_PEERS];
  char* dst[DCS_MAX_PEERS];
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 2048;  // per launch, over all pairs

// blockIdx.y = pair d: copy nbytes from pairs.src[d] to pairs.dst[d].
// vec: all addresses 16-byte aligned.
__global__ void __launch_bounds__(kThreads)
    copy_pairs(const __grid_constant__ DcsPairs pairs, long long nbytes, int vec) {
  const char* s = pairs.src[blockIdx.y];
  char* t = pairs.dst[blockIdx.y];
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  const long long n16 = vec ? nbytes / 16 : 0;
  const uint4* s4 = reinterpret_cast<const uint4*>(s);
  uint4* t4 = reinterpret_cast<uint4*>(t);
  for (long long v = i; v < n16; v += step) t4[v] = s4[v];
  for (long long v = n16 * 16 + i; v < nbytes; v += step) t[v] = s[v];
}

int launch(const DcsPairs& pairs, int n_pairs, long long nbytes, void* stream) {
  if (n_pairs < 1 || n_pairs > DCS_MAX_PEERS || nbytes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int vec = 1;
  for (int d = 0; d < n_pairs; ++d) {
    if (pairs.src[d] == nullptr || pairs.dst[d] == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    vec = vec && reinterpret_cast<uintptr_t>(pairs.src[d]) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(pairs.dst[d]) % 16 == 0;
  }
  if (nbytes == 0) return static_cast<int>(cudaGetLastError());
  const long long units = vec ? (nbytes + 15) / 16 : nbytes;
  long long bx = (units + kThreads - 1) / kThreads;
  const long long cap = kMaxBlocks / n_pairs > 0 ? kMaxBlocks / n_pairs : 1;
  if (bx > cap) bx = cap;
  const dim3 grid(static_cast<unsigned>(bx), n_pairs);
  copy_pairs<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(pairs, nbytes,
                                                                       vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K7b, one sender.  src: the sender's input, n row-blocks of block_bytes;
// peers.dst[s]: shard s's output base (n entries); my: the sender's index.
// Row-block s of src goes to peers.dst[s] + my * block_bytes.  Launches on the
// current device, which must own `stream`; returns cudaGetLastError().
extern "C" int dcs_all_to_all(const void* src, DcsPeers peers, int n, int my,
                              long long block_bytes, void* stream) {
  if (my < 0 || my >= n || n > DCS_MAX_PEERS || src == nullptr || block_bytes < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  DcsPairs pairs = {};
  for (int s = 0; s < n; ++s) {
    if (peers.dst[s] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    pairs.src[s] = static_cast<const char*>(src) + s * block_bytes;
    pairs.dst[s] = peers.dst[s] + my * block_bytes;
  }
  return launch(pairs, n, block_bytes, stream);
}

// K7a, every sender of one card: the whole block of nbytes at pairs.src[d]
// goes to pairs.dst[d] (its right neighbour's output), d < n_pairs.
extern "C" int dcs_ring(DcsPairs pairs, int n_pairs, long long nbytes, void* stream) {
  return launch(pairs, n_pairs, nbytes, stream);
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
