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
// wait on DMA semaphores.  Here one launch per SENDING shard copies its blocks
// with ordinary loads and stores into the receivers' output buffers, addressed
// by raw device pointers: the shards of a mesh may share one card (every shard
// is an allocation of its own, and the kernel still does all the cross-shard
// copying) or sit on different cards, where the stores go to the peer card's
// memory over NVLink (unified addressing, peer access enabled by
// dcs_enable_peer).  The wrapper (dc_sand_tpu_torch/parallel/remote_dma.py)
// orders the launches with stream events in place of the DMA semaphores.
//
// Both entries take a by-value struct of up to 16 destination base pointers
// (the JAX package's contract mesh has 16 shards), the sender's index and the
// block size.  A thread copies 16 bytes at a time, grid-stride; the tail of a
// block that is not a multiple of 16 bytes, or a block whose addresses are not
// 16-byte aligned, is copied byte by byte.
//
// What bounds it on the H100: bytes.  Each byte is read once and written
// once, so on one card a call moves 2x its payload at 3.35 TB/s: K7b at the
// fx64 corner-turn (4 shards of int8 (4096, 16, 2, 2048, 2), 537 MB each,
// 2.15 GB in all) has a bound of 2 x 2.15 GB / 3.35 TB/s = 1.282 ms.  Across
// cards the stores of the blocks for other shards cross NVLink at 450 GB/s
// each way per card.  What the design does about it: nothing but wide,
// coalesced accesses (a warp moves 512 contiguous bytes) and a grid large
// enough to keep every SM's loads in flight; there is no arithmetic to hide.

#include <cuda_runtime.h>
#include <stdint.h>

#define DCS_MAX_PEERS 16

// Destination base pointers of one launch, passed by value.
struct DcsPeers {
  char* dst[DCS_MAX_PEERS];
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 2048;  // per launch, over all destinations

// blockIdx.y = destination d: copy nbytes from src + d * src_stride to
// peers.dst[d] + dst_off.  vec: all addresses 16-byte aligned.
__global__ void __launch_bounds__(kThreads)
    copy_blocks(const char* __restrict__ src, const __grid_constant__ DcsPeers peers,
                long long src_stride, long long dst_off, long long nbytes, int vec) {
  const char* s = src + blockIdx.y * src_stride;
  char* t = peers.dst[blockIdx.y] + dst_off;
  const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long step = static_cast<long long>(gridDim.x) * kThreads;
  const long long n16 = vec ? nbytes / 16 : 0;
  const uint4* s4 = reinterpret_cast<const uint4*>(s);
  uint4* t4 = reinterpret_cast<uint4*>(t);
  for (long long v = i; v < n16; v += step) t4[v] = s4[v];
  for (long long v = n16 * 16 + i; v < nbytes; v += step) t[v] = s[v];
}

int launch(const void* src, const DcsPeers& peers, int n_dst, long long src_stride,
           long long dst_off, long long nbytes, void* stream) {
  if (n_dst < 1 || n_dst > DCS_MAX_PEERS || nbytes < 0 || src == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nbytes == 0) return static_cast<int>(cudaGetLastError());
  int vec = reinterpret_cast<uintptr_t>(src) % 16 == 0 && src_stride % 16 == 0 &&
            dst_off % 16 == 0;
  for (int d = 0; d < n_dst; ++d) {
    if (peers.dst[d] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    vec = vec && reinterpret_cast<uintptr_t>(peers.dst[d]) % 16 == 0;
  }
  const long long units = vec ? (nbytes + 15) / 16 : nbytes;
  long long bx = (units + kThreads - 1) / kThreads;
  const long long cap = kMaxBlocks / n_dst > 0 ? kMaxBlocks / n_dst : 1;
  if (bx > cap) bx = cap;
  const dim3 grid(static_cast<unsigned>(bx), n_dst);
  copy_blocks<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(src), peers, src_stride, dst_off, nbytes, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K7b, one sender.  src: the sender's input, n row-blocks of block_bytes;
// peers.dst[s]: shard s's output base (n entries); my: the sender's index.
// Row-block s of src goes to peers.dst[s] + my * block_bytes.  Launches on the
// current device, which must own `stream`; returns cudaGetLastError().
extern "C" int dcs_all_to_all(const void* src, DcsPeers peers, int n, int my,
                              long long block_bytes, void* stream) {
  if (my < 0 || my >= n) return static_cast<int>(cudaErrorInvalidValue);
  return launch(src, peers, n, block_bytes, my * block_bytes, block_bytes, stream);
}

// K7a, one sender: its whole block of nbytes goes to peers.dst[0] (the right
// neighbour's output).
extern "C" int dcs_ring(const void* src, DcsPeers peers, long long nbytes,
                        void* stream) {
  return launch(src, peers, 1, 0, 0, nbytes, stream);
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
