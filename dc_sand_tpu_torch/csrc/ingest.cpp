// Native ingest: packet reassembly + sample unpacking for the F-engine.
//
// The PyTorch port's own copy of the JAX package's csrc/ingest.cpp (the
// port builds nothing of the JAX side).  Everything in front of the
// device boundary lives here: receiving timestamped per-antenna packets,
// unpacking the digitiser's 10-bit samples to int8, scattering payloads
// into (ant, pol, time) chunk buffers, and handing full chunks to the
// Python runner.  It differs from the original in three places only,
// and behaves the same where the original works:
//  * each slot's buffer is page-aligned (PageBuffer), so that the port
//    can register it with the CUDA driver and copy retired chunks to the
//    card straight out of the ring;
//  * ingest_n_slots / ingest_slot_buffer expose the slots for that
//    registration;
//  * the UDP receive loop falls back from MSG_WAITFORONE to a plain
//    recvmmsg where the kernel refuses the flag (EINVAL), where the
//    original's receiver thread would stop at once.
//
// Design:
//  * A fixed ring of chunk slots, each an (n_ants, n_pols, chunk_samples)
//    int8 buffer plus a fill counter.
//  * ingest_submit() scatters one packet into the right slot(s) by
//    timestamp; packets may arrive out of order within the ring's
//    time window; late packets (older than the ring tail) are dropped
//    and counted.
//  * ingest_retire() hands the oldest chunk to the caller when it is
//    complete (or on demand, flushing with zero-fill), advancing the
//    window — the F-engine never blocks on a lost packet, matching
//    streaming-correlator semantics (drops are counted, never awaited).
//  * unpack_10bit(): the MeerKAT digitiser emits 10-bit big-endian
//    packed samples; unpack to int8 by dropping the 2 LSBs.
//
// Exposed as a C ABI for ctypes; built with g++ by
// dc_sand_tpu_torch/_build.py:host_library.

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <new>
#include <thread>
#include <vector>

#include <arpa/inet.h>
#include <errno.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

namespace {

// A slot's bytes, zero-filled like the std::vector it replaces, but
// page-aligned and a whole number of pages long: cudaHostRegister pins
// whole pages, so a slot registered with the CUDA driver shares no page
// with other memory.
class PageBuffer {
 public:
  static constexpr uint64_t kPage = 4096;

  void assign(uint64_t n, int8_t value) {
    uint64_t cap = (n + kPage - 1) / kPage * kPage;
    auto* p = static_cast<int8_t*>(std::aligned_alloc(kPage, cap));
    if (p == nullptr) throw std::bad_alloc();
    std::memset(p, value, cap);
    p_.reset(p);
    capacity_ = cap;
  }
  int8_t* data() { return p_.get(); }
  int8_t& operator[](uint64_t i) { return p_[i]; }
  uint64_t capacity() const { return capacity_; }

 private:
  struct Free {
    void operator()(int8_t* p) const { std::free(p); }
  };
  std::unique_ptr<int8_t[], Free> p_;
  uint64_t capacity_ = 0;
};

struct ChunkSlot {
  PageBuffer data;                // (A * P * C) int8, page-aligned
  std::vector<uint64_t> cover;    // byte-coverage bitmap (dedup accounting)
  uint64_t start_sample = 0;      // absolute sample index of data[..., 0]
  uint64_t filled_bytes = 0;      // DISTINCT bytes written (never > chunk)
  bool in_window = false;

  // Mark [off, off+len) covered; return the number of newly-covered
  // bytes.  Duplicate/overlapping packets thus never double-count, so
  // the fill fraction is exact and completeness is well-defined.
  uint64_t mark(uint64_t off, uint64_t len) {
    uint64_t added = 0;
    uint64_t w0 = off / 64, w1 = (off + len - 1) / 64;
    for (uint64_t w = w0; w <= w1; ++w) {
      uint64_t lo = (w == w0) ? off % 64 : 0;
      uint64_t hi = (w == w1) ? (off + len - 1) % 64 : 63;
      uint64_t mask = (hi == 63 ? ~uint64_t(0) : ((uint64_t(1) << (hi + 1)) - 1))
                      & ~((uint64_t(1) << lo) - 1);
      added += uint64_t(__builtin_popcountll(mask & ~cover[w]));
      cover[w] |= mask;
    }
    return added;
  }
};

// Zero every byte of slot.data NOT covered by a packet, by scanning the
// coverage bitmap for zero-runs.  Replaces the eager whole-slot memset
// on first touch: in the common complete case this touches NOTHING, so
// the assembler's memory traffic per chunk drops from 3 passes
// (memset + packet memcpy + retire copy) toward 1 (the packet memcpy,
// with the zero-copy retire_view API).
void fill_gaps(ChunkSlot& slot, uint64_t nbytes) {
  if (slot.filled_bytes == nbytes) return;
  const uint64_t nwords = (nbytes + 63) / 64;
  uint64_t w = 0;
  while (w < nwords) {
    uint64_t cov = slot.cover[w];
    if (cov == ~uint64_t(0)) {
      ++w;
    } else if (cov == 0) {
      uint64_t w2 = w + 1;
      while (w2 < nwords && slot.cover[w2] == 0) ++w2;
      uint64_t b0 = w * 64, b1 = std::min(w2 * 64, nbytes);
      std::memset(slot.data.data() + b0, 0, b1 - b0);
      w = w2;
    } else {
      for (int b = 0; b < 64 && w * 64 + b < nbytes; ++b) {
        if (!(cov & (uint64_t(1) << b))) slot.data[w * 64 + b] = 0;
      }
      ++w;
    }
  }
}

struct Ingest {
  int n_ants, n_pols;
  uint64_t chunk_samples;
  int n_slots;
  std::vector<ChunkSlot> slots;
  uint64_t window_tail_chunk = 0;  // oldest chunk index in the window
  int64_t borrowed_chunk = -1;     // chunk whose slot retire_view lent out
  // per-stream coarse delay (read-pointer semantics): a stream delayed
  // by d has its samples placed d later on the aligned timeline; the
  // head of the timeline reads as zeros until the delayed data arrives
  // (identical to the runner's host-side [zeros | chunk] lead-in).
  std::vector<int64_t> delays;
  int64_t max_delay = 0;  // retained for validation only
  std::vector<int8_t> scratch10;  // 10-bit unpack scratch (under mu)
  std::atomic<uint64_t> packets_ok{0}, packets_late{0}, packets_bad{0};
  // placed only PARTIALLY: some chunk segment was dropped (borrowed-slot
  // wrap) while another landed — consumer-too-slow data loss that
  // packets_ok alone would hide
  std::atomic<uint64_t> packets_clipped{0};
  std::mutex mu;

  uint64_t chunk_bytes() const {
    return uint64_t(n_ants) * n_pols * chunk_samples;
  }
  ChunkSlot& slot_for(uint64_t chunk_idx) {
    return slots[chunk_idx % n_slots];
  }
};

}  // namespace

extern "C" {

// ---------------------------------------------------------------------
// Sample-format unpacking
// ---------------------------------------------------------------------

// Unpack n 10-bit big-endian packed samples (5 bytes per 4 samples) to
// int8 by arithmetic shift (drop 2 LSBs).  `n` must be a multiple of 4;
// src must hold n * 10 / 8 bytes.
void unpack_10bit(const uint8_t* src, int8_t* dst, uint64_t n) {
  for (uint64_t g = 0; g < n / 4; ++g) {
    const uint8_t* p = src + g * 5;
    // 40 bits -> four 10-bit two's-complement samples
    uint64_t bits = (uint64_t(p[0]) << 32) | (uint64_t(p[1]) << 24) |
                    (uint64_t(p[2]) << 16) | (uint64_t(p[3]) << 8) |
                    uint64_t(p[4]);
    for (int i = 0; i < 4; ++i) {
      int16_t s10 = int16_t((bits >> (30 - 10 * i)) & 0x3FF);
      if (s10 & 0x200) s10 -= 0x400;  // sign-extend 10 bits
      dst[g * 4 + i] = int8_t(s10 >> 2);
    }
  }
}

// ---------------------------------------------------------------------
// Chunk assembler
// ---------------------------------------------------------------------

void* ingest_create(int n_ants, int n_pols, uint64_t chunk_samples,
                    int n_slots) {
  if (n_ants <= 0 || n_pols <= 0 || chunk_samples == 0 || n_slots <= 0) {
    // a zero chunk_samples/n_slots would SIGFPE on the first divide;
    // fail construction instead (the Python wrapper raises on nullptr)
    return nullptr;
  }
  auto* ig = new Ingest;
  ig->n_ants = n_ants;
  ig->n_pols = n_pols;
  ig->chunk_samples = chunk_samples;
  ig->n_slots = n_slots;
  ig->delays.assign(size_t(n_ants) * n_pols, 0);
  ig->slots.resize(n_slots);
  for (auto& s : ig->slots) {
    s.data.assign(ig->chunk_bytes(), 0);
    s.cover.assign((ig->chunk_bytes() + 63) / 64, 0);
  }
  return ig;
}

void ingest_destroy(void* h) { delete static_cast<Ingest*>(h); }

// Configure coarse (integer-sample) delay applied at packet placement —
// the production home of C2 (read-pointer offset).  Returns 0, or -2 on
// bad args.  Delays must lie in [0, max_delay].
int ingest_set_delay(void* h, int ant, int pol, long long delay,
                     long long max_delay) {
  auto* ig = static_cast<Ingest*>(h);
  if (ant < 0 || ant >= ig->n_ants || pol < 0 || pol >= ig->n_pols ||
      delay < 0 || delay > max_delay) {
    return -2;
  }
  std::lock_guard<std::mutex> lock(ig->mu);
  ig->max_delay = max_delay;
  ig->delays[size_t(ant) * ig->n_pols + pol] = delay;
  return 0;
}

namespace {

// Core packet scatter; caller holds ig->mu.  Returns 0 ok, -1 late,
// -2 bad args, -3 too far in the future.
int submit_locked(Ingest* ig, int ant, int pol, uint64_t timestamp,
                  const uint8_t* payload, uint64_t n_samples, int format);

}  // namespace

// Scatter one packet: `n_samples` contiguous samples of (ant, pol)
// starting at absolute sample index `timestamp`.  format: 0 = int8
// payload, 1 = 10-bit packed payload.  Returns 0 ok, -1 late-drop,
// -2 bad args, -3 too far in the future (outside the ring window).
int ingest_submit(void* h, int ant, int pol, uint64_t timestamp,
                  const uint8_t* payload, uint64_t n_samples, int format) {
  auto* ig = static_cast<Ingest*>(h);
  std::lock_guard<std::mutex> lock(ig->mu);
  return submit_locked(ig, ant, pol, timestamp, payload, n_samples,
                       format);
}

// Burst submission — the shape a NIC ring consumer hands over: parallel
// descriptor arrays for `n_packets` equal-size payloads stored
// contiguously.  One lock + one FFI crossing for the whole burst (the
// per-call ctypes overhead would otherwise dominate any at-rate
// measurement — and any real-time deployment).  Returns the number of
// packets accepted.
long long ingest_submit_burst(void* h, const int* ants, const int* pols,
                              const uint64_t* timestamps,
                              const uint8_t* payloads,
                              uint64_t samples_per_packet,
                              uint64_t n_packets, int format) {
  auto* ig = static_cast<Ingest*>(h);
  uint64_t payload_bytes = format == 1
      ? samples_per_packet * 10 / 8 : samples_per_packet;
  long long ok = 0;
  std::lock_guard<std::mutex> lock(ig->mu);
  for (uint64_t i = 0; i < n_packets; ++i) {
    if (submit_locked(ig, ants[i], pols[i], timestamps[i],
                      payloads + i * payload_bytes, samples_per_packet,
                      format) == 0) {
      ++ok;
    }
  }
  return ok;
}

namespace {

int submit_locked(Ingest* ig, int ant, int pol, uint64_t timestamp,
                  const uint8_t* payload, uint64_t n_samples, int format) {
  if (ant < 0 || ant >= ig->n_ants || pol < 0 || pol >= ig->n_pols ||
      n_samples == 0) {
    ig->packets_bad++;
    return -2;
  }
  timestamp += uint64_t(ig->delays[size_t(ant) * ig->n_pols + pol]);
  uint64_t first_chunk = timestamp / ig->chunk_samples;
  uint64_t last_chunk = (timestamp + n_samples - 1) / ig->chunk_samples;
  if (last_chunk < ig->window_tail_chunk) {
    ig->packets_late++;
    return -1;
  }
  if (first_chunk >= ig->window_tail_chunk + ig->n_slots) {
    ig->packets_bad++;
    return -3;  // caller must retire chunks first
  }
  const int8_t* samples;
  if (format == 1) {
    if (n_samples % 4) {
      // unpack_10bit's contract: whole 4-sample/5-byte groups only — a
      // ragged tail would be silently written as zeros yet counted as
      // covered bytes (fill 1.0 with corrupt data)
      ig->packets_bad++;
      return -2;
    }
    // reusable scratch (mu held): per-packet heap churn would tax the
    // at-rate burst path the burst API exists to keep cheap
    if (ig->scratch10.size() < n_samples) ig->scratch10.resize(n_samples);
    unpack_10bit(payload, ig->scratch10.data(), n_samples);
    samples = ig->scratch10.data();
  } else {
    samples = reinterpret_cast<const int8_t*>(payload);
  }
  bool any_placed = false, any_dropped = false;
  // segments falling off either window edge are real data loss too —
  // a packet straddling the tail (late leading samples) or the window
  // head (caller hasn't retired yet) must not hide behind packets_ok
  if (first_chunk < ig->window_tail_chunk ||
      last_chunk >= ig->window_tail_chunk + ig->n_slots) {
    any_dropped = true;
  }
  for (uint64_t c = std::max(first_chunk, ig->window_tail_chunk);
       c <= last_chunk && c < ig->window_tail_chunk + ig->n_slots; ++c) {
    if (ig->borrowed_chunk >= 0 &&
        c % ig->n_slots == uint64_t(ig->borrowed_chunk) % ig->n_slots) {
      // the ring wrapped onto a slot still lent out by retire_view —
      // the consumer is too slow; drop rather than corrupt (counted
      // once per packet below — packets_bad if wholly discarded,
      // packets_clipped if another segment still landed)
      any_dropped = true;
      continue;
    }
    any_placed = true;
    ChunkSlot& slot = ig->slot_for(c);
    if (!slot.in_window) {
      slot.start_sample = c * ig->chunk_samples;
      slot.filled_bytes = 0;
      slot.in_window = true;
      // NO eager data memset: uncovered bytes are zeroed at retire by
      // fill_gaps (free in the complete case); only the 1/64-size
      // coverage bitmap clears here
      std::fill(slot.cover.begin(), slot.cover.end(), 0);
    }
    uint64_t c0 = c * ig->chunk_samples, c1 = c0 + ig->chunk_samples;
    uint64_t s0 = std::max(timestamp, c0);
    uint64_t s1 = std::min(timestamp + n_samples, c1);
    uint64_t off = (uint64_t(ant) * ig->n_pols + pol) * ig->chunk_samples +
                   (s0 - c0);
    std::memcpy(slot.data.data() + off, samples + (s0 - timestamp),
                s1 - s0);
    slot.filled_bytes += slot.mark(off, s1 - s0);
  }
  if (any_dropped && !any_placed) {
    ig->packets_bad++;   // wholly discarded (borrowed-slot wrap)
    return -3;
  }
  if (any_dropped) ig->packets_clipped++;  // placed, but lost a segment
  ig->packets_ok++;      // placed (at least partially)
  return 0;
}

}  // namespace

// ---------------------------------------------------------------------
// SPEAD framing (transport parity with the reference's spead2 tier)
// ---------------------------------------------------------------------
// Minimal SPEAD-64-48 datagram decoder: the MeerKAT world moves
// digitiser/F-engine data as SPEAD heaps over UDP multicast, and the
// reference's ingest experiments consume exactly that (SURVEY.md §2.1
// "Transport experiments", C15).  This decodes one UDP datagram =
// one packet of a heap: 8-byte header (magic 0x53, version 4,
// item-pointer width 8, heap-address width 6, n_items), then n_items
// big-endian 64-bit item pointers (bit 63 = immediate, bits 62..48 =
// item ID, bits 47..0 = value / payload offset), then the payload.
//
// Item IDs (SPEAD standard): 0x03 = payload offset within the heap.
// Application IDs are configurable at submit time (MeerKAT convention:
// 0x1600 = timestamp in ADC sample ticks, stream-ID item carrying
// ant*n_pols+pol).  Single- and multi-packet heaps both work: the
// sample index is timestamp + payload_offset-in-samples, which the
// chunk assembler places like any other packet.

namespace {

inline uint64_t be64(const uint8_t* p) {
  uint64_t v = 0;
  for (int i = 0; i < 8; ++i) v = (v << 8) | p[i];
  return v;
}

}  // namespace

// Decode + submit one SPEAD datagram.  `ts_id`/`stream_id_item` select
// the application item IDs for the timestamp and the (ant,pol) stream
// index (stream = ant * n_pols + pol).  Returns the submit_locked
// code, or -4 for a malformed/foreign datagram.
long long ingest_submit_spead(void* h, const uint8_t* data, uint64_t len,
                              int ts_id, int stream_id_item, int format) {
  auto* ig = static_cast<Ingest*>(h);
  if (len < 8 || data[0] != 0x53 || data[1] != 0x04 || data[2] != 0x08 ||
      data[3] != 0x06) {
    ig->packets_bad++;
    return -4;
  }
  uint64_t n_items = (uint64_t(data[6]) << 8) | data[7];
  if (len < 8 + 8 * n_items) {
    ig->packets_bad++;
    return -4;
  }
  const uint8_t* payload = data + 8 + 8 * n_items;
  uint64_t payload_len = len - 8 - 8 * n_items;
  bool have_ts = false, have_stream = false;
  uint64_t ts = 0, stream = 0, heap_off = 0;
  for (uint64_t i = 0; i < n_items; ++i) {
    uint64_t ptr = be64(data + 8 + 8 * i);
    bool imm = (ptr >> 63) & 1;
    int id = int((ptr >> 48) & 0x7FFF);
    uint64_t val = ptr & 0xFFFFFFFFFFFFULL;
    if (!imm) continue;        // addressed items carry no scalar here
    if (id == ts_id) { ts = val; have_ts = true; }
    else if (id == stream_id_item) { stream = val; have_stream = true; }
    else if (id == 0x03) { heap_off = val; }   // payload offset (bytes)
  }
  if (!have_ts || !have_stream || payload_len == 0) {
    ig->packets_bad++;
    return -4;
  }
  if (format == 1 && (heap_off % 5 != 0 || payload_len % 5 != 0)) {
    // 10-bit payloads pack 4 samples per 5 bytes: a heap split off a
    // group boundary would decode shifted garbage at a wrong sample
    // index (silently — fill would still reach 1.0).  The encoder side
    // enforces max_payload % 5 == 0; reject foreign senders that don't.
    ig->packets_bad++;
    return -4;
  }
  if (stream >= uint64_t(ig->n_ants) * uint64_t(ig->n_pols)) {
    // bounds-check BEFORE the int cast: a hostile/corrupt 48-bit stream
    // id could otherwise wrap modulo 2^32 into a valid antenna index
    ig->packets_bad++;
    return -4;
  }
  uint64_t n_samples = format == 1 ? payload_len * 8 / 10 : payload_len;
  uint64_t off_samples = format == 1 ? heap_off * 8 / 10 : heap_off;
  int ant = int(stream / ig->n_pols);
  int pol = int(stream % ig->n_pols);
  std::lock_guard<std::mutex> lock(ig->mu);
  return submit_locked(ig, ant, pol, ts + off_samples, payload,
                       n_samples, format);
}

// Burst form: `n` datagrams stored back to back with per-datagram
// lengths — the shape a recvmmsg()-style receiver hands over.  One FFI
// crossing for the whole burst (per-datagram locking, so concurrent
// retire calls interleave).  Returns packets placed.
long long ingest_submit_spead_burst(void* h, const uint8_t* data,
                                    const uint64_t* lens, uint64_t n,
                                    int ts_id, int stream_id_item,
                                    int format) {
  long long ok = 0;
  uint64_t off = 0;
  for (uint64_t i = 0; i < n; ++i) {
    if (ingest_submit_spead(h, data + off, lens[i], ts_id,
                            stream_id_item, format) == 0) {
      ++ok;
    }
    off += lens[i];
  }
  return ok;
}

// SPEAD-64-48 encoder — the transmit mirror of ingest_submit_spead.
// The reference world ships every hop of the signal chain as SPEAD
// heaps over UDP multicast (digitiser -> F -> X -> science consumers);
// the port's corner-turn rides NVLink or device memory instead, but
// the OUTWARD product — visibility dumps, beam data — still
// leaves the correlator as SPEAD, so the native tier carries the
// packetizer too.
//
// Packetizes ONE heap (a contiguous payload: a chunk of a stream, a
// visibility dump) into datagrams of at most `max_payload` payload
// bytes each.  Every datagram is self-describing (immediate items:
// heap id 0x01, payload offset 0x03, payload length 0x04, plus the
// application timestamp and stream-id items), so packets may arrive in
// any order and the decoder above reassembles them by
// timestamp + offset.  Datagrams are written back to back into `dst`
// with per-datagram lengths in `lens` — exactly the burst shape
// ingest_submit_spead_burst (and a sendmmsg() loop) consumes.
// Returns the number of datagrams, or -1 if dst/lens capacity is
// insufficient (capacity check is exact, done before any write).
namespace {

inline void put_be64(uint8_t* p, uint64_t v) {
  for (int i = 7; i >= 0; --i) { p[i] = uint8_t(v); v >>= 8; }
}

inline void put_item(uint8_t* p, int id, uint64_t val) {
  put_be64(p, (uint64_t(1) << 63) | (uint64_t(id & 0x7FFF) << 48) |
              (val & 0xFFFFFFFFFFFFULL));
}

}  // namespace

long long spead_encode(uint8_t* dst, uint64_t dst_cap, uint64_t* lens,
                       uint64_t lens_cap, const uint8_t* payload,
                       uint64_t payload_len, uint64_t heap_id,
                       uint64_t timestamp, uint64_t stream, int ts_id,
                       int stream_id_item, uint64_t max_payload) {
  if (payload_len == 0 || max_payload == 0) return -1;
  const uint64_t n_items = 6;
  const uint64_t hdr = 8 + 8 * n_items;
  const uint64_t n_pkts = (payload_len + max_payload - 1) / max_payload;
  if (n_pkts > lens_cap || hdr * n_pkts + payload_len > dst_cap) {
    return -1;
  }
  uint64_t off = 0;
  for (uint64_t i = 0; i < n_pkts; ++i) {
    uint64_t chunk = std::min(max_payload, payload_len - i * max_payload);
    uint8_t* p = dst + off;
    p[0] = 0x53; p[1] = 0x04; p[2] = 0x08; p[3] = 0x06;
    p[4] = 0; p[5] = 0;
    p[6] = uint8_t(n_items >> 8); p[7] = uint8_t(n_items);
    put_item(p + 8, 0x01, heap_id);
    // heap length (0x02): spead2-standard receivers only mark a heap
    // complete when received payload equals this item's value — without
    // it every heap sits incomplete until flushed and is dropped
    put_item(p + 16, 0x02, payload_len);
    put_item(p + 24, 0x03, i * max_payload);   // payload offset (bytes)
    put_item(p + 32, 0x04, chunk);             // payload length in pkt
    put_item(p + 40, ts_id, timestamp);
    put_item(p + 48, stream_id_item, stream);
    std::memcpy(p + hdr, payload + i * max_payload, chunk);
    lens[i] = hdr + chunk;
    off += hdr + chunk;
  }
  return (long long)n_pkts;
}

// Retire the oldest chunk into `out` (chunk_bytes).  Returns fill
// fraction in ppm (1e6 = complete) or -1 if, with force=0, the tail
// chunk is not yet COMPLETE (every byte covered by a packet) — an
// out-of-order stream's early packet must not flush a chunk whose
// remaining packets are still in flight.  With force=1 the tail slot
// retires regardless (zeros where nothing arrived; an untouched slot is
// a wholly-lost chunk), which is the real-time path: the cadence clock,
// not completeness, decides when a chunk ships.
long long ingest_retire(void* h, int8_t* out, int force) {
  auto* ig = static_cast<Ingest*>(h);
  std::lock_guard<std::mutex> lock(ig->mu);
  ChunkSlot& slot = ig->slot_for(ig->window_tail_chunk);
  if (ig->borrowed_chunk >= 0 &&
      ig->window_tail_chunk % ig->n_slots ==
          uint64_t(ig->borrowed_chunk) % ig->n_slots) {
    return -5;  // slot still lent out; ingest_release first
  }
  if (!force &&
      (!slot.in_window || slot.filled_bytes != ig->chunk_bytes())) {
    return -1;
  }
  if (!slot.in_window) {
    std::memset(out, 0, ig->chunk_bytes());
    ig->window_tail_chunk++;
    return 0;
  }
  fill_gaps(slot, ig->chunk_bytes());
  std::memcpy(out, slot.data.data(), ig->chunk_bytes());
  long long fill =
      (long long)(slot.filled_bytes * 1000000ULL / ig->chunk_bytes());
  slot.in_window = false;
  ig->window_tail_chunk++;
  return fill;
}

// Zero-copy retire: hand the caller a pointer to the slot's own buffer
// (gaps zero-filled) instead of copying the chunk out — the production
// feed path (the next hop is the host->device transfer, which reads
// the slot directly).  The slot stays OUT of the ring until
// ingest_release(); packets that wrap onto it meanwhile are counted
// bad and dropped.  Returns fill ppm, -1 as ingest_retire, or -5 if a
// view is already outstanding (one at a time).
long long ingest_retire_view(void* h, int8_t** out, int force) {
  auto* ig = static_cast<Ingest*>(h);
  std::lock_guard<std::mutex> lock(ig->mu);
  if (ig->borrowed_chunk >= 0) return -5;
  ChunkSlot& slot = ig->slot_for(ig->window_tail_chunk);
  if (!force &&
      (!slot.in_window || slot.filled_bytes != ig->chunk_bytes())) {
    return -1;
  }
  long long fill = 0;
  if (!slot.in_window) {
    std::memset(slot.data.data(), 0, ig->chunk_bytes());
  } else {
    fill_gaps(slot, ig->chunk_bytes());
    fill = (long long)(slot.filled_bytes * 1000000ULL /
                       ig->chunk_bytes());
    slot.in_window = false;
  }
  *out = slot.data.data();
  ig->borrowed_chunk = (int64_t)ig->window_tail_chunk;
  ig->window_tail_chunk++;
  return fill;
}

// 1 if the tail chunk is COMPLETE (every byte covered by a packet) and
// retirable, 0 otherwise.  Lets a multi-assembler consumer check ALL
// workers BEFORE retiring any — a non-force retire that fails midway
// would otherwise leave the workers desynchronised by one chunk.
int ingest_tail_complete(void* h) {
  auto* ig = static_cast<Ingest*>(h);
  std::lock_guard<std::mutex> lock(ig->mu);
  if (ig->borrowed_chunk >= 0 &&
      ig->window_tail_chunk % ig->n_slots ==
          uint64_t(ig->borrowed_chunk) % ig->n_slots) {
    // mirror ingest_retire's -5 condition exactly: only a borrow of
    // the TAIL's slot blocks retirement — a view still held on the
    // previous chunk must not make a genuinely complete tail read 0
    return 0;
  }
  ChunkSlot& slot = ig->slot_for(ig->window_tail_chunk);
  return (slot.in_window && slot.filled_bytes == ig->chunk_bytes())
             ? 1 : 0;
}

// Ring size, and the i-th slot's buffer with its length in bytes (whole
// pages), so that the caller can register every slot with the CUDA
// driver.  ingest_slot_buffer returns 0, or -2 for an i out of range.
int ingest_n_slots(void* h) { return static_cast<Ingest*>(h)->n_slots; }

int ingest_slot_buffer(void* h, int i, void** ptr, uint64_t* bytes) {
  auto* ig = static_cast<Ingest*>(h);
  if (i < 0 || i >= ig->n_slots) return -2;
  *ptr = ig->slots[i].data.data();
  *bytes = ig->slots[i].data.capacity();
  return 0;
}

void ingest_release(void* h) {
  auto* ig = static_cast<Ingest*>(h);
  std::lock_guard<std::mutex> lock(ig->mu);
  ig->borrowed_chunk = -1;
}

void ingest_stats(void* h, uint64_t* ok, uint64_t* late, uint64_t* bad,
                  uint64_t* clipped) {
  auto* ig = static_cast<Ingest*>(h);
  *ok = ig->packets_ok.load();
  *late = ig->packets_late.load();
  *bad = ig->packets_bad.load();
  *clipped = ig->packets_clipped.load();
}

}  // extern "C"

// ===========================================================================
// UDP transport tier (SURVEY.md §2.1 "Transport experiments", §3.2 network
// boundaries).  The reference's transport is NIC-facing spead2/UDP-multicast
// C++; this is the port's equivalent wire leg: a recvmmsg()
// receiver thread feeding the assembler above (one syscall per burst, the
// shape ingest_submit_spead_burst was designed for), and a sendmmsg() sink
// for the SpeadTransmitter's outward products.  Loopback stays available
// for tests; this tier is what touches an actual socket.
// ===========================================================================

namespace {

struct UdpRx {
  Ingest* ig = nullptr;
  int fd = -1;
  int ts_id = 0, stream_id_item = 0, format = 0;
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> datagrams{0}, bytes{0}, placed{0}, rejected{0};
  std::thread th;
};

struct UdpTx {
  int fd = -1;
  std::atomic<uint64_t> datagrams{0}, bytes{0}, dropped{0};
};

constexpr int kRxBatch = 64;        // datagrams per recvmmsg crossing
constexpr size_t kRxBufSz = 16384;  // > any SPEAD datagram we emit

void rx_loop(UdpRx* rx) {
  std::vector<uint8_t> bufs(kRxBatch * kRxBufSz);
  mmsghdr msgs[kRxBatch];
  iovec iov[kRxBatch];
  for (int i = 0; i < kRxBatch; ++i) {
    iov[i] = {bufs.data() + size_t(i) * kRxBufSz, kRxBufSz};
    std::memset(&msgs[i], 0, sizeof msgs[i]);
    msgs[i].msg_hdr.msg_iov = &iov[i];
    msgs[i].msg_hdr.msg_iovlen = 1;
  }
  int flags = MSG_WAITFORONE;
  while (!rx->stop.load(std::memory_order_relaxed)) {
    // SO_RCVTIMEO (set at create) bounds the blocking recv so stop is
    // responsive; MSG_WAITFORONE returns as soon as anything arrived
    // instead of waiting out the whole batch.  (recvmmsg's own timeout
    // parameter is only checked BETWEEN datagrams — a known Linux wart
    // — so the socket timeout is the one that actually unblocks us.)
    int n = recvmmsg(rx->fd, msgs, kRxBatch, flags, nullptr);
    if (n <= 0) {
      if (n < 0 && errno == EINVAL && flags == MSG_WAITFORONE) {
        // a kernel that refuses MSG_WAITFORONE (a sandboxed one may):
        // wait for the batch instead, which SO_RCVTIMEO still ends
        // after 100 ms without a datagram, with what arrived
        flags = 0;
        continue;
      }
      if (n < 0 && errno != EAGAIN && errno != EWOULDBLOCK &&
          errno != EINTR) {
        break;  // socket died (closed under us / network error)
      }
      continue;
    }
    for (int i = 0; i < n; ++i) {
      uint64_t len = msgs[i].msg_len;
      rx->datagrams.fetch_add(1, std::memory_order_relaxed);
      rx->bytes.fetch_add(len, std::memory_order_relaxed);
      long long r = ingest_submit_spead(
          rx->ig, bufs.data() + size_t(i) * kRxBufSz, len, rx->ts_id,
          rx->stream_id_item, rx->format);
      if (r == 0) {
        rx->placed.fetch_add(1, std::memory_order_relaxed);
      } else {
        // late/duplicate/bad — the assembler's own counters say which
        rx->rejected.fetch_add(1, std::memory_order_relaxed);
      }
    }
  }
}

}  // namespace

extern "C" {

// Receiver: bind a UDP socket on `bind_addr:port` (port 0 = ephemeral;
// read back with udp_rx_port) and start a thread pumping datagrams into
// the ingest assembler.  Returns nullptr on socket/bind failure.
void* udp_rx_create(void* ingest, const char* bind_addr, int port,
                    int ts_id, int stream_id_item, int format,
                    int rcvbuf_bytes) {
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  if (rcvbuf_bytes > 0) {
    setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &rcvbuf_bytes,
               sizeof rcvbuf_bytes);
  }
  timeval tv{0, 100 * 1000};  // 100 ms: stop-responsiveness bound
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(uint16_t(port));
  if (inet_pton(AF_INET, bind_addr, &addr.sin_addr) != 1) {
    close(fd);
    return nullptr;
  }
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof addr) != 0) {
    close(fd);
    return nullptr;
  }
  auto* rx = new UdpRx;
  rx->ig = static_cast<Ingest*>(ingest);
  rx->fd = fd;
  rx->ts_id = ts_id;
  rx->stream_id_item = stream_id_item;
  rx->format = format;
  rx->th = std::thread(rx_loop, rx);
  return rx;
}

int udp_rx_port(void* h) {
  auto* rx = static_cast<UdpRx*>(h);
  sockaddr_in addr{};
  socklen_t len = sizeof addr;
  if (getsockname(rx->fd, reinterpret_cast<sockaddr*>(&addr), &len) != 0)
    return -1;
  return int(ntohs(addr.sin_port));
}

void udp_rx_stats(void* h, uint64_t* datagrams, uint64_t* bytes,
                  uint64_t* placed, uint64_t* rejected) {
  auto* rx = static_cast<UdpRx*>(h);
  *datagrams = rx->datagrams.load();
  *bytes = rx->bytes.load();
  *placed = rx->placed.load();
  *rejected = rx->rejected.load();
}

void udp_rx_destroy(void* h) {
  auto* rx = static_cast<UdpRx*>(h);
  rx->stop.store(true);
  if (rx->th.joinable()) rx->th.join();
  if (rx->fd >= 0) close(rx->fd);
  delete rx;
}

// Transmit sink: a connected UDP socket; send_burst ships a packetized
// burst (datagrams back to back + per-datagram lengths — exactly what
// spead_encode produces) with ONE sendmmsg syscall per kRxBatch.
void* udp_tx_create(const char* addr_s, int port, int sndbuf_bytes) {
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return nullptr;
  if (sndbuf_bytes > 0) {
    setsockopt(fd, SOL_SOCKET, SO_SNDBUF, &sndbuf_bytes,
               sizeof sndbuf_bytes);
  }
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(uint16_t(port));
  if (inet_pton(AF_INET, addr_s, &addr.sin_addr) != 1 ||
      connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof addr) != 0) {
    close(fd);
    return nullptr;
  }
  auto* tx = new UdpTx;
  tx->fd = fd;
  return tx;
}

long long udp_tx_send_burst(void* h, const uint8_t* data,
                            const uint64_t* lens, uint64_t n) {
  auto* tx = static_cast<UdpTx*>(h);
  long long sent_total = 0;
  uint64_t off = 0, i = 0;
  while (i < n) {
    mmsghdr msgs[kRxBatch];
    iovec iov[kRxBatch];
    uint64_t m = std::min<uint64_t>(kRxBatch, n - i);
    uint64_t boff = off;
    for (uint64_t j = 0; j < m; ++j) {
      iov[j] = {const_cast<uint8_t*>(data) + boff, size_t(lens[i + j])};
      std::memset(&msgs[j], 0, sizeof msgs[j]);
      msgs[j].msg_hdr.msg_iov = &iov[j];
      msgs[j].msg_hdr.msg_iovlen = 1;
      boff += lens[i + j];
    }
    int sent = sendmmsg(tx->fd, msgs, unsigned(m), 0);
    if (sent < 0) {
      // transient buffer pressure: count the remainder as dropped
      // (UDP semantics — the stream keeps going, fill accounting on
      // the receive side shows the loss)
      tx->dropped.fetch_add(n - i, std::memory_order_relaxed);
      return sent_total;
    }
    for (int j = 0; j < sent; ++j) {
      tx->bytes.fetch_add(msgs[j].msg_len, std::memory_order_relaxed);
    }
    tx->datagrams.fetch_add(sent, std::memory_order_relaxed);
    sent_total += sent;
    if (uint64_t(sent) < m) {
      tx->dropped.fetch_add(m - sent, std::memory_order_relaxed);
    }
    // advance past what this batch covered (sent or dropped)
    off = boff;
    i += m;
  }
  return sent_total;
}

void udp_tx_stats(void* h, uint64_t* datagrams, uint64_t* bytes,
                  uint64_t* dropped) {
  auto* tx = static_cast<UdpTx*>(h);
  *datagrams = tx->datagrams.load();
  *bytes = tx->bytes.load();
  *dropped = tx->dropped.load();
}

void udp_tx_destroy(void* h) {
  auto* tx = static_cast<UdpTx*>(h);
  if (tx->fd >= 0) close(tx->fd);
  delete tx;
}

}  // extern "C"
