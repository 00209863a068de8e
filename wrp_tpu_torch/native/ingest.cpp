// Native UDP sector ingest: the reference's udpserver::recv loop
// (udpbroadcast.cpp:45-71) plus per-sector datagram reassembly
// (read_single.cc:145-148, gpu_1fp_streamcasc.cu:654-660), in C++.
// The reassembly is the port's copy of wrp_tpu/native/ingest.cpp,
// unchanged in behaviour.
//
// Why native: one sector is m (=1024) datagrams; a Python recv loop makes
// m interpreter round-trips per sector while holding the GIL, starving the
// compute thread's dispatch.  This loop runs entirely outside the GIL
// (ctypes releases it for the duration of the call), so ingest of sector
// k+1 genuinely overlaps device work on sector k — the reference
// achieved the same overlap with its host-thread/CUDA-stream cascade.
//
// The drain (wrp_udp_drain_*): between two sectors the caller's thread
// runs Python and must take the GIL back.  Where the kernel clamps the
// receive buffer (net.core.rmem_max, often 4 MB: under one 6.3 MB sector),
// any hold of the GIL by another thread longer than the buffer lasts at
// the wire's rate (~40 ms at a radar's 21.45 sectors/s) overruns the
// socket and loses datagrams.  A drain is a native thread that does
// nothing but move datagrams from the socket into a ring in user memory,
// so the buffer the caller asked for exists whatever the kernel grants,
// and the reassembly reads the ring instead of the socket.  When the ring
// is full the thread stops reading and the socket's own buffer fills, so
// it adds buffering and no drop path of its own.
//
// The loop also understands the framework's optional extended ingest
// header (io/frames.py: ">HHHH" magic 0x5752, sector, elevation, row) and
// implements the same drop/resync semantics as the Python path.

#include <sys/socket.h>
#include <sys/time.h>

#include <algorithm>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr uint16_t kMagic = 0x5752;  // "WR"
constexpr int kHdrSize = 8;

inline uint16_t be16u(const uint8_t *p) {
  return static_cast<uint16_t>((p[0] << 8) | p[1]);
}

// next(&data, want) -> datagram length (data points at its bytes, valid
// until release() or the next call), or kTimeout, or kError; want: the
// datagrams the sector still needs, a hint.
constexpr int64_t kTimeout = -1;
constexpr int64_t kError = -2;

// Datagrams straight from the socket (SO_RCVTIMEO per datagram).
struct SocketSource {
  int32_t fd;
  uint8_t scratch[65536];

  SocketSource(int32_t fd_, int32_t timeout_ms) : fd(fd_) {
    struct timeval tv;
    tv.tv_sec = timeout_ms / 1000;
    tv.tv_usec = (timeout_ms % 1000) * 1000;
    // timeout_ms <= 0 -> block forever (tv = {0,0} disables SO_RCVTIMEO)
    if (timeout_ms < 0) tv = {0, 0};
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  }

  int64_t next(const uint8_t **data, int64_t /*want*/) {
    for (;;) {
      ssize_t nb = recv(fd, scratch, sizeof(scratch), 0);
      if (nb >= 0) {
        *data = scratch;
        return nb;
      }
      // signal delivery is not a timeout: retry like Python's PEP-475
      // recv (dropping a 500-row partial sector on a stray SIGCHLD would
      // be data loss with no network cause)
      if (errno == EINTR) continue;
      if (errno == EAGAIN || errno == EWOULDBLOCK) return kTimeout;
      return kError;
    }
  }

  void release() {}
};

// A socket drained by its own thread into a ring of fixed slots, one
// datagram a slot: slot_bytes = row_bytes + header, so a row always fits;
// a longer datagram keeps its true length (MSG_TRUNC) and is refused by
// the reassembly's length check, as from the socket.  The thread blocks in
// recv (one call a datagram, as the receive without a drain did) and
// wakes the receiver only once the datagrams it waits for are in, so a
// sector costs about what it cost without the drain.
struct Drain {
  using Clock = std::chrono::steady_clock;
  int32_t fd;
  int64_t slot_bytes, nslots;
  std::unique_ptr<uint8_t[]> ring;  // uninitialised: pages commit on use
  std::unique_ptr<int32_t[]> len;
  int64_t head = 0, tail = 0;       // the receiver frees at head, the thread fills at tail
  int64_t want = 0;                 // > 0: a receiver waits for tail - head >= want
  Clock::time_point last_push{};
  bool stop = false;
  bool failed = false;
  std::mutex mu;
  std::condition_variable has_data, has_room;
  std::thread th;

  Drain(int32_t fd_, int64_t slot_bytes_, int64_t nslots_)
      : fd(fd_), slot_bytes(slot_bytes_), nslots(nslots_),
        ring(new uint8_t[static_cast<size_t>(slot_bytes_ * nslots_)]),
        len(new int32_t[static_cast<size_t>(nslots_)]) {
    // a bounded wait in recv, so that halt() is seen within 20 ms
    struct timeval tv = {0, 20000};
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    th = std::thread([this] { run(); });
  }

  void run() {
    for (;;) {
      int64_t slot;
      {
        std::unique_lock<std::mutex> g(mu);
        has_room.wait(g, [this] { return stop || tail - head < nslots; });
        if (stop) return;
        slot = tail % nslots;
      }
      ssize_t nb = recv(fd, ring.get() + slot * slot_bytes,
                        static_cast<size_t>(slot_bytes), MSG_TRUNC);
      const Clock::time_point now = Clock::now();
      std::lock_guard<std::mutex> g(mu);
      if (nb < 0) {
        if (errno == EINTR || errno == EAGAIN || errno == EWOULDBLOCK)
          continue;
        failed = true;
        has_data.notify_all();
        return;
      }
      len[slot] = static_cast<int32_t>(nb);
      ++tail;
      last_push = now;
      if (want > 0 && tail - head >= want) has_data.notify_one();
    }
  }

  // Stop and join the thread; datagrams already in the ring stay
  // readable, after them a receive reports an error (a closed socket).
  void halt() {
    {
      std::lock_guard<std::mutex> g(mu);
      if (stop) return;
      stop = true;
    }
    has_room.notify_all();
    has_data.notify_all();
    th.join();
  }
};

// Datagrams from a Drain's ring, with the socket source's timeout: a
// receive gives up after timeout_ms without a datagram, counted from the
// newest datagram it has taken or from its own start.  It takes the
// datagrams in [cur, end) without the lock and frees them in one step.
struct DrainSource {
  using Clock = Drain::Clock;
  Drain *d;
  int32_t timeout_ms;
  int64_t cur, end;
  Clock::time_point quiet_from;

  DrainSource(Drain *d_, int32_t timeout_ms_) : d(d_), timeout_ms(timeout_ms_) {
    std::lock_guard<std::mutex> g(d->mu);
    cur = end = d->head;
    quiet_from = Clock::now();
  }

  ~DrainSource() { free_taken(); }

  void free_taken() {
    {
      std::lock_guard<std::mutex> g(d->mu);
      if (d->head == cur) return;
      d->head = cur;
    }
    d->has_room.notify_one();
  }

  int64_t next(const uint8_t **data, int64_t want) {
    if (cur == end) {
      free_taken();
      // a ring that cannot hold the rest of the sector wakes the receiver
      // half full, so that the thread never waits on a full ring for it
      want = std::min(want, std::max<int64_t>(1, d->nslots / 2));
      std::unique_lock<std::mutex> g(d->mu);
      d->want = want;
      for (;;) {
        const int64_t avail = d->tail - cur;
        if (avail >= want || d->stop || d->failed) break;
        const Clock::time_point newest =
            avail > 0 ? std::max(quiet_from, d->last_push) : quiet_from;
        if (timeout_ms <= 0) {
          d->has_data.wait(g);
        } else {
          const auto deadline = newest + std::chrono::milliseconds(timeout_ms);
          if (Clock::now() >= deadline) break;
          d->has_data.wait_until(g, deadline);
        }
      }
      d->want = 0;
      end = d->tail;
      if (end == cur) return (d->stop || d->failed) ? kError : kTimeout;
      quiet_from = std::max(quiet_from, d->last_push);
    }
    // the slot at cur is read outside the lock: the thread fills only
    // slots in [tail, head + nslots), and head <= cur
    const int64_t slot = cur % d->nslots;
    *data = d->ring.get() + slot * d->slot_bytes;
    ++cur;
    return d->len[slot];
  }

  void release() {}
};

// stats[0] += datagrams, stats[1] += dropped_datagrams,
// stats[2] += dropped_sectors, stats[3] += timeouts,
// stats[4] += duplicate_datagrams.
// hdr_out: int32[3] = {has_header, sector, elevation}.
// Returns: 1 sector received; 0 idle timeout (no datagram seen);
//          -1 mid-sector stall (partial sector dropped); -2 socket error.
template <class Source>
int32_t reassemble(Source &src, uint8_t *out, int64_t rows,
                   int64_t row_bytes, int64_t *stats, int32_t *hdr_out) {
  bool have_first = false;
  int32_t first_sector = 0, first_elev = 0;
  hdr_out[0] = 0;
  int64_t got = 0;
  // unique-row bitmap for the extended-header wire: UDP permits duplicate
  // datagrams, so completing a sector on a datagram COUNT would let a dup
  // plus one lost row slip through as a zero-filled hole
  std::vector<uint8_t> filled(static_cast<size_t>(rows), 0);
  while (got < rows) {
    const uint8_t *data = nullptr;
    const int64_t nb = src.next(&data, rows - got);
    if (nb == kTimeout) {
      stats[3] += 1;
      if (got == 0) return 0;
      stats[2] += 1;
      stats[1] += rows - got;
      return -1;
    }
    if (nb == kError) return -2;
    stats[0] += 1;
    const uint8_t *payload = data;
    int64_t plen = nb;
    int64_t row_idx = got;
    bool has_hdr = false;
    if (nb >= kHdrSize && be16u(data) == kMagic) {
      has_hdr = true;
      const int32_t sector = be16u(data + 2);
      const int32_t elev = be16u(data + 4);
      row_idx = be16u(data + 6);
      payload = data + kHdrSize;
      plen = nb - kHdrSize;
      if (!have_first) {
        have_first = true;
        first_sector = sector;
        first_elev = elev;
      } else if (sector != first_sector || elev != first_elev) {
        // producer moved on: lost the tail of the current sector
        stats[2] += 1;
        stats[1] += rows - got;
        std::memset(out, 0, static_cast<size_t>(rows) * row_bytes);
        std::fill(filled.begin(), filled.end(), 0);
        first_sector = sector;
        first_elev = elev;
        got = 0;
      }
    }
    if (plen != row_bytes) {
      stats[1] += 1;
      src.release();
      continue;
    }
    if (has_hdr) {
      if (row_idx < 0 || row_idx >= rows) {
        stats[1] += 1;
        src.release();
        continue;
      }
      std::memcpy(out + static_cast<size_t>(row_idx) * row_bytes, payload,
                  static_cast<size_t>(row_bytes));
      src.release();
      hdr_out[0] = 1;
      hdr_out[1] = first_sector;
      hdr_out[2] = first_elev;
      if (filled[static_cast<size_t>(row_idx)]) {
        stats[4] += 1;  // duplicate: do not advance the unique-row count
        continue;
      }
      filled[static_cast<size_t>(row_idx)] = 1;
    } else {
      // bare v1 wire: rows arrive in order by contract
      std::memcpy(out + static_cast<size_t>(got) * row_bytes, payload,
                  static_cast<size_t>(row_bytes));
      src.release();
    }
    got += 1;
  }
  return 1;
}

}  // namespace

extern "C" {

// One sector from the blocking datagram socket fd (timeout_ms <= 0: no
// timeout); see reassemble() for stats, hdr_out and the return.
int32_t wrp_udp_recv_sector(int32_t fd, int32_t timeout_ms, uint8_t *out,
                            int64_t rows, int64_t row_bytes, int64_t *stats,
                            int32_t *hdr_out) {
  SocketSource src(fd, timeout_ms);
  return reassemble(src, out, rows, row_bytes, stats, hdr_out);
}

// Start draining fd into a ring of nslots datagrams of up to slot_bytes.
void *wrp_udp_drain_start(int32_t fd, int64_t slot_bytes, int64_t nslots) {
  return new Drain(fd, slot_bytes, nslots);
}

// One sector from a drain, as wrp_udp_recv_sector from its socket.
int32_t wrp_udp_drain_recv_sector(void *drain, int32_t timeout_ms,
                                  uint8_t *out, int64_t rows,
                                  int64_t row_bytes, int64_t *stats,
                                  int32_t *hdr_out) {
  DrainSource src{static_cast<Drain *>(drain), timeout_ms};
  return reassemble(src, out, rows, row_bytes, stats, hdr_out);
}

// Stop the drain's thread: a receive waiting on it returns -2 once the
// ring is empty.  The socket may be closed after this returns.
void wrp_udp_drain_stop(void *drain) { static_cast<Drain *>(drain)->halt(); }

// Free a stopped drain; no receive may be running on it.
void wrp_udp_drain_free(void *drain) {
  Drain *d = static_cast<Drain *>(drain);
  d->halt();
  delete d;
}

}  // extern "C"
