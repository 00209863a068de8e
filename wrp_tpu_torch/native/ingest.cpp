// Native UDP sector ingest: the reference's udpserver::recv loop
// (udpbroadcast.cpp:45-71) plus per-sector datagram reassembly
// (read_single.cc:145-148, gpu_1fp_streamcasc.cu:654-660), in C++.
// The port's copy of wrp_tpu/native/ingest.cpp, unchanged in behaviour.
//
// Why native: one sector is m (=1024) datagrams; a Python recv loop makes
// m interpreter round-trips per sector while holding the GIL, starving the
// compute thread's dispatch.  This loop runs entirely outside the GIL
// (ctypes releases it for the duration of the call), so ingest of sector
// k+1 genuinely overlaps device work on sector k — the reference
// achieved the same overlap with its host-thread/CUDA-stream cascade.
//
// The loop also understands the framework's optional extended ingest
// header (io/frames.py: ">HHHH" magic 0x5752, sector, elevation, row) and
// implements the same drop/resync semantics as the Python path.

#include <algorithm>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <vector>
#include <sys/socket.h>
#include <sys/time.h>

namespace {

constexpr uint16_t kMagic = 0x5752;  // "WR"
constexpr int kHdrSize = 8;

inline uint16_t be16u(const uint8_t *p) {
  return static_cast<uint16_t>((p[0] << 8) | p[1]);
}

}  // namespace

extern "C" {

// stats[0] += datagrams, stats[1] += dropped_datagrams,
// stats[2] += dropped_sectors, stats[3] += timeouts,
// stats[4] += duplicate_datagrams.
// hdr_out: int32[3] = {has_header, sector, elevation}.
// Returns: 1 sector received; 0 idle timeout (no datagram seen);
//          -1 mid-sector stall (partial sector dropped); -2 socket error.
int32_t wrp_udp_recv_sector(int32_t fd, int32_t timeout_ms, uint8_t *out,
                            int64_t rows, int64_t row_bytes, int64_t *stats,
                            int32_t *hdr_out) {
  struct timeval tv;
  tv.tv_sec = timeout_ms / 1000;
  tv.tv_usec = (timeout_ms % 1000) * 1000;
  // timeout_ms <= 0 -> block forever (tv = {0,0} disables SO_RCVTIMEO)
  if (timeout_ms < 0) tv = {0, 0};
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));

  uint8_t scratch[65536];
  bool have_first = false;
  int32_t first_sector = 0, first_elev = 0;
  hdr_out[0] = 0;
  int64_t got = 0;
  // unique-row bitmap for the extended-header wire: UDP permits duplicate
  // datagrams, so completing a sector on a datagram COUNT would let a dup
  // plus one lost row slip through as a zero-filled hole
  std::vector<uint8_t> filled(static_cast<size_t>(rows), 0);
  while (got < rows) {
    ssize_t nb = recv(fd, scratch, sizeof(scratch), 0);
    if (nb < 0) {
      if (errno == EINTR) continue;  // signal delivery is not a timeout:
                                     // retry like Python's PEP-475 recv
                                     // (dropping a 500-row partial sector
                                     // on a stray SIGCHLD would be data
                                     // loss with no network cause)
      if (errno == EAGAIN || errno == EWOULDBLOCK) {
        stats[3] += 1;
        if (got == 0) return 0;
        stats[2] += 1;
        stats[1] += rows - got;
        return -1;
      }
      return -2;
    }
    stats[0] += 1;
    const uint8_t *payload = scratch;
    int64_t plen = nb;
    int64_t row_idx = got;
    bool has_hdr = false;
    if (nb >= kHdrSize && be16u(scratch) == kMagic) {
      has_hdr = true;
      const int32_t sector = be16u(scratch + 2);
      const int32_t elev = be16u(scratch + 4);
      row_idx = be16u(scratch + 6);
      payload = scratch + kHdrSize;
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
      continue;
    }
    if (has_hdr) {
      if (row_idx < 0 || row_idx >= rows) {
        stats[1] += 1;
        continue;
      }
      std::memcpy(out + static_cast<size_t>(row_idx) * row_bytes, payload,
                  static_cast<size_t>(row_bytes));
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
    }
    got += 1;
  }
  return 1;
}

}  // extern "C"
