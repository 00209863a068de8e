// Native wire codec: the host-side hot loops of the streaming runtime.
//
// The port's copy of wrp_tpu/native/codec.cpp, in natural row order only:
// the port's kernels read radix branches by index arithmetic, so the
// radix-DIT row permutation (wrp_tpu's `dest_row`, its `radix` argument)
// is removed, not passed as 1.
//
// The reference spent most of its per-sector host time in
// Sector::fromByteArray + the repack loop (rpv2.cu:350-387 measures it as
// "deserialize"/"restructuring"; SURVEY.md section 6 shows host input
// dominated every GPU variant).  This is the same transform, vectorised
// and parallelised:
//
//   wire:   m*n samples x [hhI hhQ vvI vvQ vhI vhQ], int16 big-endian
//           (sector.cpp:52-62, read_single.cc:15)
//   planar: float32/int16 [channels][2][m][n]  (the device-facing layout)
//
// Design (round 3 rewrite): ONE pass over the wire.  The original decoder
// walked the wire once per plane (6 strided passes for 3 channels), so
// every cacheline was fetched from DRAM up to 6 times and the measured
// rate was ~450 sectors/s/core.  The row-blocked single-pass layout below
// touches each wire byte once; within a row the 2*ch plane slices write
// sequential streams.  For the production channel counts (2 and 3) the
// inner block is a pshufb deinterleave+byteswap: 4 samples (= ch 16-byte
// vectors) in, one 8-byte run of 4 int16 per plane out — the bswap is
// folded into the shuffle masks for free.
//
// Built by build.py (g++ at first use); bound with ctypes in
// codec_native.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <type_traits>
#include <vector>

#if defined(__SSSE3__) && defined(__SSE4_1__)
#include <immintrin.h>
#define WRP_SIMD_DECODE 1
#endif

namespace {

inline int16_t be16(const uint8_t *p) {
  return static_cast<int16_t>((static_cast<uint16_t>(p[0]) << 8) |
                              static_cast<uint16_t>(p[1]));
}

#ifdef WRP_SIMD_DECODE

// pshufb control bytes for the 4-sample deinterleave of a 2*CH-plane
// wire.  Block = 4 samples = CH 16-byte vectors; plane p's sample i sits
// at byte offset 2p + 4*CH*i (big-endian hi byte first).  mask[p][v]
// gathers plane p's contributions from vector v as little-endian int16
// (byteswap folded in); positions outside v are 0x80 (zeroed), so the
// per-plane result is the OR of the CH shuffled vectors.
template <int CH>
struct ShuffleMasks {
  alignas(16) uint8_t m[2 * CH][CH][16];
  ShuffleMasks() {
    std::memset(m, 0x80, sizeof(m));
    for (int p = 0; p < 2 * CH; ++p) {
      for (int i = 0; i < 4; ++i) {
        const int off = 2 * p + 4 * CH * i;  // BE hi byte of the sample
        const int v = off / 16, local = off % 16;
        m[p][v][2 * i] = static_cast<uint8_t>(local + 1);  // LE lo byte
        m[p][v][2 * i + 1] = static_cast<uint8_t>(local);  // LE hi byte
      }
    }
  }
};

template <int CH>
inline void decode_block4(const uint8_t *s, const ShuffleMasks<CH> &mk,
                          __m128i (&out)[2 * CH]) {
  __m128i v[CH];
  for (int c = 0; c < CH; ++c)
    v[c] = _mm_loadu_si128(reinterpret_cast<const __m128i *>(s + 16 * c));
  for (int p = 0; p < 2 * CH; ++p) {
    __m128i r = _mm_shuffle_epi8(
        v[0], _mm_load_si128(reinterpret_cast<const __m128i *>(mk.m[p][0])));
    for (int c = 1; c < CH; ++c)
      r = _mm_or_si128(
          r, _mm_shuffle_epi8(v[c], _mm_load_si128(
                                        reinterpret_cast<const __m128i *>(
                                            mk.m[p][c]))));
    out[p] = r;
  }
}

template <int CH, typename T>
void decode_rows_simd(const uint8_t *wire, T *out, int64_t m, int64_t n,
                      int64_t r0, int64_t r1, int64_t pitch,
                      const int64_t *poff) {
  static const ShuffleMasks<CH> mk;
  constexpr int planes = 2 * CH;
  const size_t row_bytes = static_cast<size_t>(n) * planes * 2;
  for (int64_t r = r0; r < r1; ++r) {
    const uint8_t *s = wire + static_cast<size_t>(r) * row_bytes;
    T *d[planes];
    for (int p = 0; p < planes; ++p)
      d[p] = out + static_cast<size_t>(poff[p]) +
             static_cast<size_t>(r) * static_cast<size_t>(pitch);
    int64_t j = 0;
    for (; j + 4 <= n; j += 4, s += 16 * CH) {
      __m128i b[planes];
      decode_block4<CH>(s, mk, b);
      for (int p = 0; p < planes; ++p) {
        if constexpr (std::is_same_v<T, int16_t>) {
          _mm_storel_epi64(reinterpret_cast<__m128i *>(d[p] + j), b[p]);
        } else {
          _mm_storeu_ps(d[p] + j,
                        _mm_cvtepi32_ps(_mm_cvtepi16_epi32(b[p])));
        }
      }
    }
    for (; j < n; ++j, s += planes * 2)  // n % 4 tail
      for (int p = 0; p < planes; ++p)
        d[p][j] = static_cast<T>(be16(s + 2 * p));
  }
}

#endif  // WRP_SIMD_DECODE

// Scalar single-pass fallback (any channel count): still one DRAM walk —
// the 2*ch re-reads of a row stay in L1 (a row is a few KB).
template <typename T>
void decode_rows_scalar(const uint8_t *wire, T *out, int64_t m, int64_t n,
                        int ch, int64_t r0, int64_t r1, int64_t pitch,
                        const int64_t *poff) {
  const int planes = ch * 2;
  const size_t row_bytes = static_cast<size_t>(n) * planes * 2;
  for (int64_t r = r0; r < r1; ++r) {
    const uint8_t *src = wire + static_cast<size_t>(r) * row_bytes;
    for (int p = 0; p < planes; ++p) {
      T *dst = out + static_cast<size_t>(poff[p]) +
               static_cast<size_t>(r) * static_cast<size_t>(pitch);
      const uint8_t *s = src + 2 * p;
      for (int64_t j = 0; j < n; ++j, s += planes * 2)
        dst[j] = static_cast<T>(be16(s));
    }
  }
}

template <typename T>
void decode_rows(const uint8_t *wire, T *out, int64_t m, int64_t n, int ch,
                 int64_t r0, int64_t r1, int64_t pitch, const int64_t *poff) {
#ifdef WRP_SIMD_DECODE
  if (ch == 3) {
    decode_rows_simd<3, T>(wire, out, m, n, r0, r1, pitch, poff);
    return;
  }
  if (ch == 2) {
    decode_rows_simd<2, T>(wire, out, m, n, r0, r1, pitch, poff);
    return;
  }
#endif
  decode_rows_scalar<T>(wire, out, m, n, ch, r0, r1, pitch, poff);
}

// Partition range rows over up to num_threads workers (contiguous row
// blocks: each worker's reads AND writes stay sequential).  One thread
// (the measured best on small-core hosts) runs inline, no pool.
// pitch = destination row stride in elements; poff[p] = plane p's base
// element offset into out.  The plain planar layout is pitch=n,
// poff[p]=p*m*n; the grouped device-feed layout (see
// wrp_decode_iq_i16_grouped) only changes these numbers — the decode
// loops and their cost are identical, which is what makes decode-time
// grouping free.
template <typename T>
void decode_threaded(const uint8_t *wire, T *out, int64_t m, int64_t n,
                     int ch, int32_t num_threads, int64_t pitch,
                     const int64_t *poff) {
  constexpr int64_t kMinRowsPerWorker = 32;
  const int workers = static_cast<int>(
      std::max<int64_t>(1, std::min<int64_t>(num_threads,
                                             m / kMinRowsPerWorker)));
  if (workers <= 1) {
    decode_rows<T>(wire, out, m, n, ch, 0, m, pitch, poff);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(workers);
  const int64_t chunk = (m + workers - 1) / workers;
  for (int w = 0; w < workers; ++w) {
    const int64_t r0 = w * chunk;
    const int64_t r1 = std::min<int64_t>(m, r0 + chunk);
    pool.emplace_back(
        [=] { decode_rows<T>(wire, out, m, n, ch, r0, r1, pitch, poff); });
  }
  for (auto &t : pool) t.join();
}

// Per-plane base offsets for the plain planar [ch, 2, m, n] layout.
std::vector<int64_t> planar_offsets(int64_t m, int64_t n, int ch) {
  std::vector<int64_t> poff(static_cast<size_t>(ch) * 2);
  for (size_t p = 0; p < poff.size(); ++p)
    poff[p] = static_cast<int64_t>(p) * m * n;
  return poff;
}

}  // namespace

extern "C" {

// wire[m*n*ch*4] BE int16 interleaved -> out[ch*2*m*n] float32 planar.
void wrp_decode_iq(const uint8_t *wire, float *out, int64_t m, int64_t n,
                   int64_t ch, int32_t num_threads) {
  const auto poff = planar_offsets(m, n, static_cast<int>(ch));
  decode_threaded<float>(wire, out, m, n, static_cast<int>(ch), num_threads,
                         n, poff.data());
}

// wire BE int16 interleaved -> int16 planar (compact device-feed layout:
// halves H2D bytes vs float32; the device converts on-chip).
void wrp_decode_iq_i16(const uint8_t *wire, int16_t *out, int64_t m,
                       int64_t n, int64_t ch, int32_t num_threads) {
  const auto poff = planar_offsets(m, n, static_cast<int>(ch));
  decode_threaded<int16_t>(wire, out, m, n, static_cast<int>(ch),
                           num_threads, n, poff.data());
}

// Grouped device-feed emit: scatter ONE wire sector (batch slot `slot`)
// into a caller-owned staging buffer of lane-grouped channel-sectors
// stage[total_cs/group][2][m][group*n] (channel-sector i = slot*ch + c
// lands in group i/group, lane block i%group).  Same single-pass loops as
// wrp_decode_iq_i16 — only the destination offsets and the row pitch
// differ, so decode-time grouping costs nothing over the plain planar
// emit.
void wrp_decode_iq_i16_grouped(const uint8_t *wire, int16_t *stage,
                               int64_t m, int64_t n, int64_t ch,
                               int32_t num_threads, int32_t group,
                               int64_t slot) {
  const int64_t gn = static_cast<int64_t>(group) * n;
  std::vector<int64_t> poff(static_cast<size_t>(ch) * 2);
  for (int c = 0; c < static_cast<int>(ch); ++c) {
    const int64_t i = slot * ch + c;
    for (int iq = 0; iq < 2; ++iq)
      poff[static_cast<size_t>(2 * c + iq)] =
          ((i / group) * 2 + iq) * (m * gn) + (i % group) * n;
  }
  decode_threaded<int16_t>(wire, stage, m, n, static_cast<int>(ch),
                           num_threads, gn, poff.data());
}

// One sample's float -> wire int16 value, with EXACTLY the semantics of a
// _mm_cvtps_epi32 lane: round to nearest-even, then NaN and anything
// outside int32 range becomes INT_MIN, whose low 16 bits are 0.  Keeping
// the scalar path bit-identical to the SIMD lanes matters because a
// sector's samples%4 tail would otherwise encode the same (corrupt,
// out-of-contract) float differently than its SIMD-lane neighbours —
// and numpy's own float->int16 astype on x86 takes the same
// cvt-saturate-truncate route, so all three encoders agree byte-for-byte
// on ANY input, not just in-contract 14-bit values.
static inline uint16_t encode_one_sample(float f) {
  // every float satisfying this is <= 2147483520 after rounding; NaN
  // fails the comparison and lands in the saturation branch with the
  // out-of-range values
  if (!(f >= -2147483648.0f && f < 2147483648.0f)) return 0;
  return static_cast<uint16_t>(
      static_cast<int64_t>(llrintf(f)) & 0xffff);
}

// planar float32 [ch][2][m][n] -> wire BE int16 interleaved (producer side).
// Rounds to nearest-even like the Python encoder (np.round + astype) and
// wraps values mod 2^16 like numpy within int32 range (encode_one_sample
// pins the out-of-range/NaN semantics) — the two encoders must emit
// identical wire bytes for identical floats (truncation-toward-zero here
// used to shift LSBs vs the Python path).
// Single pass like the decoder: 4 samples per block, one 16-byte float
// load per plane, cvtps_epi32 (round-to-nearest-even, NaN -> INT_MIN
// whose low 16 bits are 0 — matching encode_one_sample), then
// the interleave+byteswap as pshufb gathers into 2*ch output vectors.
void wrp_encode_iq(const float *planar, uint8_t *wire, int64_t m, int64_t n,
                   int64_t ch) {
  const size_t samples = static_cast<size_t>(m) * static_cast<size_t>(n);
  const int planes = static_cast<int>(ch) * 2;
#ifdef WRP_SIMD_DECODE
  if (ch == 3 || ch == 2) {
    // mask[o][p]: contribution of plane p's int32x4 block to output
    // vector o.  Wire byte g = 4*ch*i + 2p (+0 BE hi, +1 lo) for sample
    // i of plane p; int32 lane i holds the value LE (byte 4i = lo,
    // 4i+1 = hi).
    const int stride = 4 * static_cast<int>(ch);
    alignas(16) uint8_t mask[6][12][16];
    std::memset(mask, 0x80, sizeof(mask));
    for (int o = 0; o < static_cast<int>(ch); ++o)
      for (int b = 0; b < 16; ++b) {
        const int g = 16 * o + b, pos = g % stride, i = g / stride;
        mask[o][pos / 2][b] =
            static_cast<uint8_t>(4 * i + (pos % 2 ? 0 : 1));
      }
    const int64_t total = static_cast<int64_t>(samples);
    int64_t s0 = 0;
    for (; s0 + 4 <= total; s0 += 4) {
      __m128i v[12];
      for (int p = 0; p < planes; ++p)
        v[p] = _mm_cvtps_epi32(_mm_loadu_ps(planar + p * samples + s0));
      uint8_t *dst = wire + static_cast<size_t>(s0) * stride;
      for (int o = 0; o < static_cast<int>(ch); ++o) {
        __m128i r = _mm_shuffle_epi8(
            v[0],
            _mm_load_si128(reinterpret_cast<const __m128i *>(mask[o][0])));
        for (int p = 1; p < planes; ++p)
          r = _mm_or_si128(
              r, _mm_shuffle_epi8(v[p],
                                  _mm_load_si128(
                                      reinterpret_cast<const __m128i *>(
                                          mask[o][p]))));
        _mm_storeu_si128(reinterpret_cast<__m128i *>(dst + 16 * o), r);
      }
    }
    for (; s0 < total; ++s0) {  // samples % 4 tail
      uint8_t *dst = wire + static_cast<size_t>(s0) * stride;
      for (int p = 0; p < planes; ++p) {
        const uint16_t vv = encode_one_sample(planar[p * samples + s0]);
        dst[2 * p] = static_cast<uint8_t>((vv >> 8) & 0xff);
        dst[2 * p + 1] = static_cast<uint8_t>(vv & 0xff);
      }
    }
    return;
  }
#endif
  const size_t stride = static_cast<size_t>(ch) * 4;
  for (int p = 0; p < planes; ++p) {
    const float *src = planar + static_cast<size_t>(p) * samples;
    uint8_t *dst = wire + static_cast<size_t>(p) * 2;
    for (size_t s = 0; s < samples; ++s) {
      const uint16_t v = encode_one_sample(src[s]);
      dst[s * stride] = static_cast<uint8_t>((v >> 8) & 0xff);
      dst[s * stride + 1] = static_cast<uint8_t>(v & 0xff);
    }
  }
}

// float32 array -> big-endian bytes (floats.c aftoab equivalent).
void wrp_encode_be_f32(const float *src, uint8_t *dst, int64_t count) {
  for (int64_t i = 0; i < count; ++i) {
    uint32_t bits;
    std::memcpy(&bits, &src[i], 4);
    dst[i * 4 + 0] = static_cast<uint8_t>((bits >> 24) & 0xff);
    dst[i * 4 + 1] = static_cast<uint8_t>((bits >> 16) & 0xff);
    dst[i * 4 + 2] = static_cast<uint8_t>((bits >> 8) & 0xff);
    dst[i * 4 + 3] = static_cast<uint8_t>(bits & 0xff);
  }
}

}  // extern "C"
