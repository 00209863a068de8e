// The row epilogue of the pulse-sharded chain, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel wrp_tpu/ops/pallas/fullchain.py::
// parseval_rows_power (body _kernel_parseval_rows).  Per channel-sector it
// maps half-spectrum rows Y [2, rows, n] f32 (the FULL pulse axis, any
// slice of the m/2 range bins: after the all_to_all each rank holds
// rows = m/2 / ranks of them) to the matched-filter power [rows]:
//   q = Y wd,  q -= mean(q),  pow = n sum|q|^2 - |q.f_k1|^2 - |q.f_k2|^2
// (pipeline.stage_b_parseval).
//
// What bounds it: 8 bytes of Y read per element against ~26 flops, so
// bytes: 100.7 MB at 48 channel-sectors x 512 rows x 512 pulses, 0.030 ms
// at 3.35 TB/s.  The register form reads each byte of Y once:
// - One read.  A warp takes one whole row at a time.  Lane l loads the
//   float4s l, l + 32, ... of the row's two planes with 16-byte streaming
//   loads (ld.global.cs: Y is read once) and keeps them in registers:
//   V = ceil(n / 128) float4 a plane, 4 at n = 512.  The window, the mean,
//   its explicit subtraction (the one-pass n sum|q|^2 - |sum q|^2 form
//   cancels under strong DC clutter), sum|q|^2 and the four clip-phasor
//   projections all run from those registers.
// - Constants once a warp, not once a row.  A persistent grid of one wave
//   (the SMs times the blocks that fit) walks the rows; a lane's pulse
//   positions are the same in every row, so its window values sit in
//   registers (4 V floats) for the warp's lifetime, and the four phasor
//   rows (4 n floats, 8 KB at n = 512) sit in the block's shared memory,
//   loaded once a block and read as float4s (keeping them in registers
//   would cost 16 V more a lane and halve the warps that fit).
// - Fewer shuffles.  The per-lane partial sums are reduced by a
//   transposing butterfly (`lane_sums`): K values over 32 lanes take
//   K - 1 + 5 - log2 K shuffles instead of 5 K, each lane ending with the
//   total of one of them.  A row takes 2 + 4 + 1 sums (means, the four
//   projections combined in the lanes, sum|q|^2): 19 shuffles with the
//   broadcasts, against 55 in the two-pass form.
//   Two rows a warp (13 shuffles a row) measured no faster on the card
//   (120 registers and 2 blocks per SM against 76 and 3; PERF.md), so the
//   kernel holds one.
//
// The register form takes n % 4 == 0, 4 <= n <= 1024 (V = 1, 2, 4, 8) and
// 16-byte aligned y, wd and ph (`lanes_v`, `aligned`; the wrapper's rule
// is ops/fullchain.parseval_rows_form).  Every other row length or
// alignment runs the two-pass form: one warp a row, scalar loads, the row
// read twice (chain_common.cuh `parseval_row_power`), as every n ran
// before the register form; any n >= 1.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <mutex>

#include "chain_common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = wrp::kThreads / 32;
constexpr int kMaxN = 1024;

// Sums K values (K a power of two <= 32) over the warp's 32 lanes.  v[i]
// holds lane's part of value i; at offset O a lane keeps one half of its
// values and adds its partner's part of that half (the partner keeps the
// other), so K values take K - 1 shuffles until one is left, and
// log2(32 / K) more.  Every lane returns the total of value lane / (32/K);
// v is overwritten.
template <int K, int O>
__device__ __forceinline__ float lane_sums(float* v, int lane) {
  if constexpr (O == 0) {
    return v[0];
  } else if constexpr (K == 1) {
    v[0] += __shfl_xor_sync(kFull, v[0], O);
    return lane_sums<1, O / 2>(v, lane);
  } else {
    constexpr int H = K / 2;
    const bool up = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float send = up ? v[i] : v[i + H];
      const float keep = up ? v[i + H] : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, O);
    }
    return lane_sums<H, O / 2>(v, lane);
  }
}

__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}

__device__ __forceinline__ float sum4(float4 a) { return (a.x + a.y) + (a.z + a.w); }

template <int V>
__global__ void __launch_bounds__(wrp::kThreads)
parseval_rows_kernel(const float* __restrict__ y, const float* __restrict__ wd,
                     const float* __restrict__ ph, float* __restrict__ out,
                     long long total_rows, int rows, int n) {
  extern __shared__ float4 ph_s[];  // [4][n / 4]: cos k1, sin k1, cos k2, sin k2
  const int n4 = n >> 2;
  for (int k = threadIdx.x; k < 4 * n4; k += wrp::kThreads)
    ph_s[k] = __ldg(reinterpret_cast<const float4*>(ph) + k);
  const int lane = threadIdx.x & 31;
  float4 w[V];
  bool ok[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    ok[j] = lane + 32 * j < n4;
    w[j] = ok[j] ? __ldg(reinterpret_cast<const float4*>(wd) + lane + 32 * j)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  const float nf = static_cast<float>(n);
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       row < total_rows; row += stride) {
    // the row's two planes into registers (one read of Y)
    const long long u = row / rows;
    const float4* pr = reinterpret_cast<const float4*>(
        y + (static_cast<size_t>(u) * 2 * rows + (row - u * rows)) * n);
    const float4* pi = pr + static_cast<size_t>(rows) * n4;
    float4 qr[V], qi[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      qr[j] = ok[j] ? __ldcs(pr + lane + 32 * j) : make_float4(0.f, 0.f, 0.f, 0.f);
      qi[j] = ok[j] ? __ldcs(pi + lane + 32 * j) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // q = Y wd and its sums (value 0: the real plane, 1: the imaginary)
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < V; ++j) {
      qr[j] = mul4(qr[j], w[j]);
      qi[j] = mul4(qi[j], w[j]);
      s[0] += sum4(qr[j]);
      s[1] += sum4(qi[j]);
    }
    lane_sums<2, 16>(s, lane);
    const float mr = __shfl_sync(kFull, s[0], 0) / nf;
    const float mi = __shfl_sync(kFull, s[0], 16) / nf;

    // centre; sum|q|^2; the projections q.f_k combined in the lanes:
    // c[0] = Re q.f_k1 = qr.cos1 - qi.sin1, c[1] = Im = qr.sin1 + qi.cos1,
    // c[2], c[3] the same for k2
    float e = 0.f, c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (!ok[j]) continue;  // positions past n: no element
      const int k = lane + 32 * j;
      const float4 c1 = ph_s[k], s1 = ph_s[n4 + k];
      const float4 c2 = ph_s[2 * n4 + k], s2 = ph_s[3 * n4 + k];
      const float ar[4] = {qr[j].x - mr, qr[j].y - mr, qr[j].z - mr, qr[j].w - mr};
      const float ai[4] = {qi[j].x - mi, qi[j].y - mi, qi[j].z - mi, qi[j].w - mi};
      const float fc1[4] = {c1.x, c1.y, c1.z, c1.w}, fs1[4] = {s1.x, s1.y, s1.z, s1.w};
      const float fc2[4] = {c2.x, c2.y, c2.z, c2.w}, fs2[4] = {s2.x, s2.y, s2.z, s2.w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        e = fmaf(ar[t], ar[t], fmaf(ai[t], ai[t], e));
        c[0] = fmaf(ar[t], fc1[t], fmaf(-ai[t], fs1[t], c[0]));
        c[1] = fmaf(ar[t], fs1[t], fmaf(ai[t], fc1[t], c[1]));
        c[2] = fmaf(ar[t], fc2[t], fmaf(-ai[t], fs2[t], c[2]));
        c[3] = fmaf(ar[t], fs2[t], fmaf(ai[t], fc2[t], c[3]));
      }
    }
    // lane l ends with projection l / 8; square it and add the four
    // across the lanes holding them
    float t = lane_sums<4, 16>(c, lane);
    t *= t;
    t += __shfl_xor_sync(kFull, t, 8);
    t += __shfl_xor_sync(kFull, t, 16);
    const float ee = lane_sums<1, 16>(&e, lane);
    if (lane == 0) out[row] = nf * ee - t;
  }
}

// The two-pass form, for the row lengths and alignments the register form
// does not take: one warp a row, each lane every 32nd element.
__global__ void __launch_bounds__(wrp::kThreads)
parseval_rows_two_pass_kernel(const float* __restrict__ y, const float* __restrict__ wd,
                              const float* __restrict__ ph, float* __restrict__ out,
                              long long total_rows, int rows, int n) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= total_rows) return;  // whole warps: no barrier below
  const long long u = row / rows;
  const float* rr = y + (static_cast<size_t>(u) * 2 * rows + (row - u * rows)) * n;
  const float* ri = rr + static_cast<size_t>(rows) * n;
  const float pw = wrp::parseval_row_power(rr, ri, 1, wd, ph, 1, n, n, lane);
  if (lane == 0) out[row] = pw;
}

// float4s a lane holds of one plane of a row in the register form, or 0
// for an n it does not take
int lanes_v(int n) {
  if (n < 4 || n > kMaxN || n % 4) return 0;
  const int v = (n / 4 + 31) / 32;
  return v <= 1 ? 1 : v <= 2 ? 2 : v <= 4 ? 4 : 8;
}

bool aligned(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

template <int V>
int occupancy(int* blocks_per_sm, int n) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, parseval_rows_kernel<V>, wrp::kThreads,
      static_cast<size_t>(n) * 4 * sizeof(float)));
}

// Blocks per SM of the register form's instantiation v at n, and the
// current device's SM count, each asked of the runtime once and kept: the
// queries cost more host time than the kernel takes.
std::mutex cache_mutex;
int occ_n[9] = {}, occ_blocks[9] = {};
int sm_count[64] = {};

int occupancy_of(int v, int n, int* blocks_per_sm) {
  {
    std::lock_guard<std::mutex> lock(cache_mutex);
    if (occ_n[v] == n) {
      *blocks_per_sm = occ_blocks[v];
      return 0;
    }
  }
  int rc = static_cast<int>(cudaErrorInvalidValue);
  switch (v) {
    case 1: rc = occupancy<1>(blocks_per_sm, n); break;
    case 2: rc = occupancy<2>(blocks_per_sm, n); break;
    case 4: rc = occupancy<4>(blocks_per_sm, n); break;
    case 8: rc = occupancy<8>(blocks_per_sm, n); break;
  }
  if (rc == 0) {
    std::lock_guard<std::mutex> lock(cache_mutex);
    occ_n[v] = n;
    occ_blocks[v] = *blocks_per_sm;
  }
  return rc;
}

int sms_of_current_device(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 0 && dev < 64) {
    std::lock_guard<std::mutex> lock(cache_mutex);
    if (sm_count[dev] > 0) {
      *sms = sm_count[dev];
      return 0;
    }
  }
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 0 && dev < 64) {
    std::lock_guard<std::mutex> lock(cache_mutex);
    sm_count[dev] = *sms;
  }
  return 0;
}

template <int V>
void launch(unsigned blocks, cudaStream_t stream, const float* y, const float* wd,
            const float* ph, float* out, long long total, int rows, int n) {
  parseval_rows_kernel<V><<<blocks, wrp::kThreads, static_cast<size_t>(n) * 4 * sizeof(float),
                            stream>>>(y, wd, ph, out, total, rows, n);
}

}  // namespace

extern "C" {

// The resident blocks per SM of the register form at n, into
// *blocks_per_sm; cudaErrorInvalidValue for an n that form does not take.
int wrp_parseval_rows_occupancy(int n, int* blocks_per_sm) {
  const int v = lanes_v(n);
  if (v == 0) return static_cast<int>(cudaErrorInvalidValue);
  return occupancy_of(v, n, blocks_per_sm);
}

// y [bc, 2, rows, n] float, wd [n], ph [4, n] float, out [bc, rows] float.
// form 0: the register form, a persistent grid of min(one wave, the rows'
// warps), which refuses an n or an alignment it does not take; form 1: the
// two-pass form, any n >= 1.  Launches on `stream` without synchronising;
// returns the launch's cudaError_t (0 on success, cudaErrorInvalidValue
// for a shape or form refused).  The caller validates shapes and dtypes.
int wrp_parseval_rows(const void* y, const void* wd, const void* ph, void* out, int bc,
                      int rows, int n, int form, void* stream) {
  if (bc <= 0 || rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(bc) * rows;
  long long blocks = (total + kWarps - 1) / kWarps;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* yf = static_cast<const float*>(y);
  const auto* wf = static_cast<const float*>(wd);
  const auto* pf = static_cast<const float*>(ph);
  auto* of = static_cast<float*>(out);
  if (form == 1) {
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    parseval_rows_two_pass_kernel<<<static_cast<unsigned>(blocks), wrp::kThreads, 0, s>>>(
        yf, wf, pf, of, total, rows, n);
    return static_cast<int>(cudaGetLastError());
  }
  const int v = lanes_v(n);
  if (form != 0 || v == 0 || !aligned(y) || !aligned(wd) || !aligned(ph))
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0, per_sm = 0;
  int rc = sms_of_current_device(&sms);
  if (rc == 0) rc = occupancy_of(v, n, &per_sm);
  if (rc != 0) return rc;
  const long long wave = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > wave) blocks = wave;
  const auto b = static_cast<unsigned>(blocks);
  switch (v) {
    case 1: launch<1>(b, s, yf, wf, pf, of, total, rows, n); break;
    case 2: launch<2>(b, s, yf, wf, pf, of, total, rows, n); break;
    case 4: launch<4>(b, s, yf, wf, pf, of, total, rows, n); break;
    case 8: launch<8>(b, s, yf, wf, pf, of, total, rows, n); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
