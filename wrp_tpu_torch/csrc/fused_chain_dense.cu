// Dense fused radar chain, stages 01-08, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel wrp_tpu/ops/pallas/fullchain.py::fused_chain_power
// (body _kernel) and its offset entry fused_chain_power_at (_kernel_offset):
// the chain for geometries whose m does not split into radix branches
// (ops/fullchain.radix_for(m) == 1, e.g. m = 1000 = 8 x 125).  Three
// bodies, chosen from m alone by the caller (ops/fullchain.chain_route):
//
//   * every even m <= 1024: the FFT-form body of fft_chain.cuh, launched
//     through fused_chain_radix.cu's entry wrp_fused_chain_radix (its
//     planar instantiation, with P = 8 register stages and a 5 x 5 x 5
//     Stockham leaf at m = 1000), and at m = 2 x odd in (2048, 4096] its
//     long-ray form.  The TPU's dense A_half contraction does 98.3 GFLOP
//     per 48 channel-sectors at m = 1000; the FFT 1.6, so the bytes (0.031
//     ms) bound it, as the radix chain.
//   * m = S x odd up to 8192 (S = 2, 4, 8, m <= 1024 S: 1832 = 8 x 229,
//     1836 = 4 x 459, 2002 = 2 x 1001): the cluster body of
//     cluster_chain.cuh through fused_chain_radix_cluster.cu's entry,
//     unsalted, each ray split across a cluster of S blocks whose
//     m/S-point sub-DFT is the odd leaf (Bluestein's form for a prime above
//     31: 229 at m = 1832).
//   * any other m (odd m, m = 2 x odd or 4 x odd above those, a leaf prime
//     above 512): this file's matrix kernel, the TPU
//     kernel's own algorithm, described next.  The radix entry launches it
//     too, with its salt, for a radix m the cluster body refuses (16 x p
//     above 8192, p a prime whose Bluestein length passes 1024: m = 8336;
//     above 16384): the TPU kernel
//     wrp_tpu/ops/pallas/fullchain.py::fused_chain_power_radix (with
//     offset and salt, _kernel_radix_offset) at those m (1024 < m <= 16384
//     otherwise run cluster_chain.cuh, fused_chain_radix_cluster.cu).
//     Its wire source (wrp_fused_chain_dense_wire) is the wire entries'
//     kernel at the same m: the TPU kernel fused_chain_power_wire (with
//     offset and salt, _kernel_radix_wire_offset), which wrp_tpu runs at
//     any radix m.
//
// The matrix kernel.  Per channel-sector it maps planar IQ x [2, m, n]
// (int16 or f32) to the matched-filter power pow [m/2]:
//
//   1. Y[t, j] = sum_q A_half[t, q] x[q, j]   (t < m/2, q < m), complex, with
//      the window folded into A_half (constants.stage1_operators);
//   2. the Parseval epilogue of each row of Y (chain_common.cuh).
//
// What bounds it on this card: 4 m^2 n flops per channel-sector (2.05 GFLOP
// at m = 1000, n = 512) against 4 m n bytes of int16 input (2 MB): ~1000
// flops per byte, far above the fp32 CUDA-core ridge of ~20 flops per byte,
// so the fp32 FMA rate bounds it.  The function itself needs the FFT's
// work, which the FFT body runs; chip_smoke.py's bound counts that.
//
// Design (right first; tensor cores and TMA come later):
//   * fp32 FMA with fp32 operators; no bf16 hi/lo splits (the TPU needed
//     them because its compiler lowered an f32 dot as one bf16 pass).
//   * One block owns T rows of Y and ALL n pulses (the epilogue needs whole
//     rows).  Each thread owns one pulse column and keeps its T complex sums
//     in registers; x is read coalesced along the pulses.
//   * A^T [q][t] is staged KQ rows at a time into shared memory as
//     [q][t][re, im] and read as broadcasts (float4 for even T).
//   * Y [T, n] then lands in shared memory and one warp per row runs the
//     epilogue.  T = 10 at m = 1000 (45 KB of shared memory, several blocks
//     per SM).
//   * Grid (m/2 / T, bc): the tiles of one channel-sector run side by side
//     and share its rows in L2.
//
// `offset` (channel-sectors) starts the launch `offset` units into a larger
// staged array: the benchmark's entry fused_chain_power_at (the TPU's
// _kernel_offset, whose scalar-prefetch index map this pointer arithmetic
// replaces; the kernel body is the plain entry's).  `salt` (0 from the
// dense entries) is added to every sample after its conversion to f32,
// as in the salted FFT-form entries.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "chain_common.cuh"

namespace {

using wrp::kThreads;

constexpr int kQ = 64;  // A^T rows staged per step

// x   [bc, 2, m, n]  In (int16 or float)
// a   [m(q), m/2(t), 2] float: A_half[t, q] at (q (m/2) + t) * 2 + {0: re, 1: im}
// wd  [n] float, ph [4, n] float
// out [bc, m/2] float
// kSalted: `salt` added to every sample (the radix entry above 4096); the
// unsalted instantiations are the dense entries' kernel as it was
template <typename In, int T, bool kSalted>
__global__ void __launch_bounds__(kThreads)
fused_chain_dense_kernel(const In* __restrict__ x, const float* __restrict__ a,
                         const float* __restrict__ wd, const float* __restrict__ ph,
                         float* __restrict__ out, int m, int n, float salt) {
  const int mh = m / 2;
  const int t0 = blockIdx.x * T;
  const int cs = blockIdx.y;

  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                  // [kQ][T][2]
  float* ys_r = a_s + 2 * T * kQ;     // [T][n]
  float* ys_i = ys_r + T * n;         // [T][n]

  const size_t plane = static_cast<size_t>(m) * n;
  const In* xr = x + static_cast<size_t>(cs) * 2 * plane;
  const In* xi = xr + plane;

  for (int j0 = 0; j0 < n; j0 += kThreads) {
    const int j = j0 + static_cast<int>(threadIdx.x);
    const bool active = j < n;

    float gr[T], gi[T];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      gr[t] = 0.f;
      gi[t] = 0.f;
    }
    for (int q0 = 0; q0 < m; q0 += kQ) {
      const int kq = min(kQ, m - q0);
      __syncthreads();  // all reads of the previous operator tile are done
      wrp::stage_operator<T>(a_s, a, mh, q0, kq, t0);
      __syncthreads();
      if (active) {
        const In* pr = xr + static_cast<size_t>(q0) * n + j;
        const In* pi = xi + static_cast<size_t>(q0) * n + j;
#pragma unroll 8
        for (int q = 0; q < kq; ++q) {
          if constexpr (kSalted) {
            wrp::mac_rows<T>(gr, gi, a_s + q * 2 * T, static_cast<float>(pr[q * n]) + salt,
                             static_cast<float>(pi[q * n]) + salt);
          } else {
            wrp::mac_rows<T>(gr, gi, a_s + q * 2 * T, static_cast<float>(pr[q * n]),
                             static_cast<float>(pi[q * n]));
          }
        }
      }
    }
    if (active) {
#pragma unroll
      for (int t = 0; t < T; ++t) {
        ys_r[t * n + j] = gr[t];
        ys_i[t * n + j] = gi[t];
      }
    }
  }
  __syncthreads();

  // Parseval epilogue: one warp per row of Y.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int t = warp; t < T; t += kThreads / 32) {
    const float pw = wrp::parseval_row_power(ys_r + static_cast<size_t>(t) * n,
                                             ys_i + static_cast<size_t>(t) * n, 1, wd, ph, 1,
                                             n, n, lane);
    if (lane == 0) out[static_cast<size_t>(cs) * mh + t0 + t] = pw;
  }
}

template <typename In, int T, bool kSalted>
cudaError_t launch(const void* x, const float* a, const float* wd, const float* ph, float* out,
                   int bc, int m, int n, float salt, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(2) * T * kQ + static_cast<size_t>(2) * T * n) * sizeof(float);
  auto kernel = fused_chain_dense_kernel<In, T, kSalted>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(m / 2 / T), static_cast<unsigned>(bc));
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const In*>(x), a, wd, ph, out, m, n,
                                           salt);
  return cudaGetLastError();
}

template <typename In, bool kSalted>
cudaError_t launch_tile(int tile, const void* x, const float* a, const float* wd,
                        const float* ph, float* out, int bc, int m, int n, float salt,
                        cudaStream_t stream) {
  switch (tile) {
    case 10: return launch<In, 10, kSalted>(x, a, wd, ph, out, bc, m, n, salt, stream);
    case 4: return launch<In, 4, kSalted>(x, a, wd, ph, out, bc, m, n, salt, stream);
    case 2: return launch<In, 2, kSalted>(x, a, wd, ph, out, bc, m, n, salt, stream);
    case 1: return launch<In, 1, kSalted>(x, a, wd, ph, out, bc, m, n, salt, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename In>
cudaError_t launch_salt(int tile, const In* x, const float* a, const float* wd,
                        const float* ph, float* out, int bc, int m, int n, int salt,
                        cudaStream_t stream) {
  if (salt == 0) return launch_tile<In, false>(tile, x, a, wd, ph, out, bc, m, n, 0.f, stream);
  return launch_tile<In, true>(tile, x, a, wd, ph, out, bc, m, n, static_cast<float>(salt),
                               stream);
}

// The wire source: the same body on raw wire words w [bs, m, ch n] int32,
// decoded in registers (chain_common.cuh decode_word, the arithmetic of
// fft_chain.cuh WireIq::load).  Unit u = blockIdx.y is channel u % ch of
// sector u / ch; its pulse j is word ch j + c of each row, so the channel
// deinterleave never happens.  out [bs, ch, m/2] float.  A kernel of its
// own, not a source parameter of the planar kernel: the planar
// instantiations keep their text, and with it their registers.
template <int T, bool kSalted>
__global__ void __launch_bounds__(kThreads)
fused_chain_dense_wire_kernel(const int32_t* __restrict__ w, const float* __restrict__ a,
                              const float* __restrict__ wd, const float* __restrict__ ph,
                              float* __restrict__ out, int m, int n, int ch, float salt) {
  const int mh = m / 2;
  const int t0 = blockIdx.x * T;
  const int u = blockIdx.y;
  const int sec = u / ch;

  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                  // [kQ][T][2]
  float* ys_r = a_s + 2 * T * kQ;     // [T][n]
  float* ys_i = ys_r + T * n;         // [T][n]

  const size_t pitch = static_cast<size_t>(ch) * n;  // words a row
  const int32_t* xw = w + static_cast<size_t>(sec) * m * pitch + (u - sec * ch);

  for (int j0 = 0; j0 < n; j0 += kThreads) {
    const int j = j0 + static_cast<int>(threadIdx.x);
    const bool active = j < n;

    float gr[T], gi[T];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      gr[t] = 0.f;
      gi[t] = 0.f;
    }
    for (int q0 = 0; q0 < m; q0 += kQ) {
      const int kq = min(kQ, m - q0);
      __syncthreads();  // all reads of the previous operator tile are done
      wrp::stage_operator<T>(a_s, a, mh, q0, kq, t0);
      __syncthreads();
      if (active) {
        const int32_t* p = xw + static_cast<size_t>(q0) * pitch + static_cast<size_t>(j) * ch;
#pragma unroll 8
        for (int q = 0; q < kq; ++q) {
          float vr, vi;
          wrp::decode_word(__ldg(p + q * pitch), vr, vi);
          if constexpr (kSalted) {
            vr += salt;
            vi += salt;
          }
          wrp::mac_rows<T>(gr, gi, a_s + q * 2 * T, vr, vi);
        }
      }
    }
    if (active) {
#pragma unroll
      for (int t = 0; t < T; ++t) {
        ys_r[t * n + j] = gr[t];
        ys_i[t * n + j] = gi[t];
      }
    }
  }
  __syncthreads();

  // Parseval epilogue: one warp per row of Y.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int t = warp; t < T; t += kThreads / 32) {
    const float pw = wrp::parseval_row_power(ys_r + static_cast<size_t>(t) * n,
                                             ys_i + static_cast<size_t>(t) * n, 1, wd, ph, 1,
                                             n, n, lane);
    if (lane == 0) out[static_cast<size_t>(u) * mh + t0 + t] = pw;
  }
}

template <int T, bool kSalted>
cudaError_t launch_wire(const int32_t* w, const float* a, const float* wd, const float* ph,
                        float* out, int bs, int m, int n, int ch, float salt,
                        cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(2) * T * kQ + static_cast<size_t>(2) * T * n) * sizeof(float);
  auto kernel = fused_chain_dense_wire_kernel<T, kSalted>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(m / 2 / T), static_cast<unsigned>(bs * ch));
  kernel<<<grid, kThreads, smem, stream>>>(w, a, wd, ph, out, m, n, ch, salt);
  return cudaGetLastError();
}

template <bool kSalted>
cudaError_t launch_wire_tile(int tile, const int32_t* w, const float* a, const float* wd,
                             const float* ph, float* out, int bs, int m, int n, int ch,
                             float salt, cudaStream_t stream) {
  switch (tile) {
    case 10: return launch_wire<10, kSalted>(w, a, wd, ph, out, bs, m, n, ch, salt, stream);
    case 4: return launch_wire<4, kSalted>(w, a, wd, ph, out, bs, m, n, ch, salt, stream);
    case 2: return launch_wire<2, kSalted>(w, a, wd, ph, out, bs, m, n, ch, salt, stream);
    case 1: return launch_wire<1, kSalted>(w, a, wd, ph, out, bs, m, n, ch, salt, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x [>= offset + bc, 2, m, n]; `salt` an int32 added to every sample (0:
// none).  Launches on `stream` without synchronising; returns the
// launch's cudaError_t (0 on success).  The caller validates shapes,
// dtypes and the offset's range.
int wrp_fused_chain_dense(const void* x, int x_is_int16, const void* a, const void* wd,
                          const void* ph, void* out, int bc, int m, int n, int tile,
                          long long offset, int salt, void* stream) {
  if (bc <= 0 || n <= 0 || m <= 0 || m % 2 != 0 || tile <= 0 || (m / 2) % tile != 0 ||
      offset < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t skip = static_cast<size_t>(offset) * 2 * m * n;  // elements
  const auto* af = static_cast<const float*>(a);
  const auto* wf = static_cast<const float*>(wd);
  const auto* pf = static_cast<const float*>(ph);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_is_int16
          ? launch_salt<int16_t>(tile, static_cast<const int16_t*>(x) + skip, af, wf, pf, of,
                                 bc, m, n, salt, st)
          : launch_salt<float>(tile, static_cast<const float*>(x) + skip, af, wf, pf, of, bc,
                               m, n, salt, st);
  return static_cast<int>(err);
}

// The matrix kernel on wire words w [>= offset + bs, m, ch n] int32 ->
// out [bs, ch, m/2] (the wire entries above 4096: ops/fullchain.
// fused_chain_power_wire); `offset` counts SECTORS, `salt` an int32 added
// to every decoded sample (0: none).  Launches on `stream` without
// synchronising; returns the launch's cudaError_t (0 on success).  The
// caller validates shapes, dtypes and the offset's range.
int wrp_fused_chain_dense_wire(const void* w, const void* a, const void* wd, const void* ph,
                               void* out, int bs, int m, int n, int ch, int tile,
                               long long offset, int salt, void* stream) {
  if (bs <= 0 || n <= 0 || ch <= 0 || m <= 0 || m % 2 != 0 || tile <= 0 ||
      (m / 2) % tile != 0 || offset < 0 || static_cast<long long>(bs) * ch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* wp = static_cast<const int32_t*>(w) + static_cast<size_t>(offset) * m * ch * n;
  const auto* af = static_cast<const float*>(a);
  const auto* wf = static_cast<const float*>(wd);
  const auto* pf = static_cast<const float*>(ph);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      salt == 0 ? launch_wire_tile<false>(tile, wp, af, wf, pf, of, bs, m, n, ch, 0.f, st)
                : launch_wire_tile<true>(tile, wp, af, wf, pf, of, bs, m, n, ch,
                                         static_cast<float>(salt), st);
  return static_cast<int>(err);
}

}  // extern "C"
