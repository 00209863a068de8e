// Dense fused radar chain, stages 01-08, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel wrp_tpu/ops/pallas/fullchain.py::fused_chain_power
// (body _kernel): the form for geometries whose m does not split into radix
// branches (ops/fullchain.radix_for(m) == 1, e.g. m = 1000).  Per
// channel-sector it maps planar IQ x [2, m, n] (int16 or f32) to the
// matched-filter power pow [m/2]:
//
//   1. Y[t, j] = sum_q A_half[t, q] x[q, j]   (t < m/2, q < m), complex, with
//      the window folded into A_half (constants.stage1_operators);
//   2. the Parseval epilogue of each row of Y (chain_common.cuh).
//
// What bounds it on this card: 4 m^2 n flops per channel-sector (2.05 GFLOP
// at m = 1000, n = 512) against 4 m n bytes of int16 input (2 MB): ~1000
// flops per byte, far above the fp32 CUDA-core ridge of ~20 flops per byte,
// so the fp32 FMA rate bounds it.  The function itself needs a quarter of
// that work in the radix-8 form (M = 125 at m = 1000, which the radix
// kernel's even tiles do not divide); chip_smoke.py's bound counts that.
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
// replaces; the kernel body is the plain entry's).

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
template <typename In, int T>
__global__ void __launch_bounds__(kThreads)
fused_chain_dense_kernel(const In* __restrict__ x, const float* __restrict__ a,
                         const float* __restrict__ wd, const float* __restrict__ ph,
                         float* __restrict__ out, int m, int n) {
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
          wrp::mac_rows<T>(gr, gi, a_s + q * 2 * T, static_cast<float>(pr[q * n]),
                           static_cast<float>(pi[q * n]));
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

template <typename In, int T>
cudaError_t launch(const void* x, const float* a, const float* wd, const float* ph, float* out,
                   int bc, int m, int n, cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(2) * T * kQ + static_cast<size_t>(2) * T * n) * sizeof(float);
  auto kernel = fused_chain_dense_kernel<In, T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(m / 2 / T), static_cast<unsigned>(bc));
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const In*>(x), a, wd, ph, out, m, n);
  return cudaGetLastError();
}

template <typename In>
cudaError_t launch_tile(int tile, const void* x, const float* a, const float* wd,
                        const float* ph, float* out, int bc, int m, int n,
                        cudaStream_t stream) {
  switch (tile) {
    case 10: return launch<In, 10>(x, a, wd, ph, out, bc, m, n, stream);
    case 4: return launch<In, 4>(x, a, wd, ph, out, bc, m, n, stream);
    case 2: return launch<In, 2>(x, a, wd, ph, out, bc, m, n, stream);
    case 1: return launch<In, 1>(x, a, wd, ph, out, bc, m, n, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x [>= offset + bc, 2, m, n].  Launches on `stream` without
// synchronising; returns the launch's cudaError_t (0 on success).  The
// caller validates shapes, dtypes and the offset's range.
int wrp_fused_chain_dense(const void* x, int x_is_int16, const void* a, const void* wd,
                          const void* ph, void* out, int bc, int m, int n, int tile,
                          long long offset, void* stream) {
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
          ? launch_tile<int16_t>(tile, static_cast<const int16_t*>(x) + skip, af, wf, pf, of,
                                 bc, m, n, st)
          : launch_tile<float>(tile, static_cast<const float*>(x) + skip, af, wf, pf, of, bc,
                               m, n, st);
  return static_cast<int>(err);
}

}  // extern "C"
