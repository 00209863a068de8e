// Fused radar chain, stages 01-08, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel wrp_tpu/ops/pallas/fullchain.py::
// fused_chain_power_radix (body _kernel_radix).  Per channel-sector it maps
// planar IQ x [2, m, n] (int16 or f32, range rows in NATURAL order) to the
// matched-filter power pow [m/2]:
//
//   1. g_p[t, j] = sum_q A_p[t, q] x[R q + p, j]      (p < R, t < M = m/R)
//      A_p = F_M diag(w_r c)[p::R] diag(T_p): the window row factor and the
//      DIT twiddles are folded in on the host (ops/fullchain.radix_plan).
//      Branch p reads rows R q + p by index arithmetic: no row permutation.
//   2. Y[s M + t, :] = sum_p fac[s][p] g_p[t, :]       (s < S = R/2, the
//      half-spectrum crop), fac[s][p] = exp(-2 pi i p s / R).
//   3. The Parseval epilogue of wrp_tpu/pipeline.stage_b_parseval on each
//      row of Y: q = Y wd, q -= mean(q),
//      pow = n sum|q|^2 - |q.f_k1|^2 - |q.f_k2|^2.
//
// What bounds it on this card: 4 m M n real FMAs per channel-sector
// (0.27 G at 1024 x 512, R = 8; ~1.6 GFLOP per 3-channel sector) against
// 2 m n int16 input values (2 MB; 6.3 MB per sector), so ~128 FMA per
// input byte from device memory: far above the H100's ridge for fp32
// CUDA-core math (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte).  The kernel is
// bound by fp32 FMA issue, and by L2 reads, since every tile of T sub-DFT
// rows reads the whole channel-sector once (M / T = 16 times per sector).
//
// Design (a first kernel that is right; tensor cores, TMA and an operand
// split come later):
//   * fp32 FMA throughout with fp32 operators.  No bf16 hi/lo splits and no
//     clip-mode workaround: both existed because the TPU compiler lowered
//     an f32 dot as one bf16 pass.
//   * One block owns T sub-DFT rows t0..t0+T-1, all S outputs and ALL n
//     pulses: the epilogue needs whole pulse rows (a mean, a sum and two
//     projections over n).  A one-pass n sum|q|^2 - |sum q|^2 form would
//     cancel catastrophically under strong DC clutter, so the mean is
//     subtracted explicitly from rows held in shared memory.
//   * Each thread owns one pulse column j and keeps g_p and Y[S][T] for it
//     in registers; x is read coalesced along j; the block's slice of A_p
//     is staged in shared memory as [q][t][re, im] and read as float4
//     broadcasts.
//   * Y [S T, n] then lands in dynamic shared memory (128 KB at T = 8,
//     n = 512) and one warp per row runs the epilogue with warp-shuffle
//     sums.
//   * Grid (bc, M / T): 768 blocks at batch 16 x 3 channels, m = 1024.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// x   [bc, 2, m, n]  In (int16 or float), rows in natural order
// a   [R, M(q), M(t), 2] float: A_p[t, q] at ((p M + q) M + t) * 2 + {0: re, 1: im}
// fac [S, R, 2] float
// wd  [n] float, ph [4, n] float (cos k1, sin k1, cos k2, sin k2)
// out [bc, m/2] float
template <typename In, int S, int T>
__global__ void __launch_bounds__(kThreads)
fused_chain_radix_kernel(const In* __restrict__ x, const float* __restrict__ a,
                         const float* __restrict__ fac, const float* __restrict__ wd,
                         const float* __restrict__ ph, float* __restrict__ out,
                         int m, int n) {
  constexpr int R = 2 * S;
  const int M = m / R;
  const int cs = blockIdx.x;
  const int t0 = blockIdx.y * T;

  extern __shared__ __align__(16) float smem[];
  float* ys_r = smem;                  // [S * T][n]
  float* ys_i = ys_r + S * T * n;      // [S * T][n]
  float* a_s = ys_i + S * T * n;       // [M][T][2]

  const size_t plane = static_cast<size_t>(m) * n;
  const In* xr = x + static_cast<size_t>(cs) * 2 * plane;
  const In* xi = xr + plane;
  const size_t row_step = static_cast<size_t>(R) * n;

  for (int j0 = 0; j0 < n; j0 += kThreads) {
    const int j = j0 + static_cast<int>(threadIdx.x);
    const bool active = j < n;

    float yr[S][T], yi[S][T];
#pragma unroll
    for (int s = 0; s < S; ++s) {
#pragma unroll
      for (int t = 0; t < T; ++t) {
        yr[s][t] = 0.f;
        yi[s][t] = 0.f;
      }
    }

    for (int p = 0; p < R; ++p) {
      __syncthreads();  // all reads of the previous branch's operator tile are done
      const float* ap = a + static_cast<size_t>(p) * M * M * 2;
      for (int k = threadIdx.x; k < M * T * 2; k += kThreads) {
        const int q = k / (2 * T);
        const int r = k - q * (2 * T);
        a_s[k] = ap[static_cast<size_t>(q) * M * 2 + t0 * 2 + r];
      }
      __syncthreads();

      float gr[T], gi[T];
#pragma unroll
      for (int t = 0; t < T; ++t) {
        gr[t] = 0.f;
        gi[t] = 0.f;
      }
      if (active) {
        const In* pr = xr + static_cast<size_t>(p) * n + j;  // row R q + p, column j
        const In* pi = xi + static_cast<size_t>(p) * n + j;
#pragma unroll 8
        for (int q = 0; q < M; ++q) {
          const float vr = static_cast<float>(pr[q * row_step]);
          const float vi = static_cast<float>(pi[q * row_step]);
          const float4* a4 = reinterpret_cast<const float4*>(a_s + q * 2 * T);
#pragma unroll
          for (int h = 0; h < T / 2; ++h) {
            const float4 v = a4[h];  // (re, im) of rows t = 2h and 2h + 1
            gr[2 * h] = fmaf(v.x, vr, fmaf(-v.y, vi, gr[2 * h]));
            gi[2 * h] = fmaf(v.x, vi, fmaf(v.y, vr, gi[2 * h]));
            gr[2 * h + 1] = fmaf(v.z, vr, fmaf(-v.w, vi, gr[2 * h + 1]));
            gi[2 * h + 1] = fmaf(v.z, vi, fmaf(v.w, vr, gi[2 * h + 1]));
          }
        }
      }

#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float fr = fac[(s * R + p) * 2];
        const float fi = fac[(s * R + p) * 2 + 1];
#pragma unroll
        for (int t = 0; t < T; ++t) {
          yr[s][t] += fr * gr[t] - fi * gi[t];
          yi[s][t] += fr * gi[t] + fi * gr[t];
        }
      }
    }

    if (active) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int t = 0; t < T; ++t) {
          ys_r[(s * T + t) * n + j] = yr[s][t];
          ys_i[(s * T + t) * n + j] = yi[s][t];
        }
      }
    }
  }
  __syncthreads();

  // Parseval epilogue: one warp per row of Y.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float nf = static_cast<float>(n);
  for (int row = warp; row < S * T; row += kThreads / 32) {
    const float* rr = ys_r + static_cast<size_t>(row) * n;
    const float* ri = ys_i + static_cast<size_t>(row) * n;
    float sr = 0.f, si = 0.f;
    for (int jj = lane; jj < n; jj += 32) {
      const float w = wd[jj];
      sr += rr[jj] * w;
      si += ri[jj] * w;
    }
    const float mr = warp_sum(sr) / nf;
    const float mi = warp_sum(si) / nf;

    float e = 0.f;
    float d[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // q_r . ph[c], q_i . ph[c]
    for (int jj = lane; jj < n; jj += 32) {
      const float w = wd[jj];
      const float qr = rr[jj] * w - mr;
      const float qi = ri[jj] * w - mi;
      e += qr * qr + qi * qi;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float f = ph[c * n + jj];
        d[c] += qr * f;
        d[4 + c] += qi * f;
      }
    }
    e = warp_sum(e);
#pragma unroll
    for (int c = 0; c < 8; ++c) d[c] = warp_sum(d[c]);

    if (lane == 0) {
      float pw = nf * e;
      // |q . f_k|^2 = (qr.cos - qi.sin)^2 + (qr.sin + qi.cos)^2, k = k1, k2
#pragma unroll
      for (int c = 0; c < 4; c += 2) {
        const float re = d[c] - d[4 + c + 1];
        const float im = d[c + 1] + d[4 + c];
        pw -= re * re + im * im;
      }
      const int s = row / T;
      const int t = row - s * T;
      out[static_cast<size_t>(cs) * (m / 2) + s * M + t0 + t] = pw;
    }
  }
}

template <typename In, int S, int T>
cudaError_t launch(const void* x, const float* a, const float* fac, const float* wd,
                   const float* ph, float* out, int bc, int m, int n, cudaStream_t stream) {
  const int M = m / (2 * S);
  const size_t smem = (static_cast<size_t>(2) * S * T * n + static_cast<size_t>(2) * T * M) *
                      sizeof(float);
  auto kernel = fused_chain_radix_kernel<In, S, T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(bc), static_cast<unsigned>(M / T));
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const In*>(x), a, fac, wd, ph, out, m, n);
  return cudaGetLastError();
}

template <typename In, int S>
cudaError_t launch_tile(int tile, const void* x, const float* a, const float* fac,
                        const float* wd, const float* ph, float* out, int bc, int m, int n,
                        cudaStream_t stream) {
  switch (tile) {
    case 8: return launch<In, S, 8>(x, a, fac, wd, ph, out, bc, m, n, stream);
    case 4: return launch<In, S, 4>(x, a, fac, wd, ph, out, bc, m, n, stream);
    case 2: return launch<In, S, 2>(x, a, fac, wd, ph, out, bc, m, n, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename In>
cudaError_t launch_radix(int radix, int tile, const void* x, const float* a, const float* fac,
                         const float* wd, const float* ph, float* out, int bc, int m, int n,
                         cudaStream_t stream) {
  switch (radix) {
    case 8: return launch_tile<In, 4>(tile, x, a, fac, wd, ph, out, bc, m, n, stream);
    case 4: return launch_tile<In, 2>(tile, x, a, fac, wd, ph, out, bc, m, n, stream);
    case 2: return launch_tile<In, 1>(tile, x, a, fac, wd, ph, out, bc, m, n, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` without synchronising; returns the launch's
// cudaError_t (0 on success).  The caller validates shapes and dtypes.
int wrp_fused_chain_radix(const void* x, int x_is_int16, const void* a, const void* fac,
                          const void* wd, const void* ph, void* out, int bc, int m, int n,
                          int radix, int tile, void* stream) {
  if (bc <= 0 || radix <= 1 || m % radix != 0 || (m / radix) % tile != 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* af = static_cast<const float*>(a);
  const auto* ff = static_cast<const float*>(fac);
  const auto* wf = static_cast<const float*>(wd);
  const auto* pf = static_cast<const float*>(ph);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_is_int16 ? launch_radix<int16_t>(radix, tile, x, af, ff, wf, pf, of, bc, m, n, st)
                 : launch_radix<float>(radix, tile, x, af, ff, wf, pf, of, bc, m, n, st);
  return static_cast<int>(err);
}

const char* wrp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
