// The radix-R A-stage in the TPU algorithm's matrix form, for NVIDIA Hopper
// (sm_90a): fp32 SIMT, Y stored to global memory.  The port's first
// production chain was this body; production now runs the FFT form
// (fft_chain.cuh) up to 4096 range cells and this body above it, as the
// pulse-sharded A-stage (fused_chain_astage_matrix.cu, int16 and f32 x);
// the in-kernel time breakdown (kernel_breakdown.cu) keeps it beside its
// tensor-core body, at its own and at that body's shared memory.
//
// Per unit (one channel of one sector) it maps the unit's IQ rows (range
// rows in NATURAL order) to the half-spectrum range DFT Y [2, m/2, w]:
//
//   1. g_p[t, j] = sum_q A_p[t, q] x[R q + p, j]      (p < R, t < M = m/R)
//      A_p = F_M diag(w_r c)[p::R] diag(T_p): the window row factor and the
//      DIT twiddles are folded in on the host (ops/fullchain.radix_plan).
//      Branch p reads rows R q + p by index arithmetic: no row permutation.
//   2. Y[s M + t, :] = sum_p fac[s][p] g_p[t, :]       (s < S = R/2, the
//      half-spectrum crop), fac[s][p] = exp(-2 pi i p s / R).
//
// What bounds it on this card: 4 m M w real FMAs per unit against 4 m w
// bytes of int16 input and 4 m w bytes of Y, ~64 FMA per byte: above the
// H100's ridge for fp32 CUDA-core math (67 TFLOP/s over 3.35 TB/s = 20
// FLOP/byte), so fp32 FMA issue bounds it.
//
// Design: one block owns T sub-DFT rows t0..t0+T-1 of one unit, all S
// outputs and one chunk of kThreads pulses; each thread owns one pulse
// column j and keeps g_p and Y[S][T] for it in registers; the block's slice
// of A_p is staged in shared memory as [q][t][re, im] (8 KB at T = 8,
// M = 128) and read as float4 broadcasts.  Consecutive threads hold
// consecutive pulses, so each (s, t) row store of Y coalesces.  Grid
// (M / T, ceil(w / kThreads), units), tile fastest: the tiles of one unit
// run side by side and share its rows in L2.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "chain_common.cuh"

namespace wrp {

// Planar IQ x [units, 2, m, n] (int16 or float), one unit per
// channel-sector: I and Q planes of m rows, row pitch n.
template <typename In>
struct PlanarSource {
  const In* x;
  int m, n;

  // element (row, pulse j) of unit u
  __device__ __forceinline__ const In* at(int u, int row, int j) const {
    return x + (static_cast<size_t>(u) * 2 * m + row) * n + j;
  }
  __device__ __forceinline__ size_t pitch() const { return n; }
  __device__ __forceinline__ void load(const In* p, float& vr, float& vi) const {
    vr = static_cast<float>(__ldg(p));
    vi = static_cast<float>(__ldg(p + static_cast<size_t>(m) * n));
  }
};

// The dynamic shared memory of one block: the operator slice [M][T][2].
template <int S, int T>
size_t chain_smem_bytes(int m) {
  const int M = m / (2 * S);
  return static_cast<size_t>(2) * T * M * sizeof(float);
}

// a   [R, M(q), M(t), 2] float: A_p[t, q] at ((p M + q) M + t) * 2 + {0: re, 1: im}
// fac [S, R, 2] float
// out Y [units, 2, m/2, w] float; n is the pulse count w, the grid (M / T,
// ceil(w / kThreads), units) with one pulse chunk per block.
template <class Src, int S, int T>
__global__ void __launch_bounds__(kThreads)
radix_chain_kernel(Src src, const float* __restrict__ a, const float* __restrict__ fac,
                   float* __restrict__ out, int m, int n) {
  constexpr int R = 2 * S;
  const int M = m / R;
  const int t0 = blockIdx.x * T;
  const int u = static_cast<int>(blockIdx.z);
  const int j_begin = static_cast<int>(blockIdx.y) * kThreads;
  const int j_end = j_begin + kThreads;

  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                   // [M][T][2]

  const size_t row_step = static_cast<size_t>(R) * src.pitch();

  for (int j0 = j_begin; j0 < j_end; j0 += kThreads) {
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
      stage_operator<T>(a_s, a + static_cast<size_t>(p) * M * M * 2, M, 0, M, t0);
      __syncthreads();

      float gr[T], gi[T];
#pragma unroll
      for (int t = 0; t < T; ++t) {
        gr[t] = 0.f;
        gi[t] = 0.f;
      }
      if (active) {
        const auto* px = src.at(u, p, j);  // row R q + p, pulse j
#pragma unroll 8
        for (int q = 0; q < M; ++q) {
          float vr, vi;
          src.load(px + q * row_step, vr, vi);
          mac_rows<T>(gr, gi, a_s + q * 2 * T, vr, vi);
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
      float* yr_out = out + static_cast<size_t>(u) * m * n + j;
      float* yi_out = yr_out + static_cast<size_t>(m / 2) * n;
#pragma unroll
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const size_t row = static_cast<size_t>(s) * M + t0 + t;
          yr_out[row * n] = yr[s][t];
          yi_out[row * n] = yi[s][t];
        }
      }
    }
  }
}

// min_smem: request at least this much dynamic shared memory (unused by the
// kernel), so the A-stage can be run at the fused kernel's occupancy
template <class Src, int S, int T>
cudaError_t launch_astage_instance(const Src& src, const float* a, const float* fac, float* y,
                                   int units, int m, int w, size_t min_smem,
                                   cudaStream_t stream) {
  const int M = m / (2 * S);
  const size_t smem = std::max(chain_smem_bytes<S, T>(m), min_smem);
  auto kernel = radix_chain_kernel<Src, S, T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(M / T),
                  static_cast<unsigned>((w + kThreads - 1) / kThreads),
                  static_cast<unsigned>(units));
  kernel<<<grid, kThreads, smem, stream>>>(src, a, fac, y, m, w);
  return cudaGetLastError();
}

template <class Src, int S>
cudaError_t launch_astage_tile(int tile, const Src& src, const float* a, const float* fac,
                               float* y, int units, int m, int w, size_t min_smem,
                               cudaStream_t stream) {
  switch (tile) {
    case 8: return launch_astage_instance<Src, S, 8>(src, a, fac, y, units, m, w, min_smem, stream);
    case 4: return launch_astage_instance<Src, S, 4>(src, a, fac, y, units, m, w, min_smem, stream);
    case 2: return launch_astage_instance<Src, S, 2>(src, a, fac, y, units, m, w, min_smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <class Src>
cudaError_t launch_radix_astage(int radix, int tile, const Src& src, const float* a,
                                const float* fac, float* y, int units, int m, int w,
                                cudaStream_t stream, size_t min_smem = 0) {
  if (units <= 0 || units > 65535 || w <= 0 || radix <= 1 || m % radix != 0 || tile <= 0 ||
      (m / radix) % tile != 0) {
    return cudaErrorInvalidValue;
  }
  switch (radix) {
    case 8: return launch_astage_tile<Src, 4>(tile, src, a, fac, y, units, m, w, min_smem, stream);
    case 4: return launch_astage_tile<Src, 2>(tile, src, a, fac, y, units, m, w, min_smem, stream);
    case 2: return launch_astage_tile<Src, 1>(tile, src, a, fac, y, units, m, w, min_smem, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <class Src, int S, int T>
cudaError_t astage_blocks_per_sm_instance(int m, size_t min_smem, int* blocks) {
  const size_t smem = std::max(chain_smem_bytes<S, T>(m), min_smem);
  auto kernel = radix_chain_kernel<Src, S, T>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, smem);
}

template <class Src, int S>
cudaError_t astage_blocks_per_sm_tile(int tile, int m, size_t min_smem, int* blocks) {
  switch (tile) {
    case 8: return astage_blocks_per_sm_instance<Src, S, 8>(m, min_smem, blocks);
    case 4: return astage_blocks_per_sm_instance<Src, S, 4>(m, min_smem, blocks);
    case 2: return astage_blocks_per_sm_instance<Src, S, 2>(m, min_smem, blocks);
    default: return cudaErrorInvalidValue;
  }
}

// Resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of
// the A-stage instantiation a launch at (radix, tile, m) runs, at its
// dynamic shared memory or min_smem bytes, whichever is more.
template <class Src>
cudaError_t radix_astage_blocks_per_sm(int radix, int tile, int m, size_t min_smem,
                                       int* blocks) {
  if (radix <= 1 || m % radix != 0 || tile <= 0 || (m / radix) % tile != 0) {
    return cudaErrorInvalidValue;
  }
  switch (radix) {
    case 8: return astage_blocks_per_sm_tile<Src, 4>(tile, m, min_smem, blocks);
    case 4: return astage_blocks_per_sm_tile<Src, 2>(tile, m, min_smem, blocks);
    case 2: return astage_blocks_per_sm_tile<Src, 1>(tile, m, min_smem, blocks);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace wrp
