// The radix-R fused chain kernel in the TPU algorithm's matrix form,
// stages 01-08, for NVIDIA Hopper (sm_90a).  The port's production chain
// runs the FFT form (fft_chain.cuh); this body stays as the one that the
// in-kernel time breakdown ablates (kernel_breakdown.cu): Body::kFused the
// whole chain, Body::kDots and Body::kCombine with work removed,
// Body::kAStage steps 1-2 with Y stored to global memory.  The `Src`
// policies below say how an element is loaded (planar IQ or raw wire
// words, and the breakdown's salted planar source).
//
// Per unit (one channel of one sector) it maps the unit's IQ rows (range
// rows in NATURAL order) to the matched-filter power pow [m/2]:
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
// What bounds it on this card: 4 m M n real FMAs per unit (0.27 G at
// 1024 x 512, R = 8; ~1.6 GFLOP per 3-channel sector) against 4 m n bytes
// of int16 or wire input (2 MB; 6.3 MB per sector), so ~128 FMA per input
// byte from device memory: far above the H100's ridge for fp32 CUDA-core
// math (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte).  The kernel is bound by
// fp32 FMA issue, and by L2 reads, since every tile of T sub-DFT rows reads
// the whole unit once (M / T = 16 times per unit).
//
// Design (a first kernel that is right; tensor cores, TMA and an operand
// split come later):
//   * fp32 FMA throughout with fp32 operators.  No bf16 hi/lo splits and no
//     clip-mode workaround: both existed because the TPU compiler lowered
//     an f32 dot as one bf16 pass.
//   * One block owns T sub-DFT rows t0..t0+T-1 of one unit, all S outputs
//     and ALL n pulses: the epilogue needs whole pulse rows (a mean, a sum
//     and two projections over n).  A one-pass n sum|q|^2 - |sum q|^2 form
//     would cancel catastrophically under strong DC clutter, so the mean is
//     subtracted explicitly from rows held in shared memory.
//   * Each thread owns one pulse column j and keeps g_p and Y[S][T] for it
//     in registers; the block's slice of A_p is staged in shared memory as
//     [q][t][re, im] and read as float4 broadcasts.
//   * Y [S T, n] then lands in dynamic shared memory (128 KB at T = 8,
//     n = 512) and one warp per row runs the epilogue (chain_common.cuh).
//   * Grid (M / T, channels, sectors), tile fastest: the tiles of one unit
//     are adjacent block indices, run side by side and share the unit's
//     rows in L2.  The transposed order (unit fastest) spreads ~132
//     co-resident blocks over ~132 units, beyond the 50 MB L2, and was 1.6x
//     slower; on wire words, folding channels and sectors into one grid
//     dimension (M / T, ch bs) was 1.25x slower than keeping them apart,
//     though the block order is the same (PERF.md).
//   * The wire policy gives each block one channel and reads its words at
//     stride ch: all channels per block (1,536 lanes at 3 x 512) fits only
//     T = 4 in shared memory and measured 1.8x slower (PERF.md).
//   * The A-stage and the ablations share the body through a template
//     parameter (`Body`, `if constexpr` branches), not a device function
//     called by several kernels: that factoring compiled the fused planar
//     kernel 1.34-1.41x slower (2.24-2.36 vs 1.67 ms per 48
//     channel-sectors, PERF.md), with the same registers and no spills.
#pragma once

#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include "chain_common.cuh"

namespace wrp {

// Planar IQ x [units, 2, m, n] (int16 or float), one unit per
// channel-sector: I and Q planes of m rows, row pitch n.  The epilogue's
// window and phasors are the planar wd [n], ph [4, n].
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
  // unit u's epilogue constants: entry k at wd[off + k * stride], phasor c
  // at ph[off + c * ph_row + k * stride]
  __device__ __forceinline__ int const_offset(int) const { return 0; }
  __device__ __forceinline__ int const_stride() const { return 1; }
  __device__ __forceinline__ int const_row() const { return n; }
};

// Wire words w [bs, m, ch n] int32, one unit per (sector, channel): unit u
// is channel u % ch of sector u / ch, whose pulse j is word ch j + c of
// each row (row pitch ch n), decoded in registers.  The epilogue reads the
// channel-tiled wd_il [ch n], ph_il [4, ch n] at the unit's own lanes.
struct WireSource {
  const int32_t* w;
  int m, n, ch;

  __device__ __forceinline__ const int32_t* at(int u, int row, int j) const {
    const int sec = u / ch;
    return w + (static_cast<size_t>(sec) * m + row) * ch * n + static_cast<size_t>(j) * ch +
           (u - sec * ch);
  }
  __device__ __forceinline__ size_t pitch() const { return static_cast<size_t>(ch) * n; }
  __device__ __forceinline__ void load(const int32_t* p, float& vr, float& vi) const {
    decode_word(__ldg(p), vr, vi);
  }
  __device__ __forceinline__ int const_offset(int u) const { return u % ch; }
  __device__ __forceinline__ int const_stride() const { return ch; }
  __device__ __forceinline__ int const_row() const { return ch * n; }
};

// The benchmark's salted entries (fused_chain_radix_salted.cu,
// fused_chain_wire_salted.cu): Src with `salt` added to every I and Q
// sample after its conversion to f32 and before the contraction, as
// wrp_tpu's _radix_contract does.  A policy of its own, so the unsalted
// instantiations of the kernel body compile exactly as they did.
template <class Src>
struct Salted : Src {
  float salt;

  template <typename P>
  __device__ __forceinline__ void load(const P* p, float& vr, float& vi) const {
    Src::load(p, vr, vi);
    vr += salt;
    vi += salt;
  }
};

// a   [R, M(q), M(t), 2] float: A_p[t, q] at ((p M + q) M + t) * 2 + {0: re, 1: im}
// fac [S, R, 2] float
// wd, ph: the epilogue constants as the policy describes them
// out [units, m/2] float
//
// Body::kAStage: the A-stage of the pulse-sharded path.  n is then the
// rank's pulse count w, the grid is (M / T, ceil(w / kThreads), units) with
// one pulse chunk per block, out is Y [units, 2, m/2, w] (wd, ph unused),
// and Y goes straight to global memory: consecutive threads hold
// consecutive pulses, so each (s, t) row store coalesces.  The block then
// holds only its operator slice (8 KB at T = 8, M = 128), so registers, not
// shared memory, bound the blocks per SM.
//
// Body::kDots and Body::kCombine: the fused kernel with work removed, at
// its grid and its dynamic shared memory (so at its occupancy), for the
// in-kernel time breakdown (wd, ph unused; out [units, m/2]):
//   kCombine  steps 1-2 as in production, Y stored to shared memory as in
//             production; the epilogue is one warp per row summing
//             sum_j (Yr + Yi)[row, j].
//   kDots     step 1 only: branch p's g_p is added, not combined, onto
//             the register-held Y of block s = p mod S (2 T adds under a
//             branch uniform across the block, against the combine's
//             4 S T FMAs), so row s M + t holds (g_s + g_{s+S})[t, :];
//             then the combine's store and row sum.  combine - dots is
//             the combine's cost.  Writing g_p into the shared-memory rows
//             instead ran 1.3x slower than the combine (52 registers, a
//             different schedule of the contraction's loads); indexing the
//             registers by the runtime p mod S put them in local memory
//             (256 bytes of stack) and ran 1.5x slower (PERF.md).
enum class Body : int { kFused = 0, kAStage = 1, kDots = 2, kCombine = 3 };

// The dynamic shared memory of one block: the operator slice [M][T][2] and,
// except for the A-stage, Y [2][S T][n].
template <int S, int T, Body B>
size_t chain_smem_bytes(int m, int n) {
  const int M = m / (2 * S);
  if (B == Body::kAStage) return static_cast<size_t>(2) * T * M * sizeof(float);
  return (static_cast<size_t>(2) * S * T * n + static_cast<size_t>(2) * T * M) * sizeof(float);
}

template <class Src, int S, int T, Body B>
__global__ void __launch_bounds__(kThreads)
radix_chain_kernel(Src src, const float* __restrict__ a, const float* __restrict__ fac,
                   const float* __restrict__ wd, const float* __restrict__ ph,
                   float* __restrict__ out, int m, int n) {
  constexpr bool kAStage = B == Body::kAStage;
  constexpr int R = 2 * S;
  const int M = m / R;
  const int t0 = blockIdx.x * T;
  // fused: grid (M / T, channels, sectors), every pulse in each block
  const int u = kAStage ? static_cast<int>(blockIdx.z)
                        : static_cast<int>(blockIdx.z * gridDim.y + blockIdx.y);
  const int j_begin = kAStage ? static_cast<int>(blockIdx.y) * kThreads : 0;
  const int j_end = kAStage ? j_begin + kThreads : n;

  extern __shared__ __align__(16) float smem[];
  float* a_s = smem;                   // [M][T][2]
  float* ys_r = a_s + 2 * T * M;       // [S * T][n]
  float* ys_i = ys_r + S * T * n;      // [S * T][n]

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

      if constexpr (B == Body::kDots) {
        // no combine: g_p is added onto the Y registers of block p mod S
        // (a branch uniform across the block; static indices keep yr, yi
        // in registers)
        const int sp = p % S;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          if (s == sp) {
#pragma unroll
            for (int t = 0; t < T; ++t) {
              yr[s][t] += gr[t];
              yi[s][t] += gi[t];
            }
          }
        }
      } else {
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
    }

    if (active) {
      if constexpr (kAStage) {
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
      } else {
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
  }
  if constexpr (kAStage) return;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if constexpr (B == Body::kFused) {
    // Parseval epilogue: one warp per row of Y.
    const int co = src.const_offset(u);
    for (int row = warp; row < S * T; row += kThreads / 32) {
      const float pw = parseval_row_power(ys_r + static_cast<size_t>(row) * n,
                                          ys_i + static_cast<size_t>(row) * n, 1, wd + co,
                                          ph + co, src.const_stride(), src.const_row(), n, lane);
      if (lane == 0) {
        const int s = row / T;
        const int t = row - s * T;
        out[static_cast<size_t>(u) * (m / 2) + s * M + t0 + t] = pw;
      }
    }
  } else {
    // the ablations' epilogue: one warp per row sums Yr + Yi over the pulses
    for (int row = warp; row < S * T; row += kThreads / 32) {
      const float* rr = ys_r + static_cast<size_t>(row) * n;
      const float* ri = ys_i + static_cast<size_t>(row) * n;
      float v = 0.f;
      for (int k = lane; k < n; k += 32) v += rr[k] + ri[k];
      v = warp_sum(v);
      if (lane == 0) {
        const int s = row / T;
        const int t = row - s * T;
        out[static_cast<size_t>(u) * (m / 2) + s * M + t0 + t] = v;
      }
    }
  }
}

template <class Src, int S, int T, Body B>
cudaError_t launch_instance(const Src& src, const float* a, const float* fac, const float* wd,
                            const float* ph, float* out, int sectors, int channels, int m,
                            int n, cudaStream_t stream) {
  const int M = m / (2 * S);
  const size_t smem = chain_smem_bytes<S, T, B>(m, n);
  auto kernel = radix_chain_kernel<Src, S, T, B>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(M / T), static_cast<unsigned>(channels),
                  static_cast<unsigned>(sectors));
  kernel<<<grid, kThreads, smem, stream>>>(src, a, fac, wd, ph, out, m, n);
  return cudaGetLastError();
}

template <class Src, int S, Body B>
cudaError_t launch_radix_chain_tile(int tile, const Src& src, const float* a, const float* fac,
                                    const float* wd, const float* ph, float* out, int sectors,
                                    int channels, int m, int n, cudaStream_t stream) {
  switch (tile) {
    case 8: return launch_instance<Src, S, 8, B>(src, a, fac, wd, ph, out, sectors, channels, m, n, stream);
    case 4: return launch_instance<Src, S, 4, B>(src, a, fac, wd, ph, out, sectors, channels, m, n, stream);
    case 2: return launch_instance<Src, S, 2, B>(src, a, fac, wd, ph, out, sectors, channels, m, n, stream);
    default: return cudaErrorInvalidValue;
  }
}

// Launches on `stream` without synchronising over units u = sector *
// channels + channel; the caller validates shapes and dtypes (and applies
// a benchmark slab offset to the source's pointer).  sectors and
// channels <= 65535 (the grid's z and y extents).  B is the production
// chain or one of its ablations (same grid, same shared memory).
template <class Src, Body B = Body::kFused>
cudaError_t launch_radix_chain(int radix, int tile, const Src& src, const float* a,
                               const float* fac, const float* wd, const float* ph, float* out,
                               int sectors, int channels, int m, int n, cudaStream_t stream) {
  static_assert(B != Body::kAStage, "the A-stage launches through launch_radix_astage");
  if (sectors <= 0 || sectors > 65535 || channels <= 0 || channels > 65535 || n <= 0 ||
      radix <= 1 || m % radix != 0 || tile <= 0 || (m / radix) % tile != 0) {
    return cudaErrorInvalidValue;
  }
  switch (radix) {
    case 8: return launch_radix_chain_tile<Src, 4, B>(tile, src, a, fac, wd, ph, out, sectors, channels, m, n, stream);
    case 4: return launch_radix_chain_tile<Src, 2, B>(tile, src, a, fac, wd, ph, out, sectors, channels, m, n, stream);
    case 2: return launch_radix_chain_tile<Src, 1, B>(tile, src, a, fac, wd, ph, out, sectors, channels, m, n, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <class Src, int S, int T, Body B>
cudaError_t blocks_per_sm_instance(int m, int n, size_t min_smem, int* blocks) {
  const size_t smem = std::max(chain_smem_bytes<S, T, B>(m, n), min_smem);
  auto kernel = radix_chain_kernel<Src, S, T, B>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kThreads, smem);
}

template <class Src, int S, Body B>
cudaError_t blocks_per_sm_tile(int tile, int m, int n, size_t min_smem, int* blocks) {
  switch (tile) {
    case 8: return blocks_per_sm_instance<Src, S, 8, B>(m, n, min_smem, blocks);
    case 4: return blocks_per_sm_instance<Src, S, 4, B>(m, n, min_smem, blocks);
    case 2: return blocks_per_sm_instance<Src, S, 2, B>(m, n, min_smem, blocks);
    default: return cudaErrorInvalidValue;
  }
}

// Resident blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor) of
// the instantiation a launch of body B at (radix, tile, m, n) runs, at its
// dynamic shared memory or min_smem bytes, whichever is more; n is the
// A-stage's pulse count w for kAStage.
template <class Src, Body B>
cudaError_t radix_chain_blocks_per_sm(int radix, int tile, int m, int n, size_t min_smem,
                                      int* blocks) {
  if (n <= 0 || radix <= 1 || m % radix != 0 || tile <= 0 || (m / radix) % tile != 0) {
    return cudaErrorInvalidValue;
  }
  switch (radix) {
    case 8: return blocks_per_sm_tile<Src, 4, B>(tile, m, n, min_smem, blocks);
    case 4: return blocks_per_sm_tile<Src, 2, B>(tile, m, n, min_smem, blocks);
    case 2: return blocks_per_sm_tile<Src, 1, B>(tile, m, n, min_smem, blocks);
    default: return cudaErrorInvalidValue;
  }
}

// min_smem: request at least this much dynamic shared memory (unused by the
// kernel), so the A-stage can be run at the fused kernel's occupancy
template <class Src, int S, int T>
cudaError_t launch_astage_instance(const Src& src, const float* a, const float* fac, float* y,
                                   int units, int m, int w, size_t min_smem,
                                   cudaStream_t stream) {
  const int M = m / (2 * S);
  const size_t smem = std::max(chain_smem_bytes<S, T, Body::kAStage>(m, w), min_smem);
  auto kernel = radix_chain_kernel<Src, S, T, Body::kAStage>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(M / T),
                  static_cast<unsigned>((w + kThreads - 1) / kThreads),
                  static_cast<unsigned>(units));
  kernel<<<grid, kThreads, smem, stream>>>(src, a, fac, nullptr, nullptr, y, m, w);
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

}  // namespace wrp
