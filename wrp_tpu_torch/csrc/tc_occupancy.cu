// The tensor-core occupancy probe, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tools/mxu_occupancy.py (`pl.pallas_call` at :110,
// body `kern` at :96-106): matrix-unit throughput against dot width at the
// chain kernel's operand shapes.  Step b computes
//
//   out[b, :] = rowsum( sum_{d < ndots} A_d @ X[:, slab(b)] )
//
// for A [ndots_max, M, K] bf16 and X [K, distinct * wmax] bf16, slab(b) the
// `width` columns from column (b mod distinct) * wmax, ndots = lanes_total /
// width: the same multiply-adds per step at every width (M K lanes_total).
//
// What bounds it: 2 M K lanes_total flops per step (1.208 GFLOP at 128 x 384
// x 12,288; 1.22 us at the data sheet's 989.4 TFLOP/s dense bf16) on a few
// MB of operands: the tensor cores.
//
// Design (a first tensor-core kernel that is right, with mma.sync; a wgmma
// version is later work):
//   * One block per (step b, dot d), M / 16 warps, warp w owning rows
//     16w..16w+15.  The TPU kept all 24 A_d resident in VMEM (2.4 MB) and
//     streamed one [K, W] X block per grid step; neither fits one block's
//     227 KB of shared memory here (one X block is 384 KB at W = 512), so
//     the A set lives in L2 and the block stages its A_d once (96 KB at
//     128 x 384) and reuses it over all `width` columns of its slab, which
//     stream through shared memory in 64-column slices (cp.async, double
//     buffered).  That A reuse is what the width sweep measures.
//   * Per slice each warp accumulates its 16 x 64 tile over K with
//     mma.m16n8k16 (fp32 accumulators, 32 registers), then folds it into
//     two running row sums; one atomic add per row and block at the end
//     (out is zeroed by the caller).
//   * Widths that are not a multiple of 64 take 8-column slices (NT = 1).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;  // bf16 of padding per shared-memory row (16 bytes)

template <int NT>
__global__ void __launch_bounds__(256)
tc_dot_kernel(const bf16* __restrict__ a, const bf16* __restrict__ x, float* __restrict__ out,
              int M, int K, int width, int x_pitch, int wmax, int distinct) {
  constexpr int BN = 8 * NT;
  const int b = blockIdx.x;
  const int d = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5);
  const int a_pitch = K + kPad;
  constexpr int xs_pitch = BN + kPad;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);  // [M][a_pitch]
  bf16* xs = as + static_cast<size_t>(M) * a_pitch;  // 2 x [K][xs_pitch]

  const bf16* ad = a + static_cast<size_t>(d) * M * K;
  const int kc = K / 8;  // 16-byte chunks per row of A
  for (int c = threadIdx.x; c < M * kc; c += blockDim.x) {
    const int row = c / kc;
    const int col = (c - row * kc) * 8;
    wrp::cp_async16(as + row * a_pitch + col, ad + static_cast<size_t>(row) * K + col);
  }
  const bf16* xb = x + static_cast<size_t>(b % distinct) * wmax;
  auto stage_slice = [&](int slice, int buf) {
    bf16* dst = xs + static_cast<size_t>(buf) * K * xs_pitch;
    const bf16* src = xb + slice * BN;
    constexpr int nc = BN / 8;
    for (int c = threadIdx.x; c < K * nc; c += blockDim.x) {
      const int k = c / nc;
      const int col = (c - k * nc) * 8;
      wrp::cp_async16(dst + k * xs_pitch + col, src + static_cast<size_t>(k) * x_pitch + col);
    }
  };
  stage_slice(0, 0);
  wrp::cp_async_commit();  // group 0: A_d and slice 0

  float s_lo = 0.f, s_hi = 0.f;  // running sums of rows r0 + g and r0 + g + 8
  const int slices = width / BN;
  for (int sl = 0; sl < slices; ++sl) {
    if (sl + 1 < slices) stage_slice(sl + 1, (sl + 1) & 1);
    wrp::cp_async_commit();
    wrp::cp_async_wait<1>();  // everything but slice sl + 1 has landed
    __syncthreads();
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    wrp::warp_tile_mma<NT>(acc, as, a_pitch, r0,
                           xs + static_cast<size_t>(sl & 1) * K * xs_pitch, xs_pitch, 0, K,
                           lane);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s_lo += acc[j][0] + acc[j][1];
      s_hi += acc[j][2] + acc[j][3];
    }
    __syncthreads();  // slice sl's buffer is refilled at sl + 2
  }
  // the four lanes of a quad hold the same two rows
  s_lo += __shfl_xor_sync(0xffffffffu, s_lo, 1);
  s_lo += __shfl_xor_sync(0xffffffffu, s_lo, 2);
  s_hi += __shfl_xor_sync(0xffffffffu, s_hi, 1);
  s_hi += __shfl_xor_sync(0xffffffffu, s_hi, 2);
  if ((lane & 3) == 0) {
    float* o = out + static_cast<size_t>(b) * M + r0 + (lane >> 2);
    atomicAdd(o, s_lo);
    atomicAdd(o + 8, s_hi);
  }
}

size_t tc_smem_bytes(int M, int K, int bn) {
  return (static_cast<size_t>(M) * (K + kPad) + static_cast<size_t>(2) * K * (bn + kPad)) *
         sizeof(bf16);
}

template <int NT>
cudaError_t launch_tc(const bf16* a, const bf16* x, float* out, int M, int K, int width,
                      int wmax, int distinct, int ndots, int steps, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes(M, K, 8 * NT);
  auto kernel = tc_dot_kernel<NT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(steps), static_cast<unsigned>(ndots));
  kernel<<<grid, 2 * M, smem, stream>>>(a, x, out, M, K, width, distinct * wmax, wmax,
                                        distinct);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a [>= ndots, M, K] bf16, x [K, distinct * wmax] bf16, out [steps, M] float
// ZEROED by the caller.  M % 16 == 0 and M <= 128 (one warp per 16 rows),
// K % 16 == 0, width % 8 == 0, width <= wmax, wmax % 8 == 0, ndots <= 65535.
// Launches on `stream` without synchronising; returns the launch's
// cudaError_t (0 on success; cudaErrorInvalidValue for shapes it does not
// take).
int wrp_tc_dot_probe(const void* a, const void* x, void* out, int M, int K, int width, int wmax,
                     int distinct, int ndots, int steps, void* stream) {
  if (M <= 0 || M % 16 != 0 || M > 128 || K <= 0 || K % 16 != 0 || width <= 0 ||
      width % 8 != 0 || width > wmax || wmax % 8 != 0 || distinct <= 0 || ndots <= 0 ||
      ndots > 65535 || steps <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* ab = static_cast<const bf16*>(a);
  const auto* xb = static_cast<const bf16*>(x);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      width % 64 == 0
          ? launch_tc<8>(ab, xb, of, M, K, width, wmax, distinct, ndots, steps, st)
          : launch_tc<1>(ab, xb, of, M, K, width, wmax, distinct, ndots, steps, st);
  return static_cast<int>(err);
}

}  // extern "C"
