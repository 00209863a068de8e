// The A-stage of the pulse-sharded chain, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel wrp_tpu/ops/pallas/fullchain.py::
// fused_chain_astage (body _kernel_radix_astage).  Per channel-sector it
// maps this rank's pulse slab x [2, m, w] (int16 or f32, range rows in
// NATURAL order, w = n / ranks pulse lanes) to the windowed half-spectrum
// range DFT Y [2, m/2, w] f32: the fused radix kernel's contraction and
// combine (radix_chain.cuh `radix_chain_kernel` with kAStage = true: the
// same body, not a copy), with the Parseval epilogue replaced by a store
// of Y.  The epilogue needs every pulse of a range row, so it runs after
// the all_to_all that re-shards Y from pulse slices to row slices
// (parseval_rows.cu).
//
// What bounds it: the contraction's 8 m (m / R) w flops per unit against
// 4 m w bytes of int16 in and 4 m w bytes of Y out; ~128 flops per byte,
// above the H100's fp32 ridge (20), so fp32 FMA issue bounds it, as it
// bounds the fused kernel.  Without Y in shared memory a block holds only
// its operator slice (8 KB at T = 8), so blocks per SM are set by
// registers; each thread's Y[S][T] goes straight to global memory, one
// coalesced row segment per (s, t).

#include <cuda_runtime.h>

#include <cstdint>

#include "radix_chain.cuh"

extern "C" {

// x [bc, 2, m, w] int16 or float, a [R, M, M, 2], fac [S, R, 2] float,
// y [bc, 2, m/2, w] float.  Launches on `stream` without synchronising;
// returns the launch's cudaError_t (0 on success).  The caller validates
// shapes and dtypes.
int wrp_fused_chain_astage(const void* x, int x_is_int16, const void* a, const void* fac,
                           void* y, int bc, int m, int w, int radix, int tile, void* stream) {
  const auto* af = static_cast<const float*>(a);
  const auto* ff = static_cast<const float*>(fac);
  auto* yf = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_is_int16
          ? wrp::launch_radix_astage(radix, tile,
                                     wrp::PlanarSource<int16_t>{
                                         static_cast<const int16_t*>(x), m, w},
                                     af, ff, yf, bc, m, w, st)
          : wrp::launch_radix_astage(radix, tile,
                                     wrp::PlanarSource<float>{static_cast<const float*>(x), m, w},
                                     af, ff, yf, bc, m, w, st);
  return static_cast<int>(err);
}

// The int16 A-stage above with at least min_smem bytes of dynamic shared
// memory requested per block (the kernel uses only its operator slice):
// the in-kernel time breakdown runs it at the fused kernel's 136 KB, so
// at the fused kernel's one block per SM.
int wrp_fused_chain_astage_min_smem(const void* x, const void* a, const void* fac, void* y,
                                    int bc, int m, int w, int radix, int tile,
                                    long long min_smem, void* stream) {
  const cudaError_t err = wrp::launch_radix_astage(
      radix, tile, wrp::PlanarSource<int16_t>{static_cast<const int16_t*>(x), m, w},
      static_cast<const float*>(a), static_cast<const float*>(fac), static_cast<float*>(y), bc,
      m, w, static_cast<cudaStream_t>(stream), static_cast<size_t>(min_smem));
  return static_cast<int>(err);
}

// Resident blocks per SM of the int16 A-stage at (radix, tile, m, w) with
// at least min_smem bytes of dynamic shared memory, for the breakdown.
int wrp_fused_chain_astage_blocks_per_sm(int radix, int tile, int m, int w,
                                         long long min_smem, int* blocks) {
  return static_cast<int>(
      wrp::radix_chain_blocks_per_sm<wrp::PlanarSource<int16_t>, wrp::Body::kAStage>(
          radix, tile, m, w, static_cast<size_t>(min_smem), blocks));
}

}  // extern "C"
