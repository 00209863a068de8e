// The A-stage of the pulse-sharded chain above 8192 range cells, for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel wrp_tpu/ops/pallas/fullchain.py::
// fused_chain_astage (body _kernel_radix_astage) where the FFT forms do not
// reach: every m that splits into radix branches (ops/fullchain.radix_for(m)
// > 1) above CLUSTER_MAX_M = 8192, e.g. m = 8320 (radix 8).  m <= 1024 runs
// fused_chain_astage.cu, 1024 < m <= 8192 fused_chain_astage_cluster.cu.
// The caller picks the entry from m alone (ops/fullchain.chain_route).
//
// Per channel-sector it maps this rank's pulse slab x [2, m, w] (int16 or
// f32, range rows in NATURAL order, any w) to the windowed half-spectrum
// range DFT Y [2, m/2, w] f32 through radix_chain.cuh's matrix-form body,
// the TPU kernel's own algorithm: the R branch contractions
// g_p = A_p x[p::R] with the window and twiddles folded into A_p, then the
// combine Y[s M + t] = sum_p fac[s][p] g_p[t] (M = m / R).  The same body
// runs in the in-kernel time breakdown (kernel_breakdown.cu's
// wrp_radix_chain_astage, int16 only); this entry adds the f32 source,
// which pallas-seq hands the A-stage for complex host input.
//
// What bounds it: fp32 FMA issue.  4 m M w real FMAs per unit (17.7 G at
// m = 8320, M = 1040, w = 512) against 4 m w bytes of int16 in and 4 m w of
// Y out: ~530 FMAs per byte, far above the fp32 ridge of ~20 flops per
// byte.  A correct kernel, kept for the m the cluster body does not take.
//
// The tile T (sub-DFT rows per block) comes from the caller
// (ops/fullchain.astage_tile): the tallest of 8, 4, 2 that divides M and
// whose operator slice [M][T][2] f32 fits one block's shared memory.

#include <cuda_runtime.h>

#include <cstdint>

#include "radix_chain.cuh"

extern "C" {

// x [bc, 2, m, w] int16 or float, a the plan's a_kernel [R, M(q), M(t), 2]
// float, fac its fac_t [R/2, R, 2] float, y [bc, 2, m/2, w] float.
// Launches on `stream` without synchronising; returns the launch's
// cudaError_t (0 on success; cudaErrorInvalidValue for a radix, tile or
// shape it does not take).  The caller validates dtypes and the tile's
// shared memory.
int wrp_fused_chain_astage_matrix(const void* x, int x_is_int16, const void* a, const void* fac,
                                  void* y, int bc, int m, int w, int radix, int tile,
                                  void* stream) {
  const auto* af = static_cast<const float*>(a);
  const auto* ff = static_cast<const float*>(fac);
  auto* yf = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_is_int16
          ? wrp::launch_radix_astage(
                radix, tile, wrp::PlanarSource<int16_t>{static_cast<const int16_t*>(x), m, w},
                af, ff, yf, bc, m, w, st)
          : wrp::launch_radix_astage(
                radix, tile, wrp::PlanarSource<float>{static_cast<const float*>(x), m, w}, af,
                ff, yf, bc, m, w, st);
  return static_cast<int>(err);
}

}  // extern "C"
