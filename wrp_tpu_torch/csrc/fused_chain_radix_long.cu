// The dense entries' long-ray kernels, for NVIDIA Hopper (sm_90a).
//
// The instantiations of fft_chain.cuh's long-ray body (1024 < m <= 4096,
// radix-1 m, so P = 2, 4 or 8 and an odd leaf: every row's epilogue
// partials in shared memory; the design and bound are described there)
// behind the dense entries' FFT body (fused_chain_dense.cu's entries reach
// them through fused_chain_radix.cu's wrp_fused_chain_radix and
// fft::launch_fused for m > 1024).  They replace, at those m, the TPU
// kernels wrp_tpu/ops/pallas/fullchain.py::fused_chain_power (_kernel:
// radix-1 m such as 1832 = 8 x 229) and fused_chain_power_at.  The radix
// entries' m above 1024 run cluster_chain.cuh
// (fused_chain_radix_cluster.cu).  A file of their own so that nvcc
// compiles them in parallel with the m <= 1024 kernels.

#include <cuda_runtime.h>

#include "fft_chain.cuh"

namespace wrp {
namespace fft {

cudaError_t launch_fused_long(const PlanarIq& src, const float* tab, const float* phi,
                              const float* wd, const float* ph, float* out, int sectors,
                              int channels, int m, int n, int cols, int blocks, float salt,
                              cudaStream_t stream) {
  return launch_fused_as<true>(src, tab, phi, wd, ph, out, sectors, channels, m, n, cols,
                               blocks, salt, stream);
}

cudaError_t occupancy_long(const PlanarIq& src, int m, int cols, int blocks, int* blocks_per_sm,
                           int* clusters) {
  return occupancy_as<true, PlanarIq, true>(src, m, cols, blocks, blocks_per_sm, clusters);
}

}  // namespace fft
}  // namespace wrp
