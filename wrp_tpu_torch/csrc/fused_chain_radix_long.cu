// The dense entries' long-ray kernel, for NVIDIA Hopper (sm_90a).
//
// The instantiation of fft_chain.cuh's long-ray body (the dense entries'
// m = 2 x odd in (2048, 4096], so P = 2 and an odd leaf of 1025-2047
// points: every row's epilogue partials in shared memory; the design and
// bound are described there) behind the dense entries' FFT body
// (fused_chain_dense.cu's entries reach it through fused_chain_radix.cu's
// wrp_fused_chain_radix and fft::launch_fused for m > 1024).  It replaces,
// at those m, the TPU kernels wrp_tpu/ops/pallas/fullchain.py::
// fused_chain_power (_kernel: m = 4094 = 2 x 23 x 89) and
// fused_chain_power_at.  Every other radix-1 m above 1024 that the cluster
// body splits (m = S x odd, m <= 1024 S) runs cluster_chain.cuh
// (fused_chain_radix_cluster.cu).  A file of its own so that nvcc compiles
// it in parallel with the m <= 1024 kernels.

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
