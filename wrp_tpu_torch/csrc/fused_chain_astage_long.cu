// The A-stage's long-ray kernels, for NVIDIA Hopper (sm_90a).
//
// The instantiations of fft_chain.cuh's long-ray body without the
// epilogue (1024 < m <= 4096: P = 2048, 4096 in three register passes,
// Y stored from their slots; the design and bound are described there and
// in fused_chain_astage.cu), behind wrp_fused_chain_astage, which reaches
// them through fft::launch_astage for m > 1024.  They replace, at those m,
// the TPU kernel wrp_tpu/ops/pallas/fullchain.py::fused_chain_astage
// (_kernel_radix_astage).  A file of their own so that nvcc compiles them
// in parallel with the m <= 1024 kernels.

#include <cuda_runtime.h>

#include "fft_chain.cuh"

namespace wrp {
namespace fft {

cudaError_t launch_astage_long(const PlanarIq& src, const float* tab, float* y, int units,
                               int m, int w, int cols, int blocks, cudaStream_t stream) {
  return launch_astage_as<true>(src, tab, y, units, m, w, cols, blocks, stream);
}

cudaError_t occupancy_astage_long(const PlanarIq& src, int m, int cols, int blocks,
                                  int* blocks_per_sm, int* clusters) {
  return occupancy_as<true, PlanarIq, false>(src, m, cols, blocks, blocks_per_sm, clusters);
}

}  // namespace fft
}  // namespace wrp
