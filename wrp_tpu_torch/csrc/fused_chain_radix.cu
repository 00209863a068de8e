// Fused radar chain on planar IQ, stages 01-08, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel wrp_tpu/ops/pallas/fullchain.py::
// fused_chain_power_radix (body _kernel_radix).  Per channel-sector it maps
// planar IQ x [2, m, n] (int16 or f32, range rows in NATURAL order) to the
// matched-filter power pow [m/2] through the FFT-form kernel of
// fft_chain.cuh (its math, bound and design are described there), with
// the planar load policy: element (row, pulse j) at x[row n + j], int16 or
// f32 by a uniform runtime switch.  Each channel-sector is a unit: one
// thread-block cluster of `blocks` blocks (grid (blocks, 1,
// bc)).
//
// `offset` (channel-sectors) starts the launch `offset` units into a larger
// staged array: the benchmark's unsalted offset entry (the TPU's scalar-
// prefetch index map, _kernel_radix_offset), applied here as pointer
// arithmetic, so the kernel body is the plain entry's.  The salted entry
// (fused_chain_radix_salted.cu) launches the same instantiation with its
// salt; this one passes salt 0, which adds nothing.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "fft_chain.cuh"

namespace wrp {

// The planar fused chain with `salt` added to every sample (0: none); the
// C entries of this file and fused_chain_radix_salted.cu.
cudaError_t fused_chain_planar(const void* x, int x_is_int16, const void* tab, const void* phi,
                               const void* wd, const void* ph, void* out, int bc, int m, int n,
                               int cols, int blocks, long long offset, float salt,
                               void* stream) {
  const size_t skip = static_cast<size_t>(offset) * 2 * m * n;  // elements
  const void* base = x_is_int16
                         ? static_cast<const void*>(static_cast<const int16_t*>(x) + skip)
                         : static_cast<const void*>(static_cast<const float*>(x) + skip);
  return fft::launch_fused(fft::PlanarIq{base, x_is_int16, m, n},
                           static_cast<const float*>(tab), static_cast<const float*>(phi),
                           static_cast<const float*>(wd), static_cast<const float*>(ph),
                           static_cast<float*>(out), bc, 1, m, n, cols, blocks, salt,
                           static_cast<cudaStream_t>(stream));
}

}  // namespace wrp

extern "C" {

// x [>= offset + bc, 2, m, n] int16 or float, tab the plan's fft_tables,
// phi [ceil(n / cols), 4] its round phasor sums, wd [n], ph [4, n] float,
// out [bc, m/2] float; cols and blocks the plan's FftGeometry.
// Launches on `stream` without synchronising; returns the launch's
// cudaError_t (0 on success).  The caller validates shapes, dtypes and the
// offset's range.
int wrp_fused_chain_radix(const void* x, int x_is_int16, const void* tab, const void* phi,
                          const void* wd, const void* ph, void* out, int bc, int m, int n,
                          int cols, int blocks, long long offset, void* stream) {
  return static_cast<int>(wrp::fused_chain_planar(x, x_is_int16, tab, phi, wd, ph, out, bc, m,
                                                  n, cols, blocks, offset, 0.f, stream));
}

// Resident blocks per SM and clusters of `blocks` blocks the card holds at
// once (cudaOccupancyMaxActiveClusters) of the planar fused kernel at
// (m, cols).
int wrp_fused_chain_radix_occupancy(int m, int cols, int blocks, int* blocks_per_sm,
                                    int* clusters) {
  return static_cast<int>(
      wrp::fft::occupancy<wrp::fft::PlanarIq, true>(wrp::fft::PlanarIq{nullptr, 1, m, 0}, m, cols,
                                                    blocks, blocks_per_sm, clusters));
}

const char* wrp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
