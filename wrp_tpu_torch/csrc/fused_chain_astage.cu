// The A-stage of the pulse-sharded chain, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel wrp_tpu/ops/pallas/fullchain.py::
// fused_chain_astage (body _kernel_radix_astage).  Per channel-sector it
// maps this rank's pulse slab x [2, m, w] (int16 or f32, range rows in
// NATURAL order, any w) to the windowed half-spectrum range DFT
// Y [2, m/2, w] f32: the FFT stage of the fused kernel (fft_chain.cuh
// `fft_chain_kernel` with kFused = false: the same body, not a copy), with
// the epilogue replaced by a coalesced store of Y, a round's columns at a
// time.  The epilogue needs every pulse of a range row, so it runs after
// the all_to_all that re-shards Y from pulse slices to row slices
// (parseval_rows.cu).
//
// What bounds it: bytes.  It reads 4 m w bytes of int16 and writes 4 m w
// bytes of Y per unit (the FFT's ~5 m log2 m flops per column are ~10 per
// byte, under the fp32 ridge of 20).  Blocks are independent (no cluster):
// grid (blocks, 1, units).

#include <cuda_runtime.h>

#include <cstdint>

#include "fft_chain.cuh"

extern "C" {

// x [bc, 2, m, w] int16 or float, tab the plan's fft_tables, y [bc, 2,
// m/2, w] float; cols and blocks the FftGeometry at width w.  Launches
// on `stream` without synchronising; returns the launch's cudaError_t (0
// on success).  The caller validates shapes and dtypes.
int wrp_fused_chain_astage(const void* x, int x_is_int16, const void* tab, void* y, int bc,
                           int m, int w, int cols, int blocks, void* stream) {
  return static_cast<int>(wrp::fft::launch_astage(
      wrp::fft::PlanarIq{x, x_is_int16, m, w}, static_cast<const float*>(tab),
      static_cast<float*>(y), bc, m, w, cols, blocks, static_cast<cudaStream_t>(stream)));
}

// Resident blocks per SM of the A-stage at (m, cols).
int wrp_fused_chain_astage_occupancy(int m, int cols, int* blocks_per_sm) {
  int clusters = 0;
  return static_cast<int>(wrp::fft::occupancy<wrp::fft::PlanarIq, false>(
      wrp::fft::PlanarIq{nullptr, 1, m, 0}, m, cols, 1, blocks_per_sm, &clusters));
}

}  // extern "C"
