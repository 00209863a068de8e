// The A-stage of the pulse-sharded chain for rays of 1024 < m <= 16384
// range cells, for NVIDIA Hopper (sm_90a).
//
// Replaces, at those m, the TPU kernel wrp_tpu/ops/pallas/fullchain.py::
// fused_chain_astage (body _kernel_radix_astage).  Per channel-sector it
// maps this rank's pulse slab x [2, m, w] (int16 or f32, range rows in
// NATURAL order, any w) to the windowed half-spectrum range DFT
// Y [2, m/2, w] f32 through cluster_chain.cuh's body with kFused = false:
// each unit one cluster of S blocks (S = 8 up to m = 8192, 16 above it;
// the S = 16 kernels in fused_chain_astage_cluster16{,_p1,_p2,_p8}.cu), block
// b the m/S-point DFT of rows S t + b, the S/2-of-S combine over
// distributed shared memory, its m/2S rows of Y stored `cols` contiguous
// floats a row and plane.  The caller picks this entry from m alone
// (ops/fullchain.chain_route); m <= 1024 runs fused_chain_astage.cu, an m
// the cluster body refuses (16 x p above 8192, p a prime whose Bluestein
// length passes 1024; above 16384) fused_chain_astage_matrix.cu.
//
// What bounds it: bytes.  4 m w bytes of int16 in and 4 m w of Y out a
// unit; the FFT's ~5 m log2 m flops a column are ~10 per byte, under the
// fp32 ridge of 20.  Grid (S, 1, units), clusters of S.

#include <cuda_runtime.h>

#include "cluster_chain.cuh"

extern "C" {

// x [bc, 2, m, w] int16 or float, tab the plan's cluster_tables, y [bc, 2,
// m/2, w] float; cols the ClusterGeometry's at width w.  Launches on
// `stream` without synchronising; returns the launch's cudaError_t (0 on
// success; cudaErrorInvalidValue for an m or cols the body does not take).
// The caller validates shapes and dtypes.
int wrp_fused_chain_astage_cluster(const void* x, int x_is_int16, const void* tab, void* y,
                                   int bc, int m, int w, int cols, void* stream) {
  return static_cast<int>(wrp::cluster::launch<wrp::cluster::PlanarRows, false>(
      wrp::cluster::PlanarRows{x, x_is_int16, m, w}, static_cast<const float*>(tab), nullptr,
      nullptr, nullptr, static_cast<float*>(y), bc, 1, m, w, cols, 0.f,
      static_cast<cudaStream_t>(stream)));
}

// Resident blocks per SM and clusters of S the card holds at once of the
// cluster A-stage at (m, cols), f32 samples staged (the larger staging).
int wrp_fused_chain_astage_cluster_occupancy(int m, int cols, int* blocks_per_sm,
                                             int* clusters) {
  return static_cast<int>(wrp::cluster::occupancy<wrp::cluster::PlanarRows, false>(
      wrp::cluster::PlanarRows{nullptr, 0, m, 0}, m, cols, blocks_per_sm, clusters));
}

}  // extern "C"
