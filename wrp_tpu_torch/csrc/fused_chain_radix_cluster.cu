// The planar fused chain for rays of 1024 < m <= 16384 range cells, and its
// offset/salt entry, for NVIDIA Hopper (sm_90a).
//
// Replaces, at those m, the TPU kernels wrp_tpu/ops/pallas/fullchain.py::
// fused_chain_power_radix (body _kernel_radix) and, with offset and salt,
// its _kernel_radix_offset; unsalted, at the radix-1 m = S x odd (S = 2, 4,
// 8, m <= 1024 S) also fused_chain_power (_kernel) and fused_chain_power_at
// (_kernel_offset), the dense entries'.  Per channel-sector it maps planar
// IQ x [2, m, n] (int16 or f32 by a uniform runtime switch, range rows in
// NATURAL order) to pow [m/2] through cluster_chain.cuh's body with
// kFused = true: one cluster of S blocks a channel-sector (S = 8 for a
// radix m up to 8192, 16 above it), block b reading rows S t + b of both planes straight from
// device memory in pass 1 (PlanarDirect: a warp's loads are adjacent
// columns of a row), the m/S-point DFT, the S/2-of-S combine over
// distributed shared memory, and the Parseval epilogue of the block's
// m/2S rows, held in registers across every round.  Without
// a staging buffer a round takes the wire chain's columns (64 at m = 2048,
// 32 at 4096, 16 at 8192), so the two chains share the plan's round
// phasor sums.  The caller picks this entry from m alone
// (ops/fullchain.chain_route): m <= 1024 runs fused_chain_radix.cu, an m
// the cluster body refuses (16 x p above 8192, p a prime whose Bluestein
// length passes 1024; above 16384) fused_chain_dense.cu's matrix kernel.
// The kernels of S = 16 are in fused_chain_radix_cluster16{,_p1,_p2,_p8}.cu.
//
// `offset` (channel-sectors) starts the launch `offset` units into a larger
// staged array (pointer arithmetic, no copy); the int32 `salt` is added to
// every sample after its conversion to f32, before the window (0: none,
// exactly).
//
// What bounds it: bytes, 4 m n of int16 (8 m n of f32) in a unit and 2 m
// of power out.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "cluster_chain.cuh"

extern "C" {

// x [>= offset + bc, 2, m, n] int16 or float, tab the plan's
// cluster_tables, phi its round phasor sums at the cluster geometry's cols,
// wd [n], ph [4, n] float, out [bc, m/2] float.  Launches on `stream`
// without synchronising; returns the launch's cudaError_t (0 on success;
// cudaErrorInvalidValue for an m, cols or bc the body does not take).  The
// caller validates shapes, dtypes and the offset's range.
int wrp_fused_chain_radix_cluster(const void* x, int x_is_int16, const void* tab,
                                  const void* phi, const void* wd, const void* ph, void* out,
                                  int bc, int m, int n, int cols, long long offset, int salt,
                                  void* stream) {
  const size_t skip = static_cast<size_t>(offset) * 2 * m * n;  // elements
  const void* base = x_is_int16
                         ? static_cast<const void*>(static_cast<const int16_t*>(x) + skip)
                         : static_cast<const void*>(static_cast<const float*>(x) + skip);
  return static_cast<int>(wrp::cluster::launch<wrp::cluster::PlanarDirect, true>(
      wrp::cluster::PlanarDirect{base, x_is_int16, m, n}, static_cast<const float*>(tab),
      static_cast<const float*>(phi), static_cast<const float*>(wd),
      static_cast<const float*>(ph), static_cast<float*>(out), bc, 1, m, n, cols,
      static_cast<float>(salt), static_cast<cudaStream_t>(stream)));
}

// Resident blocks per SM and clusters of S (8, or 16 above m = 8192) the
// card holds at once of the cluster planar chain at (m, cols).
int wrp_fused_chain_radix_cluster_occupancy(int m, int cols, int* blocks_per_sm,
                                            int* clusters) {
  return static_cast<int>(wrp::cluster::occupancy<wrp::cluster::PlanarDirect, true>(
      wrp::cluster::PlanarDirect{nullptr, 1, m, 0}, m, cols, blocks_per_sm, clusters));
}

}  // extern "C"
