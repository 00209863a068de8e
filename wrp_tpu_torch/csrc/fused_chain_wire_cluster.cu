// The wire fused chain for rays of 1024 < m <= 16384 range cells, and its
// offset/salt entry, for NVIDIA Hopper (sm_90a).
//
// Replaces, at those m, the TPU kernels wrp_tpu/ops/pallas/fullchain.py::
// fused_chain_power_wire (body _kernel_radix_wire) and, with offset and
// salt, its _kernel_radix_wire_offset.  Per sector it maps the wire words
// w [m, ch n] (int32, rows in NATURAL order; word ch j + c of a row is
// channel c, pulse j) to pow [ch, m/2] through cluster_chain.cuh's body
// with kFused = true: one cluster of S blocks a channel (S = 8 up to m =
// 8192, 16 above it; the S = 16 kernels in
// fused_chain_wire_cluster16{,_p1,_p2,_p8}.cu), block b reading its
// channel's words of rows S t + b at stride ch straight from device memory
// and decoding them in registers (chain_common.cuh decode_word), the
// m/S-point DFT, the S/2-of-S combine over distributed shared memory, and
// the Parseval epilogue of the block's m/2S rows, held in registers across
// every round.  A sector's channels, which read the same 32-byte sectors of
// each row, are adjacent clusters.  Every channel shares the planar window
// and phasors (wd [n], ph [4, n]).  The caller picks this entry from m
// alone (ops/fullchain.chain_route): m <= 1024 runs fused_chain_wire.cu,
// an m the cluster body refuses (16 x p above 8192, p a prime whose
// Bluestein length passes 1024; above 16384) fused_chain_dense.cu's wire
// source.
//
// `offset` (sectors) starts the launch `offset` sectors into a larger
// staged array (pointer arithmetic, no copy); the int32 `salt` is added to
// every decoded sample after its conversion to f32 (0: none, exactly).
//
// What bounds it: bytes, 4 m n of words in a unit and 2 m of power out.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "cluster_chain.cuh"

extern "C" {

// w [>= offset + bs, m, ch n] int32, tab the plan's cluster_tables, phi its
// round phasor sums at the cluster geometry's cols, wd [n], ph [4, n]
// float, out [bs, ch, m/2] float.  Launches on `stream` without
// synchronising; returns the launch's cudaError_t (0 on success).  The
// caller validates shapes, dtypes and the offset's range.
int wrp_fused_chain_wire_cluster(const void* w, const void* tab, const void* phi, const void* wd,
                                 const void* ph, void* out, int bs, int m, int n, int ch,
                                 int cols, long long offset, int salt, void* stream) {
  const size_t skip = static_cast<size_t>(offset) * m * ch * n;  // words
  return static_cast<int>(wrp::cluster::launch<wrp::fft::WireIq, true>(
      wrp::fft::WireIq{static_cast<const int32_t*>(w) + skip, m, n, ch},
      static_cast<const float*>(tab), static_cast<const float*>(phi),
      static_cast<const float*>(wd), static_cast<const float*>(ph), static_cast<float*>(out), bs,
      ch, m, n, cols, static_cast<float>(salt), static_cast<cudaStream_t>(stream)));
}

// Resident blocks per SM and clusters of S the card holds at once of the
// cluster wire chain at (m, cols).
int wrp_fused_chain_wire_cluster_occupancy(int m, int cols, int* blocks_per_sm, int* clusters) {
  return static_cast<int>(wrp::cluster::occupancy<wrp::fft::WireIq, true>(
      wrp::fft::WireIq{nullptr, m, 0, 1}, m, cols, blocks_per_sm, clusters));
}

}  // extern "C"
