// The cluster body's kernel at a cluster of 16 blocks (8192 < m <= 16384)
// for the wire fused chain (fused_chain_wire_cluster.cu's entries)
// at m = 16 x odd (P = 1: 8208 = 16 x 513, 16368 = 16 x 1023), block b's
// m/16-point DFT of the rows 16 t + b the odd leaf alone, then the 8-of-16
// combine, for NVIDIA Hopper (sm_90a): one part of cluster_chain.cuh's
// kernels (its design, bound and the TPU kernels it replaces are described
// there), in a file of its own so that nvcc builds it in parallel with the
// others.

#include "cluster_chain.cuh"

namespace wrp {
namespace cluster {

WRP_CLUSTER_PART(template, Part::kP1S16, fft::WireIq, true)

}  // namespace cluster
}  // namespace wrp
