// The cluster body's kernels at a cluster of 16 blocks (8192 < m <= 16384)
// for the wire fused chain (fused_chain_wire_cluster.cu's entries)
// at an odd leaf with P = 2, 4 (m = 16 P L: 8224 = 16 x 2 x 257),
// for NVIDIA Hopper (sm_90a): one part of cluster_chain.cuh's kernels (its
// design, bound and the TPU kernels it replaces are described there), in a
// file of its own so that nvcc builds it in parallel with the others.

#include "cluster_chain.cuh"

namespace wrp {
namespace cluster {

WRP_CLUSTER_PART(template, Part::kP2S16, fft::WireIq, true)

}  // namespace cluster
}  // namespace wrp
