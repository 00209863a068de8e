// The cluster body's kernels at a cluster of 16 blocks (8192 < m <= 16384)
// for the wire fused chain (fused_chain_wire_cluster.cu's entries)
// at an odd leaf with P = 8, 16 (m = 16 P L: 8320 = 16 x 8 x 65),
// for NVIDIA Hopper (sm_90a): one part of cluster_chain.cuh's kernels (its
// design, bound and the TPU kernels it replaces are described there), in a
// file of its own so that nvcc builds it in parallel with the others.

#include "cluster_chain.cuh"

namespace wrp {
namespace cluster {

WRP_CLUSTER_PART(template, Part::kP8S16, fft::WireIq, true)

}  // namespace cluster
}  // namespace wrp
