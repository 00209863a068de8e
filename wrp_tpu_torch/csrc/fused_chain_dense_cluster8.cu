// The cluster body's kernel for the dense entries' radix-1 m = 8 x odd
// (m <= 8192: 1832 = 8 x 229), for NVIDIA Hopper (sm_90a): a cluster of 8
// blocks a unit, each block's m/8-point sub-DFT the odd leaf alone (P =
// 1).  It replaces, at those m, the TPU kernels
// wrp_tpu/ops/pallas/fullchain.py::fused_chain_power (_kernel) and
// fused_chain_power_at (_kernel_offset); the dense entries launch it through
// fused_chain_radix_cluster.cu's entry, unsalted (ops/fullchain.chain_route
// picks the route from m).  One part of cluster_chain.cuh's kernels (its
// design and bound are described there), in a file of its own so that
// nvcc builds it in parallel with the others.

#include "cluster_chain.cuh"

namespace wrp {
namespace cluster {

WRP_CLUSTER_PART(template, Part::kS8, PlanarDirect, true)

}  // namespace cluster
}  // namespace wrp
