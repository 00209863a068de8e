// The cluster body's kernels for the dense entries' radix-1 m = S x odd
// with S = 2, 4 (m <= 1024 S: 1836 = 4 x 459, 2002 = 2 x 1001), for NVIDIA
// Hopper (sm_90a): a cluster of S blocks a unit, each block's m/S-point
// sub-DFT the odd leaf alone (P = 1).  They replace, at those m, the TPU
// kernels wrp_tpu/ops/pallas/fullchain.py::fused_chain_power (_kernel) and
// fused_chain_power_at (_kernel_offset); the dense entries launch them
// through fused_chain_radix_cluster.cu's entry, unsalted
// (ops/fullchain.chain_route picks the route from m).  One part of cluster_chain.cuh's kernels (its
// design and bound are described there), in a file of its own so that
// nvcc builds it in parallel with the others.

#include "cluster_chain.cuh"

namespace wrp {
namespace cluster {

WRP_CLUSTER_PART(template, Part::kS24, PlanarDirect, true)

}  // namespace cluster
}  // namespace wrp
