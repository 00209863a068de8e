// The in-kernel time breakdown of the fused radix chain, for NVIDIA Hopper
// (sm_90a): the production kernel with work removed.
//
// Replaces the TPU kernel tools/kernel_breakdown.py (`pl.pallas_call` at
// :158, body `kern` at :80-135): ablation variants of the benchmark's
// salted radix offset kernel, timed one against another to split its time
// among its parts.  The ablations are the production body itself
// (radix_chain.cuh `radix_chain_kernel` with Body::kDots or
// Body::kCombine), on the source the benchmark's default run reads
// (Salted<PlanarSource<int16_t>>), launched on the production grid with
// the production kernel's dynamic shared memory (136 KB at T = 8, n = 512),
// so every mode runs at the production occupancy:
//
//   dots     the contraction, each g_p added onto the register-held Y
//            rows of block p mod S (no combine), then the Y rows stored to
//            shared memory and a warp sum per row;
//   combine  the contraction and the combine, the same row store and sum;
//   full     the production kernel (fused_chain_radix_salted.cu, launched
//            by the wrapper; not here).
//
// combine - dots is the combine's cost, full - combine the Parseval
// epilogue's.  The TPU tool's `splits` mode (the bf16 hi/lo operand split)
// has no counterpart: this chain contracts in fp32 with no split.
//
// What bounds it: each mode reads the slab's int16 once (100.7 MB per 48
// channel-sectors, 0.030 ms at 3.35 TB/s); each does the production
// contraction's fp32 FMAs, so like the production kernel it is bound by FMA
// issue.  Every FMA feeds the output (the row sums), so nvcc removes none of
// them (the tool counts FFMA per instantiation in the SASS).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "radix_chain.cuh"

namespace {

using I16S = wrp::Salted<wrp::PlanarSource<int16_t>>;

constexpr int kDots = static_cast<int>(wrp::Body::kDots);
constexpr int kCombine = static_cast<int>(wrp::Body::kCombine);

}  // namespace

extern "C" {

// x [>= offset + bc, 2, m, n] int16, a [R, M, M, 2], fac [S, R, 2] float,
// out [bc, m/2] float; mode 2 = dots, 3 = combine (wrp::Body).  Launches on
// `stream` without synchronising; returns the launch's cudaError_t (0 on
// success).  The caller validates shapes, dtypes and the offset's range.
int wrp_radix_chain_ablation(const void* x, const void* a, const void* fac, void* out, int bc,
                             int m, int n, int radix, int tile, long long offset, int salt,
                             int mode, void* stream) {
  const auto* af = static_cast<const float*>(a);
  const auto* ff = static_cast<const float*>(fac);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const size_t skip = static_cast<size_t>(offset) * 2 * m * n;  // elements
  const I16S src{{static_cast<const int16_t*>(x) + skip, m, n}, static_cast<float>(salt)};
  cudaError_t err;
  switch (mode) {
    case kDots:
      err = wrp::launch_radix_chain<I16S, wrp::Body::kDots>(radix, tile, src, af, ff, nullptr,
                                                            nullptr, of, bc, 1, m, n, st);
      break;
    case kCombine:
      err = wrp::launch_radix_chain<I16S, wrp::Body::kCombine>(radix, tile, src, af, ff,
                                                               nullptr, nullptr, of, bc, 1, m,
                                                               n, st);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// Resident blocks per SM of the ablation `mode` at (radix, tile, m, n).
int wrp_radix_chain_ablation_blocks_per_sm(int mode, int radix, int tile, int m, int n,
                                           int* blocks) {
  cudaError_t err;
  switch (mode) {
    case kDots:
      err = wrp::radix_chain_blocks_per_sm<I16S, wrp::Body::kDots>(radix, tile, m, n, 0,
                                                                    blocks);
      break;
    case kCombine:
      err = wrp::radix_chain_blocks_per_sm<I16S, wrp::Body::kCombine>(radix, tile, m, n, 0,
                                                                       blocks);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // extern "C"
