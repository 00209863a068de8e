// The in-kernel time breakdown of the TPU algorithm's fused radix chain,
// for NVIDIA Hopper (sm_90a): the matrix-form body with work removed.
//
// Replaces the TPU kernel tools/kernel_breakdown.py (`pl.pallas_call` at
// :158, body `kern` at :80-135): ablation variants of the benchmark's
// salted radix offset kernel, timed one against another to split its time
// among its parts.  The production chain now runs in FFT form
// (fft_chain.cuh); the breakdown keeps ablating ONE body, the TPU
// algorithm's matrix form (radix_chain.cuh `radix_chain_kernel`), every
// mode an instantiation of it in this file, on the source the benchmark's
// default run reads (Salted<PlanarSource<int16_t>>), launched on its grid
// with its dynamic shared memory (136 KB at T = 8, n = 512), so at its
// occupancy:
//
//   dots     the contraction, each g_p added onto the register-held Y
//            rows of block p mod S (no combine), then the Y rows stored to
//            shared memory and a warp sum per row (Body::kDots);
//   combine  the contraction and the combine, the same row store and sum
//            (Body::kCombine);
//   full     the whole matrix-form chain with its Parseval epilogue
//            (Body::kFused): the port's first production kernel.
//
// combine - dots is the combine's cost, full - combine the Parseval
// epilogue's.  Beside them, the matrix-form A-stage (Body::kAStage,
// unsalted PlanarSource<int16_t>), at its own shared memory and at the
// full body's (min_smem): whether shared memory sets the full body's pace.
// The TPU tool's `splits` mode (the bf16 hi/lo operand split) has no
// counterpart: this chain contracts in fp32 with no split.
//
// What bounds it: each mode reads the slab's int16 once (100.7 MB per 48
// channel-sectors, 0.030 ms at 3.35 TB/s); each does the matrix form's
// fp32 FMAs, so it is bound by FMA issue.  Every FMA feeds the output (the
// row sums), so nvcc removes none of them (the tool counts FFMA per
// instantiation in the SASS).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "radix_chain.cuh"

namespace {

using I16S = wrp::Salted<wrp::PlanarSource<int16_t>>;
using I16 = wrp::PlanarSource<int16_t>;

constexpr int kFused = static_cast<int>(wrp::Body::kFused);
constexpr int kAStage = static_cast<int>(wrp::Body::kAStage);
constexpr int kDots = static_cast<int>(wrp::Body::kDots);
constexpr int kCombine = static_cast<int>(wrp::Body::kCombine);

}  // namespace

extern "C" {

// x [>= offset + bc, 2, m, n] int16, a [R, M, M, 2], fac [S, R, 2], wd [n],
// ph [4, n] float (read by full only), out [bc, m/2] float; mode 0 = full,
// 2 = dots, 3 = combine (wrp::Body).  Launches on `stream` without
// synchronising; returns the launch's cudaError_t (0 on success).  The
// caller validates shapes, dtypes and the offset's range.
int wrp_radix_chain_ablation(const void* x, const void* a, const void* fac, const void* wd,
                             const void* ph, void* out, int bc, int m, int n, int radix,
                             int tile, long long offset, int salt, int mode, void* stream) {
  const auto* af = static_cast<const float*>(a);
  const auto* ff = static_cast<const float*>(fac);
  const auto* wf = static_cast<const float*>(wd);
  const auto* pf = static_cast<const float*>(ph);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const size_t skip = static_cast<size_t>(offset) * 2 * m * n;  // elements
  const I16S src{{static_cast<const int16_t*>(x) + skip, m, n}, static_cast<float>(salt)};
  switch (mode) {
    case kFused:
      return static_cast<int>(wrp::launch_radix_chain<I16S, wrp::Body::kFused>(
          radix, tile, src, af, ff, wf, pf, of, bc, 1, m, n, st));
    case kDots:
      return static_cast<int>(wrp::launch_radix_chain<I16S, wrp::Body::kDots>(
          radix, tile, src, af, ff, nullptr, nullptr, of, bc, 1, m, n, st));
    case kCombine:
      return static_cast<int>(wrp::launch_radix_chain<I16S, wrp::Body::kCombine>(
          radix, tile, src, af, ff, nullptr, nullptr, of, bc, 1, m, n, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The matrix-form A-stage on x [bc, 2, m, w] int16 -> y [bc, 2, m/2, w]
// float, with at least min_smem bytes of dynamic shared memory requested
// per block (the kernel uses only its 8 KB operator slice).
int wrp_radix_chain_astage(const void* x, const void* a, const void* fac, void* y, int bc,
                           int m, int w, int radix, int tile, long long min_smem,
                           void* stream) {
  return static_cast<int>(wrp::launch_radix_astage(
      radix, tile, I16{static_cast<const int16_t*>(x), m, w}, static_cast<const float*>(a),
      static_cast<const float*>(fac), static_cast<float*>(y), bc, m, w,
      static_cast<cudaStream_t>(stream), static_cast<size_t>(min_smem)));
}

// Resident blocks per SM of the body `mode` (0 full, 1 A-stage, 2 dots, 3
// combine) at (radix, tile, m, n), at its dynamic shared memory or
// min_smem bytes, whichever is more.
int wrp_radix_chain_ablation_blocks_per_sm(int mode, int radix, int tile, int m, int n,
                                           long long min_smem, int* blocks) {
  const auto ms = static_cast<size_t>(min_smem);
  switch (mode) {
    case kFused:
      return static_cast<int>(wrp::radix_chain_blocks_per_sm<I16S, wrp::Body::kFused>(
          radix, tile, m, n, ms, blocks));
    case kAStage:
      return static_cast<int>(wrp::radix_chain_blocks_per_sm<I16, wrp::Body::kAStage>(
          radix, tile, m, n, ms, blocks));
    case kDots:
      return static_cast<int>(wrp::radix_chain_blocks_per_sm<I16S, wrp::Body::kDots>(
          radix, tile, m, n, ms, blocks));
    case kCombine:
      return static_cast<int>(wrp::radix_chain_blocks_per_sm<I16S, wrp::Body::kCombine>(
          radix, tile, m, n, ms, blocks));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
