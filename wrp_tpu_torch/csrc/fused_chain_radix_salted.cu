// The benchmark's salted radix chain on planar IQ, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel wrp_tpu/ops/pallas/fullchain.py::
// fused_chain_power_radix with offset and salt (body _kernel_radix_offset):
// the radix-R kernel of radix_chain.cuh on `bc` channel-sectors starting
// `offset` channel-sectors into a larger staged array x, with the int32
// `salt` added to every I and Q sample after its conversion to f32.  The
// salt makes every benchmark step a different function of the staged input
// (bench.py's elision-proof loop); the chain's mean subtraction removes it
// up to the pulse window's inexact cancellation.
//
// What bounds it, and the design: those of fused_chain_radix.cu, whose
// kernel body this is, with the Salted<PlanarSource> load policy (one f32
// add per loaded sample, in registers).  The offset is pointer arithmetic
// in this launcher, as the TPU applied it in its scalar-prefetch index map.
// The policy is its own instantiation in its own source, so the unsalted
// kernels compile exactly as before and this file builds beside them.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "radix_chain.cuh"

extern "C" {

// x [>= offset + bc, 2, m, n] int16 or float, a [R, M, M, 2], fac [S, R, 2],
// wd [n], ph [4, n] float, out [bc, m/2] float.  Launches on `stream`
// without synchronising; returns the launch's cudaError_t (0 on success).
// The caller validates shapes, dtypes and the offset's range.
int wrp_fused_chain_radix_salted(const void* x, int x_is_int16, const void* a,
                                 const void* fac, const void* wd, const void* ph, void* out,
                                 int bc, int m, int n, int radix, int tile, long long offset,
                                 int salt, void* stream) {
  const auto* af = static_cast<const float*>(a);
  const auto* ff = static_cast<const float*>(fac);
  const auto* wf = static_cast<const float*>(wd);
  const auto* pf = static_cast<const float*>(ph);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const size_t skip = static_cast<size_t>(offset) * 2 * m * n;  // elements
  const float s = static_cast<float>(salt);
  using I16 = wrp::Salted<wrp::PlanarSource<int16_t>>;
  using F32 = wrp::Salted<wrp::PlanarSource<float>>;
  const cudaError_t err =
      x_is_int16
          ? wrp::launch_radix_chain(radix, tile,
                                    I16{{static_cast<const int16_t*>(x) + skip, m, n}, s}, af,
                                    ff, wf, pf, of, bc, 1, m, n, st)
          : wrp::launch_radix_chain(radix, tile,
                                    F32{{static_cast<const float*>(x) + skip, m, n}, s}, af,
                                    ff, wf, pf, of, bc, 1, m, n, st);
  return static_cast<int>(err);
}

// Resident blocks per SM of the int16 salted kernel at (radix, tile, m, n),
// for the in-kernel time breakdown (kernel_breakdown.cu's `full` mode).
int wrp_fused_chain_radix_salted_blocks_per_sm(int radix, int tile, int m, int n, int* blocks) {
  return static_cast<int>(
      wrp::radix_chain_blocks_per_sm<wrp::Salted<wrp::PlanarSource<int16_t>>, wrp::Body::kFused>(
          radix, tile, m, n, 0, blocks));
}

}  // extern "C"
