// The benchmark's salted radix chain on planar IQ, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel wrp_tpu/ops/pallas/fullchain.py::
// fused_chain_power_radix with offset and salt (body _kernel_radix_offset):
// the FFT-form kernel of fft_chain.cuh on `bc` channel-sectors starting
// `offset` channel-sectors into a larger staged array x, with the int32
// `salt` added to every I and Q sample after its conversion to f32 (before
// the window, as wrp_tpu adds it before its contraction).  The salt makes
// every benchmark step a different function of the staged input
// (bench.py's elision-proof loop); the chain's mean subtraction removes it
// up to the pulse window's inexact cancellation.
//
// What bounds it, and the design: those of fused_chain_radix.cu, whose
// instantiation this entry launches (wrp::fused_chain_planar) with its
// salt: one f32 add per loaded sample in a kernel bound by bytes, so the
// salted and unsalted entries share one instantiation.

#include <cuda_runtime.h>

namespace wrp {
cudaError_t fused_chain_planar(const void* x, int x_is_int16, const void* tab, const void* phi,
                               const void* wd, const void* ph, void* out, int bc, int m, int n,
                               int cols, int blocks, long long offset, float salt,
                               void* stream);
}  // namespace wrp

extern "C" {

// The arguments of wrp_fused_chain_radix, then the int32 salt.
int wrp_fused_chain_radix_salted(const void* x, int x_is_int16, const void* tab,
                                 const void* phi, const void* wd, const void* ph, void* out,
                                 int bc, int m, int n, int cols, int blocks,
                                 long long offset, int salt, void* stream) {
  return static_cast<int>(wrp::fused_chain_planar(x, x_is_int16, tab, phi, wd, ph, out, bc, m,
                                                  n, cols, blocks, offset,
                                                  static_cast<float>(salt), stream));
}

}  // extern "C"
