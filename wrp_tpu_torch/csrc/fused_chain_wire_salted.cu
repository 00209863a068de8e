// The benchmark's salted radix chain on raw wire words, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel wrp_tpu/ops/pallas/fullchain.py::
// fused_chain_power_wire with offset and salt (body
// _kernel_radix_wire_offset) for m <= 1024 (above: the wire cluster and
// matrix entries' own offset and salt): the wire kernel of fused_chain_wire.cu on
// `bs` sectors starting `offset` SECTORS into a larger staged array of
// wire words, with the int32 `salt` added to every decoded I and Q sample
// (after the in-register decode and the conversion to f32, before the
// window).
//
// What bounds it, and the design: those of fused_chain_wire.cu and
// fft_chain.cuh, whose instantiation this entry launches
// (wrp::fused_chain_wire) with its salt.

#include <cuda_runtime.h>

namespace wrp {
cudaError_t fused_chain_wire(const void* w, const void* tab, const void* phi, const void* wd,
                             const void* ph, void* out, int bs, int m, int n, int ch, int cols,
                             int blocks, long long offset, float salt, void* stream);
}  // namespace wrp

extern "C" {

// The arguments of wrp_fused_chain_wire, then the int32 salt.
int wrp_fused_chain_wire_salted(const void* w, const void* tab, const void* phi,
                                const void* wd, const void* ph, void* out, int bs, int m, int n,
                                int ch, int cols, int blocks, long long offset, int salt,
                                void* stream) {
  return static_cast<int>(wrp::fused_chain_wire(w, tab, phi, wd, ph, out, bs, m, n, ch, cols,
                                                blocks, offset, static_cast<float>(salt),
                                                stream));
}

}  // extern "C"
