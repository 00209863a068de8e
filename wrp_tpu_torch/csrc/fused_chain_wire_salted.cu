// The benchmark's salted radix chain on raw wire words, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel wrp_tpu/ops/pallas/fullchain.py::
// fused_chain_power_wire with offset and salt (body
// _kernel_radix_wire_offset): the wire kernel of fused_chain_wire.cu on
// `bs` sectors starting `offset` SECTORS into a larger staged array of
// wire words, with the int32 `salt` added to every decoded I and Q sample
// (after the in-register decode and the conversion to f32, before the
// contraction).
//
// What bounds it, and the design: those of fused_chain_wire.cu and
// radix_chain.cuh, whose kernel body this is, with the
// Salted<WireSource> load policy.  The offset is pointer arithmetic in this
// launcher.  Its own source, so the unsalted wire kernel compiles exactly
// as before.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "radix_chain.cuh"

extern "C" {

// w [>= offset + bs, m, ch n] int32, a [R, M, M, 2], fac [S, R, 2],
// wd [ch n], ph [4, ch n] float, out [bs, ch, m/2] float.  Launches on
// `stream` without synchronising; returns the launch's cudaError_t (0 on
// success).  The caller validates shapes, dtypes and the offset's range.
int wrp_fused_chain_wire_salted(const void* w, const void* a, const void* fac, const void* wd,
                                const void* ph, void* out, int bs, int m, int n, int ch,
                                int radix, int tile, long long offset, int salt,
                                void* stream) {
  const size_t skip = static_cast<size_t>(offset) * m * ch * n;  // words
  using Src = wrp::Salted<wrp::WireSource>;
  const cudaError_t err = wrp::launch_radix_chain(
      radix, tile, Src{{static_cast<const int32_t*>(w) + skip, m, n, ch}, static_cast<float>(salt)},
      static_cast<const float*>(a), static_cast<const float*>(fac),
      static_cast<const float*>(wd), static_cast<const float*>(ph), static_cast<float*>(out),
      bs, ch, m, n, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

}  // extern "C"
