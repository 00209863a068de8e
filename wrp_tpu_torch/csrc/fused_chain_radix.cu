// Fused radar chain on planar IQ, stages 01-08, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel wrp_tpu/ops/pallas/fullchain.py::
// fused_chain_power_radix (body _kernel_radix).  Per channel-sector it maps
// planar IQ x [2, m, n] (int16 or f32, range rows in NATURAL order) to the
// matched-filter power pow [m/2] through the radix-R kernel of
// radix_chain.cuh (its math, bound and design are described there), with
// the planar load policy: element (row, pulse j) at x[row n + j].  Each
// channel-sector is a unit of its own (grid (M / T, 1, bc)).

#include <cuda_runtime.h>

#include <cstdint>

#include "radix_chain.cuh"

extern "C" {

// x [bc, 2, m, n] int16 or float, a [R, M, M, 2], fac [S, R, 2], wd [n],
// ph [4, n] float, out [bc, m/2] float.  Launches on `stream` without
// synchronising; returns the launch's cudaError_t (0 on success).  The
// caller validates shapes and dtypes.
int wrp_fused_chain_radix(const void* x, int x_is_int16, const void* a, const void* fac,
                          const void* wd, const void* ph, void* out, int bc, int m, int n,
                          int radix, int tile, void* stream) {
  const auto* af = static_cast<const float*>(a);
  const auto* ff = static_cast<const float*>(fac);
  const auto* wf = static_cast<const float*>(wd);
  const auto* pf = static_cast<const float*>(ph);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_is_int16
          ? wrp::launch_radix_chain(radix, tile,
                                    wrp::PlanarSource<int16_t>{
                                        static_cast<const int16_t*>(x), m, n},
                                    af, ff, wf, pf, of, bc, 1, m, n, st)
          : wrp::launch_radix_chain(radix, tile,
                                    wrp::PlanarSource<float>{static_cast<const float*>(x), m, n},
                                    af, ff, wf, pf, of, bc, 1, m, n, st);
  return static_cast<int>(err);
}

const char* wrp_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
