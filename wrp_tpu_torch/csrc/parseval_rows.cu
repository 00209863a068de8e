// The row epilogue of the pulse-sharded chain, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel wrp_tpu/ops/pallas/fullchain.py::
// parseval_rows_power (body _kernel_parseval_rows).  Per channel-sector it
// maps half-spectrum rows Y [2, rows, n] f32 (the FULL pulse axis, any
// slice of the m/2 range bins: after the all_to_all each rank holds
// rows = m/2 / ranks of them) to the matched-filter power [rows]:
// q = Y wd, q -= mean(q), pow = n sum|q|^2 - |q.f_k1|^2 - |q.f_k2|^2, the
// fused kernels' epilogue (chain_common.cuh `parseval_row_power`) reading
// its row from global memory at stride 1.
//
// What bounds it: 26 flops per element against 8 bytes of Y read, so
// bytes.  One warp per row; each lane reads every 32nd element, so a
// warp's loads are 128-byte coalesced.  The mean is subtracted explicitly
// (the one-pass n sum|q|^2 - |sum q|^2 form cancels under strong DC
// clutter), so the row is read twice; the second read of its 4 KB finds it
// in L1 or L2.

#include <cuda_runtime.h>

#include <cstddef>

#include "chain_common.cuh"

namespace {

__global__ void __launch_bounds__(wrp::kThreads)
parseval_rows_kernel(const float* __restrict__ y, const float* __restrict__ wd,
                     const float* __restrict__ ph, float* __restrict__ out, long long total_rows,
                     int rows, int n) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * (wrp::kThreads / 32) + (threadIdx.x >> 5);
  if (row >= total_rows) return;  // whole warps: no barrier below
  const long long u = row / rows;
  const long long r = row - u * rows;
  const float* rr = y + (static_cast<size_t>(u) * 2 * rows + r) * n;
  const float* ri = rr + static_cast<size_t>(rows) * n;
  const float pw = wrp::parseval_row_power(rr, ri, 1, wd, ph, 1, n, n, lane);
  if (lane == 0) out[row] = pw;
}

}  // namespace

extern "C" {

// y [bc, 2, rows, n] float, wd [n], ph [4, n] float, out [bc, rows] float.
// Launches on `stream` without synchronising; returns the launch's
// cudaError_t (0 on success).  The caller validates shapes and dtypes.
int wrp_parseval_rows(const void* y, const void* wd, const void* ph, void* out, int bc,
                      int rows, int n, void* stream) {
  if (bc <= 0 || rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(bc) * rows;
  const long long blocks = (total + wrp::kThreads / 32 - 1) / (wrp::kThreads / 32);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  parseval_rows_kernel<<<static_cast<unsigned>(blocks), wrp::kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(y), static_cast<const float*>(wd),
      static_cast<const float*>(ph), static_cast<float*>(out), total, rows, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
