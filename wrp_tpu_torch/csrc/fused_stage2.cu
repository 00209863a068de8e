// The pulse-domain tail of the chain, stages 03b-08, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the TPU kernel wrp_tpu/ops/pallas/postprocess.py::fused_stage2
// (body _stage2_kernel).  Per row of the range-transformed matrix Y [rows, n]
// (complex, planar f32) it computes the matched-filter power
//
//   pow[r] = sum_j conv[r, j],  conv = taps (*) |Z|^2 (circular, along j),
//   Z = Y @ B                   (B [n, n]: the Doppler operator op_b).
//
// A circular filter preserves row sums: sum_j sum_k taps[k] p[(j - k) mod n]
// = (sum_k taps[k]) sum_j p[j].  So the filter and the pulse sum fold into
// one factor, tap_sum, and the kernel is a complex fp32 GEMM with a
// row-reduction epilogue of |Z|^2: Z never leaves registers.
//
// What bounds it on this card: the product's 8 n flops per element of Y
// (8 (rows) n^2 per channel-sector, 51.5 GFLOP for 48 channel-sectors of
// 512 x 512) against 8 bytes per element of Y read: n = 512 flops per byte
// in this matrix form, far above the fp32 CUDA-core ridge (20), so the fp32
// FMA rate bounds the kernel.  (The function's least work, the Doppler
// transform as an FFT, is bound by the bytes; chip_smoke.py's bound counts
// that.)
//
// Design (a simple SIMT kernel that is right; wgmma and TMA are later
// work):
//   * A block owns kBM = 64 whole rows of Y (rows of all channel-sectors
//     are one flat [total_rows, n] matrix) and walks the columns of Z in
//     kBN = 64-wide passes, each over the full depth n in kBK = 16 steps;
//     its |Z|^2 row sums stay in registers across passes, so no partial
//     sum leaves the block and the order of every sum is fixed
//     (deterministic, independent of any caller blocking).
//   * 256 threads as 16 x 16; each thread holds a 4 x 4 complex tile of Z
//     (32 accumulators) and reads its operands as float4 broadcasts from
//     shared memory: 64 FMAs per 8 complex operands.
//   * Y [kBM, kBK] lands transposed in shared memory (padded rows), B
//     [kBK, kBN] as it is; the next step's tiles are loaded into registers
//     while the current step computes (one buffer, two barriers a step).
//   * B (2 MB at n = 512) stays in L2; each block re-reads its Y rows once
//     per column pass, from L2 or HBM.
//   * Epilogue: the 16 threads that share a row are 16 neighbouring lanes
//     of one warp; four xor-shuffles sum their partials.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;   // rows of Z per block
constexpr int kBN = 64;   // columns of Z per pass
constexpr int kBK = 16;   // depth per step
constexpr int kTM = 4;    // rows per thread
constexpr int kTN = 4;    // columns per thread
constexpr int kPad = 4;   // shared row padding (keeps float4 alignment)

static_assert((kBM / kTM) * (kBN / kTN) == kThreads, "thread tile");
static_assert(kBM * kBK == 4 * kThreads && kBK * kBN == 4 * kThreads, "one float4 each");

struct Tiles {
  float4 yr, yi, br, bi;
};

// The step's operands from global memory (zeros past the edges); n % 4 == 0.
__device__ __forceinline__ Tiles load_tiles(const float* __restrict__ yr,
                                            const float* __restrict__ yi,
                                            const float* __restrict__ br,
                                            const float* __restrict__ bi, long long row,
                                            bool row_ok, int ky, int kb, int cb, int n) {
  Tiles t;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  t.yr = t.yi = t.br = t.bi = zero;
  if (row_ok && ky < n) {
    const size_t at = static_cast<size_t>(row) * n + ky;
    t.yr = __ldg(reinterpret_cast<const float4*>(yr + at));
    t.yi = __ldg(reinterpret_cast<const float4*>(yi + at));
  }
  if (kb < n && cb < n) {
    const size_t at = static_cast<size_t>(kb) * n + cb;
    t.br = __ldg(reinterpret_cast<const float4*>(br + at));
    t.bi = __ldg(reinterpret_cast<const float4*>(bi + at));
  }
  return t;
}

__global__ void __launch_bounds__(kThreads)
fused_stage2_kernel(const float* __restrict__ yr, const float* __restrict__ yi,
                    const float* __restrict__ br, const float* __restrict__ bi,
                    float* __restrict__ out, long long total_rows, int n, float tap_sum) {
  __shared__ __align__(16) float ys_r[kBK][kBM + kPad];
  __shared__ __align__(16) float ys_i[kBK][kBM + kPad];
  __shared__ __align__(16) float bs_r[kBK][kBN];
  __shared__ __align__(16) float bs_i[kBK][kBN];

  const int tid = static_cast<int>(threadIdx.x);
  const int tx = tid & 15;  // column group: columns tx*4 .. tx*4+3 of a pass
  const int ty = tid >> 4;  // row group: rows ty*4 .. ty*4+3 of the block
  const long long r0 = static_cast<long long>(blockIdx.x) * kBM;

  // loader roles: Y row ly_row, depth ly_k..+3; B depth lb_k, columns lb_c..+3
  const int ly_row = tid >> 2;
  const int ly_k = (tid & 3) * 4;
  const int lb_k = tid >> 4;
  const int lb_c = (tid & 15) * 4;
  const long long yrow = r0 + ly_row;
  const bool yrow_ok = yrow < total_rows;

  const int ksteps = (n + kBK - 1) / kBK;
  const int passes = (n + kBN - 1) / kBN;
  const int steps = ksteps * passes;

  float rowacc[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) rowacc[i] = 0.f;
  float zr[kTM][kTN], zi[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) zr[i][j] = zi[i][j] = 0.f;
  }

  Tiles next = load_tiles(yr, yi, br, bi, yrow, yrow_ok, ly_k, lb_k, lb_c, n);
  for (int step = 0; step < steps; ++step) {
    const int pass = step / ksteps;
    const int kstep = step - pass * ksteps;
    __syncthreads();  // every read of the previous step's tiles is done
    ys_r[ly_k + 0][ly_row] = next.yr.x;
    ys_r[ly_k + 1][ly_row] = next.yr.y;
    ys_r[ly_k + 2][ly_row] = next.yr.z;
    ys_r[ly_k + 3][ly_row] = next.yr.w;
    ys_i[ly_k + 0][ly_row] = next.yi.x;
    ys_i[ly_k + 1][ly_row] = next.yi.y;
    ys_i[ly_k + 2][ly_row] = next.yi.z;
    ys_i[ly_k + 3][ly_row] = next.yi.w;
    *reinterpret_cast<float4*>(&bs_r[lb_k][lb_c]) = next.br;
    *reinterpret_cast<float4*>(&bs_i[lb_k][lb_c]) = next.bi;
    __syncthreads();
    if (step + 1 < steps) {
      const int np = (step + 1) / ksteps;
      const int nk = (step + 1 - np * ksteps) * kBK;
      next = load_tiles(yr, yi, br, bi, yrow, yrow_ok, nk + ly_k, nk + lb_k,
                        np * kBN + lb_c, n);
    }

#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 ar4 = *reinterpret_cast<const float4*>(&ys_r[k][ty * kTM]);
      const float4 ai4 = *reinterpret_cast<const float4*>(&ys_i[k][ty * kTM]);
      const float4 br4 = *reinterpret_cast<const float4*>(&bs_r[k][tx * kTN]);
      const float4 bi4 = *reinterpret_cast<const float4*>(&bs_i[k][tx * kTN]);
      const float a_r[kTM] = {ar4.x, ar4.y, ar4.z, ar4.w};
      const float a_i[kTM] = {ai4.x, ai4.y, ai4.z, ai4.w};
      const float b_r[kTN] = {br4.x, br4.y, br4.z, br4.w};
      const float b_i[kTN] = {bi4.x, bi4.y, bi4.z, bi4.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          zr[i][j] = fmaf(a_r[i], b_r[j], fmaf(-a_i[i], b_i[j], zr[i][j]));
          zi[i][j] = fmaf(a_r[i], b_i[j], fmaf(a_i[i], b_r[j], zi[i][j]));
        }
      }
    }

    if (kstep == ksteps - 1) {  // a column pass is complete: fold |Z|^2 into the rows
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
          rowacc[i] += zr[i][j] * zr[i][j] + zi[i][j] * zi[i][j];
          zr[i][j] = zi[i][j] = 0.f;
        }
      }
    }
  }

  // the 16 threads of a row group are lanes (ty & 1) * 16 + 0..15 of one warp
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    float v = rowacc[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    const long long row = r0 + ty * kTM + i;
    if (tx == 0 && row < total_rows) out[row] = tap_sum * v;
  }
}

}  // namespace

extern "C" {

// yr, yi [total_rows, n] float (all channel-sectors' rows, contiguous),
// br, bi [n, n] float, out [total_rows] float; n % 4 == 0.  Launches on
// `stream` without synchronising; returns the launch's cudaError_t (0 on
// success).  The caller validates shapes and dtypes.
int wrp_fused_stage2(const void* yr, const void* yi, const void* br, const void* bi, void* out,
                     long long total_rows, int n, float tap_sum, void* stream) {
  if (total_rows <= 0 || n <= 0 || n % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (total_rows + kBM - 1) / kBM;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  fused_stage2_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(yr), static_cast<const float*>(yi),
      static_cast<const float*>(br), static_cast<const float*>(bi), static_cast<float*>(out),
      total_rows, n, tap_sum);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
