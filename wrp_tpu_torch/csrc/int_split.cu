// The int16 -> bf16 hi/lo split check, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel tools/int_split_repro.py (`pl.pallas_call` at :85,
// body `kernel` at :64-79): an int16 plane x [m, n] is split into two bf16
// planes and dotted with a bf16 operator A [m, m] on the tensor cores,
//
//   out = A @ hi + A @ lo      (fp32 accumulation, [m, n] fp32),
//
// with the split as the TPU kernel made it:
//   variant 0, "int":  lo = v & 63, hi = v - lo (integer masks);
//   variant 1, "f32":  h = bf16(float(v)), l = bf16(float(v) - h).
// Both round to nearest even (__float2bfloat16_rn, as torch and ml_dtypes
// do).  hi + lo == v exactly for every v in the 14-bit ADC range; outside
// it the mask split's hi needs 9 significant bits where bf16 has 8.
//
// What bounds it: 2 dots of 2 m m n flops (33.6 MFLOP at 128 x 512) on
// 0.42 MB: far under a microsecond either way, so the launch.
//
// Design: one block per 64-column slice (8 columns where n % 64 != 0) and
// 128 output rows, one warp per 16 rows.  The block stages its rows of A
// with cp.async, splits its slice of x in registers into hi and lo planes in
// shared memory ([k][n] row-major, read with ldmatrix .trans), and runs the
// two dots with mma.m16n8k16 into separate fp32 accumulators, added at the
// end as the TPU kernel adds its two dots.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;        // bf16 of padding per shared-memory row
constexpr int kMaxWarps = 8;   // 128 output rows per block

// hi/lo planes of one int16 sample
template <bool kMask>
__device__ __forceinline__ void split(int16_t v, bf16& h, bf16& l) {
  if constexpr (kMask) {
    const int lo = v & 63;  // the low 6 bits of the two's-complement value
    h = __float2bfloat16_rn(static_cast<float>(v - lo));
    l = __float2bfloat16_rn(static_cast<float>(lo));
  } else {
    const float f = static_cast<float>(v);
    h = __float2bfloat16_rn(f);
    l = __float2bfloat16_rn(f - __bfloat162float(h));
  }
}

template <int NT, bool kMask>
__global__ void __launch_bounds__(32 * kMaxWarps)
int_split_kernel(const int16_t* __restrict__ x, const bf16* __restrict__ a,
                 float* __restrict__ out, int m, int n) {
  constexpr int BN = 8 * NT;
  constexpr int ps = BN + kPad;  // pitch of the hi/lo planes
  const int n0 = blockIdx.x * BN;
  const int rows = 16 * (blockDim.x >> 5);
  const int row0 = blockIdx.y * rows;
  const int lane = threadIdx.x & 31;
  const int r0 = 16 * (threadIdx.x >> 5);
  const int a_pitch = m + kPad;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);     // [rows][a_pitch]
  bf16* hs = as + static_cast<size_t>(rows) * a_pitch;  // [m][ps]
  bf16* ls = hs + static_cast<size_t>(m) * ps;          // [m][ps]

  const int kc = m / 8;
  for (int c = threadIdx.x; c < rows * kc; c += blockDim.x) {
    const int r = c / kc;
    const int col = (c - r * kc) * 8;
    wrp::cp_async16(as + r * a_pitch + col, a + static_cast<size_t>(row0 + r) * m + col);
  }
  wrp::cp_async_commit();
  constexpr int nc = BN / 8;  // 8-sample chunks per row of the slice
  for (int c = threadIdx.x; c < m * nc; c += blockDim.x) {
    const int k = c / nc;
    const int col = (c - k * nc) * 8;
    const uint4 raw =
        *reinterpret_cast<const uint4*>(x + static_cast<size_t>(k) * n + n0 + col);
    const uint32_t words[4] = {raw.x, raw.y, raw.z, raw.w};
    uint32_t hp[4], lp[4];  // two bf16 per word, the lower column in the low half
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      bf16 h0, l0, h1, l1;
      split<kMask>(static_cast<int16_t>(words[e] & 0xffffu), h0, l0);
      split<kMask>(static_cast<int16_t>(words[e] >> 16), h1, l1);
      hp[e] = __bfloat16_as_ushort(h0) | (static_cast<uint32_t>(__bfloat16_as_ushort(h1)) << 16);
      lp[e] = __bfloat16_as_ushort(l0) | (static_cast<uint32_t>(__bfloat16_as_ushort(l1)) << 16);
    }
    *reinterpret_cast<uint4*>(hs + k * ps + col) = make_uint4(hp[0], hp[1], hp[2], hp[3]);
    *reinterpret_cast<uint4*>(ls + k * ps + col) = make_uint4(lp[0], lp[1], lp[2], lp[3]);
  }
  wrp::cp_async_wait<0>();
  __syncthreads();

  float acc_h[NT][4], acc_l[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_h[j][e] = acc_l[j][e] = 0.f;
  }
  wrp::warp_tile_mma<NT>(acc_h, as, a_pitch, r0, hs, ps, 0, m, lane);
  wrp::warp_tile_mma<NT>(acc_l, as, a_pitch, r0, ls, ps, 0, m, lane);

  const int g = lane >> 2;
  const int c2 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float* o = out + static_cast<size_t>(row0 + r0 + g) * n + n0 + 8 * j + c2;
    *reinterpret_cast<float2*>(o) =
        make_float2(acc_h[j][0] + acc_l[j][0], acc_h[j][1] + acc_l[j][1]);
    *reinterpret_cast<float2*>(o + static_cast<size_t>(8) * n) =
        make_float2(acc_h[j][2] + acc_l[j][2], acc_h[j][3] + acc_l[j][3]);
  }
}

int rows_per_block(int m) { return m < 16 * kMaxWarps ? m : 16 * kMaxWarps; }

size_t int_split_smem_bytes(int m, int bn) {
  return (static_cast<size_t>(rows_per_block(m)) * (m + kPad) +
          static_cast<size_t>(2) * m * (bn + kPad)) *
         sizeof(bf16);
}

template <int NT, bool kMask>
cudaError_t launch_split(const int16_t* x, const bf16* a, float* out, int m, int n,
                         cudaStream_t stream) {
  const size_t smem = int_split_smem_bytes(m, 8 * NT);
  auto kernel = int_split_kernel<NT, kMask>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int rows = rows_per_block(m);
  const dim3 grid(static_cast<unsigned>(n / (8 * NT)), static_cast<unsigned>(m / rows));
  kernel<<<grid, 2 * rows, smem, stream>>>(x, a, out, m, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [m, n] int16, a [m, m] bf16, out [m, n] float; variant 0 = int (mask
// split), 1 = f32 (cast split).  m % 16 == 0 and (m <= 128 or m % 128 ==
// 0), n % 8 == 0.  Launches on `stream` without synchronising; returns the
// launch's cudaError_t (0 on success; cudaErrorInvalidValue for shapes it
// does not take).
int wrp_int_split_dot(const void* x, const void* a, void* out, int m, int n, int variant,
                      void* stream) {
  if (m <= 0 || m % 16 != 0 || (m > 16 * kMaxWarps && m % (16 * kMaxWarps) != 0) || n <= 0 ||
      n % 8 != 0 || (variant != 0 && variant != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xi = static_cast<const int16_t*>(x);
  const auto* ab = static_cast<const bf16*>(a);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (n % 64 == 0) {
    err = variant == 0 ? launch_split<8, true>(xi, ab, of, m, n, st)
                       : launch_split<8, false>(xi, ab, of, m, n, st);
  } else {
    err = variant == 0 ? launch_split<1, true>(xi, ab, of, m, n, st)
                       : launch_split<1, false>(xi, ab, of, m, n, st);
  }
  return static_cast<int>(err);
}

}  // extern "C"
