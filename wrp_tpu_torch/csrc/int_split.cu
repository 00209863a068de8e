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
// What bounds it: 2 dots of 2 m m n flops (33.6 MFLOP at 128 x 512, 0.034
// us at 989.4 TFLOP/s) on 0.42 MB (0.13 us at 3.35 TB/s): far under a
// microsecond either way, so what is left is latency: the launch, one
// round trip of loads, the chain of products.
//
// Design: spread over the card.  One block per 32 x 32 tile of out (64
// blocks at [128, 512]), four warps of 16 x 16.  A block's rows of A
// (32 x m) and its x tile (m x 32 int16) load together, one cp.async
// round trip.  The x tile stays int16 in shared memory: ldmatrix .trans
// moves 16-bit elements of any type, so each lane receives its samples in
// the B-fragment layout and splits them in registers into its hi and lo
// fragments.  Per k16 step a warp runs four mma.m16n8k16 (two column
// tiles, hi and lo) into separate fp32 accumulators, 8 k-steps deep at
// m = 128, added at the end as the TPU kernel adds its two dots.
//
// Takes: m % 16 == 0, 16 <= m <= 1024 (shared memory), n % 8 == 0,
// n >= 8; the ragged tiles of m % 32 and n % 32 load zeros and store
// nothing past the edges.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "mma_bf16.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 32;        // rows of out per block
constexpr int kBN = 32;        // columns of out per block
constexpr int kThreads = 128;  // four warps of 16 x 16
constexpr int kPad = 8;        // 16-bit elements of padding per shared-memory row
constexpr int kMaxM = 1024;

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

// a word of two int16 samples (the lower k in the low half) -> the words
// of their hi and lo bf16 values, in the same order
template <bool kMask>
__device__ __forceinline__ void split2(uint32_t w, uint32_t& hi, uint32_t& lo) {
  bf16 h0, l0, h1, l1;
  split<kMask>(static_cast<int16_t>(w & 0xffffu), h0, l0);
  split<kMask>(static_cast<int16_t>(w >> 16), h1, l1);
  hi = __bfloat16_as_ushort(h0) | (static_cast<uint32_t>(__bfloat16_as_ushort(h1)) << 16);
  lo = __bfloat16_as_ushort(l0) | (static_cast<uint32_t>(__bfloat16_as_ushort(l1)) << 16);
}

size_t smem_bytes(int m) {
  return (static_cast<size_t>(kBM) * (m + kPad) + static_cast<size_t>(m) * (kBN + kPad)) *
         sizeof(bf16);
}

template <bool kMask>
__global__ void __launch_bounds__(kThreads)
int_split_kernel(const int16_t* __restrict__ x, const bf16* __restrict__ a,
                 float* __restrict__ out, int m, int n) {
  const int n0 = blockIdx.x * kBN;
  const int row0 = blockIdx.y * kBM;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wr = 16 * (warp & 1);   // the warp's rows in the tile
  const int wc = 16 * (warp >> 1);  // and columns
  const int a_pitch = m + kPad;
  constexpr int x_pitch = kBN + kPad;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* as = reinterpret_cast<bf16*>(smem_raw);              // [kBM][a_pitch]
  int16_t* xs = reinterpret_cast<int16_t*>(as + kBM * a_pitch);  // [m][x_pitch]

  const int kc = m / 8;  // 16-byte chunks per row of A
  for (int i = threadIdx.x; i < kBM * kc; i += kThreads) {
    const int r = i / kc;
    const int col = (i - r * kc) * 8;
    if (row0 + r < m) {
      wrp::cp_async16(as + r * a_pitch + col, a + static_cast<size_t>(row0 + r) * m + col);
    } else {
      *reinterpret_cast<uint4*>(as + r * a_pitch + col) = make_uint4(0, 0, 0, 0);
    }
  }
  constexpr int xc = kBN / 8;  // 16-byte chunks per row of the x tile
  for (int i = threadIdx.x; i < m * xc; i += kThreads) {
    const int k = i / xc;
    const int col = (i - k * xc) * 8;
    if (n0 + col < n) {
      wrp::cp_async16(xs + k * x_pitch + col, x + static_cast<size_t>(k) * n + n0 + col);
    } else {
      *reinterpret_cast<uint4*>(xs + k * x_pitch + col) = make_uint4(0, 0, 0, 0);
    }
  }
  wrp::cp_async_commit();
  wrp::cp_async_wait<0>();
  __syncthreads();

  float acc_h[2][4], acc_l[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_h[j][e] = acc_l[j][e] = 0.f;
  }
  const bf16* xb = reinterpret_cast<const bf16*>(xs);  // ldmatrix moves the int16 bits as they are
#pragma unroll 4
  for (int k0 = 0; k0 < m; k0 += 16) {
    uint32_t af[4], xw[4], hw[4], lw[4];
    wrp::ldmatrix_a(af, as, a_pitch, wr, k0, lane);
    wrp::ldmatrix_b2(xw, xb, x_pitch, k0, wc, lane);
#pragma unroll
    for (int e = 0; e < 4; ++e) split2<kMask>(xw[e], hw[e], lw[e]);
    wrp::mma_bf16_16816(acc_h[0], af, hw[0], hw[1]);
    wrp::mma_bf16_16816(acc_h[1], af, hw[2], hw[3]);
    wrp::mma_bf16_16816(acc_l[0], af, lw[0], lw[1]);
    wrp::mma_bf16_16816(acc_l[1], af, lw[2], lw[3]);
  }

  const int g = lane >> 2;
  const int c2 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int col = n0 + wc + 8 * j + c2;
    if (col >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wr + g + 8 * h;
      if (row < m) {
        *reinterpret_cast<float2*>(out + static_cast<size_t>(row) * n + col) =
            make_float2(acc_h[j][2 * h] + acc_l[j][2 * h],
                        acc_h[j][2 * h + 1] + acc_l[j][2 * h + 1]);
      }
    }
  }
}

bool takes(int m, int n) {
  return m >= 16 && m % 16 == 0 && m <= kMaxM && n >= 8 && n % 8 == 0;
}

dim3 grid_of(int m, int n) {
  return dim3(static_cast<unsigned>((n + kBN - 1) / kBN),
              static_cast<unsigned>((m + kBM - 1) / kBM));
}

template <bool kMask>
cudaError_t launch_split(const int16_t* x, const bf16* a, float* out, int m, int n,
                         cudaStream_t stream) {
  const size_t smem = smem_bytes(m);
  auto kernel = int_split_kernel<kMask>;
  if (smem > 48 * 1024) {  // above the default only by request
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid_of(m, n), kThreads, smem, stream>>>(x, a, out, m, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [m, n] int16, a [m, m] bf16, out [m, n] float; variant 0 = int (mask
// split), 1 = f32 (cast split).  Takes the shapes in the note above.
// Launches on `stream` without synchronising; returns the launch's
// cudaError_t (0 on success; cudaErrorInvalidValue for shapes it does not
// take).
int wrp_int_split_dot(const void* x, const void* a, void* out, int m, int n, int variant,
                      void* stream) {
  if (!takes(m, n) || (variant != 0 && variant != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* xi = static_cast<const int16_t*>(x);
  const auto* ab = static_cast<const bf16*>(a);
  auto* of = static_cast<float*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = variant == 0 ? launch_split<true>(xi, ab, of, m, n, st)
                                       : launch_split<false>(xi, ab, of, m, n, st);
  return static_cast<int>(err);
}

// The blocks a call of wrp_int_split_dot launches, or -1 for shapes it
// refuses.
int wrp_int_split_dot_blocks(int m, int n) {
  if (!takes(m, n)) return -1;
  const dim3 grid = grid_of(m, n);
  return static_cast<int>(grid.x * grid.y);
}

}  // extern "C"
