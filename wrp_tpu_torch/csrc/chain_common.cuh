// Pieces shared by the chain kernels (fft_chain.cuh, behind the radix,
// wire and A-stage entries; radix_chain.cuh, the matrix form behind
// kernel_breakdown.cu; fused_chain_dense.cu; parseval_rows.cu): the block
// size, a warp sum, the in-register wire-word decode, the Parseval
// epilogue of one row, operator staging and the complex MAC.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace wrp {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One wire word -> (I, Q).  The word holds one channel-sample's wire bytes
// b0 b1 b2 b3 = I_hi I_lo Q_hi Q_lo (big-endian int16 pairs), read as a
// little-endian int32: w = b0 | b1 << 8 | b2 << 16 | b3 << 24.  One byte
// permute builds b1 | b0 << 8 | b3 << 16 | b2 << 24, whose low half is I
// and high half Q; arithmetic shifts sign-extend both (the arithmetic of
// wrp_tpu/ops/pallas/fullchain.py::decode_words_iq).
__device__ __forceinline__ void decode_word(int32_t w, float& vr, float& vi) {
  const unsigned s = __byte_perm(static_cast<unsigned>(w), 0u, 0x2301u);
  vr = static_cast<float>(static_cast<int>(s << 16) >> 16);
  vi = static_cast<float>(static_cast<int>(s) >> 16);
}

// The Parseval epilogue (wrp_tpu/pipeline.stage_b_parseval) of one row of
// Y, called by a whole warp:  q = Y wd, q -= mean(q),
//   pow = n sum|q|^2 - |q.f_k1|^2 - |q.f_k2|^2.
// Element k of the row is at rr[k * stride], ri[k * stride]; its window
// value at wd[k * cstride] and its clip phasors at ph[c * ph_row + k *
// cstride] (c = cos k1, sin k1, cos k2, sin k2).  The mean is subtracted
// explicitly: the one-pass n sum|q|^2 - |sum q|^2 form cancels under strong
// DC clutter.  Every lane returns the row's power.
__device__ __forceinline__ float parseval_row_power(const float* rr, const float* ri,
                                                    int stride, const float* wd,
                                                    const float* ph, int cstride,
                                                    int ph_row, int n, int lane) {
  const float nf = static_cast<float>(n);
  float sr = 0.f, si = 0.f;
  for (int k = lane; k < n; k += 32) {
    const float w = wd[k * cstride];
    sr += rr[k * stride] * w;
    si += ri[k * stride] * w;
  }
  const float mr = warp_sum(sr) / nf;
  const float mi = warp_sum(si) / nf;

  float e = 0.f;
  float d[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // q_r . ph[c], q_i . ph[c]
  for (int k = lane; k < n; k += 32) {
    const float w = wd[k * cstride];
    const float qr = rr[k * stride] * w - mr;
    const float qi = ri[k * stride] * w - mi;
    e += qr * qr + qi * qi;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float f = ph[c * ph_row + k * cstride];
      d[c] += qr * f;
      d[4 + c] += qi * f;
    }
  }
  e = warp_sum(e);
#pragma unroll
  for (int c = 0; c < 8; ++c) d[c] = warp_sum(d[c]);

  float pw = nf * e;
  // |q . f_k|^2 = (qr.cos - qi.sin)^2 + (qr.sin + qi.cos)^2, k = k1, k2
#pragma unroll
  for (int c = 0; c < 4; c += 2) {
    const float re = d[c] - d[4 + c + 1];
    const float im = d[c + 1] + d[4 + c];
    pw -= re * re + im * im;
  }
  return pw;
}

// Stage the block's slice of a complex operator: rows t0..t0+T-1 of
// A^T [q][t][re, im] (row pitch `pitch` complex values) for q = q0..q0+kq-1
// into a_s [kq][T][2].
template <int T>
__device__ __forceinline__ void stage_operator(float* a_s, const float* a, int pitch, int q0,
                                               int kq, int t0) {
  for (int k = threadIdx.x; k < kq * T * 2; k += kThreads) {
    const int q = k / (2 * T);
    const int r = k - q * (2 * T);
    a_s[k] = a[(static_cast<size_t>(q0) + q) * pitch * 2 + t0 * 2 + r];
  }
}

// g[t] += A[t, q] v for the T staged rows of one q (a_q = a_s + q * 2T):
// complex multiply-accumulate in fp32 FMA.  Even T reads the operator as
// float4 broadcasts (two rows per load).
template <int T>
__device__ __forceinline__ void mac_rows(float* gr, float* gi, const float* a_q, float vr,
                                         float vi) {
  if constexpr (T % 2 == 0) {
    const float4* a4 = reinterpret_cast<const float4*>(a_q);
#pragma unroll
    for (int h = 0; h < T / 2; ++h) {
      const float4 v = a4[h];  // (re, im) of rows t = 2h and 2h + 1
      gr[2 * h] = fmaf(v.x, vr, fmaf(-v.y, vi, gr[2 * h]));
      gi[2 * h] = fmaf(v.x, vi, fmaf(v.y, vr, gi[2 * h]));
      gr[2 * h + 1] = fmaf(v.z, vr, fmaf(-v.w, vi, gr[2 * h + 1]));
      gi[2 * h + 1] = fmaf(v.z, vi, fmaf(v.w, vr, gi[2 * h + 1]));
    }
  } else {
    const float2* a2 = reinterpret_cast<const float2*>(a_q);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const float2 v = a2[t];
      gr[t] = fmaf(v.x, vr, fmaf(-v.y, vi, gr[t]));
      gi[t] = fmaf(v.x, vi, fmaf(v.y, vr, gi[t]));
    }
  }
}

}  // namespace wrp
