// The fused chain, stages 01-08, in FFT form for NVIDIA Hopper (sm_90a):
// one kernel body behind fused_chain_radix{,_salted}.cu (planar IQ),
// fused_chain_wire{,_salted}.cu (raw wire words) and, storing Y instead of
// running the epilogue, fused_chain_astage.cu (the pulse-sharded path's
// A-stage).
//
// Per unit (one channel of one sector) and pulse column j it computes
//
//   Y[k, j] = sum_r W_m^(k r) (w_r c)[r] (x[r, j] + salt (1 + i)),  k < m/2
//
// and then, per row k, the Parseval epilogue of wrp_tpu/pipeline.py
// stage_b_parseval: q = Y wd, q -= mean(q),
// pow = n sum|q|^2 - |q.f_k1|^2 - |q.f_k2|^2.
//
// The TPU kernels (wrp_tpu/ops/pallas/fullchain.py _kernel_radix,
// _kernel_radix_wire, _kernel_radix_astage) ran the range DFT as dense
// sub-DFT matmuls because the MXU was their only fast unit; the matrix
// form does ~20x the flops of an FFT (26.6 against 1.6 GFLOP per 48
// channel-sectors at 1024 x 512).  Here it is an FFT in fp32 on the CUDA
// cores, about 16 FLOP per byte of int16 input: under the fp32 ridge (67
// TFLOP/s over 3.35 TB/s = 20), so the kernel is bound by bytes, once per
// sample, and tensor cores would buy nothing.
//
// The FFT (m = P L, P the largest power of two dividing m, L odd):
//   pass 1  per (column, r2, n2): a P1-point DFT in registers of rows
//           L (P2 n1 + n2) + r2, n1 < P1, loaded, converted to f32,
//           salted and windowed; the twiddle W_P^(k1 n2); to shared
//           memory (slot layout [r2][k1][n2][column], rows padded);
//   pass 2  per (column, r2, k1): a P2-point DFT in registers over n2,
//           X_r2[k1 + P1 k2];
//   pass 3  (L > 1) per (column, k): the leaf's twiddle W_m^(k r2) and an
//           L-point DFT in matrix form, Y[k + P k2].
// P1 = min(32, P), P2 = P / P1 <= 32; the register DFTs are radix-2
// butterflies, fully unrolled.  Every twiddle comes from the plan's table
// (fp64 on the host, cast once: ops/fullchain.fft_tables); none is
// computed with sincosf.  Only the rows k < m/2 are kept.
//
// The grid: a unit's columns split into chunks of `cols` (8 at m = 1024:
// 64 KB of complex fp32), dealt round-robin to the unit's `blocks` <= 8
// blocks, one thread-block cluster: in round r block b takes chunk
// r blocks + b, so the cluster's blocks read the adjacent 16-byte halves
// of each row's 32-byte sectors at about the same time.  Planar input is
// staged: the block copies its round's columns of every row into shared
// memory with 16-byte cp.async, which holds no registers, so the next
// round's copy runs under this round's pass 2 and epilogue.  Pass 2
// overwrites its input in place where its tasks fit the block's threads,
// so a block holds ~100 KB of shared memory: two blocks per SM (the matrix
// body held whole pulse rows, 136 KB, one block).  Grid (blocks,
// channels, sectors), blocks fastest.  The wire policy keeps one channel
// per block (all channels per block ran 1.8x slower in the matrix body)
// and reads its strided words straight from device memory; a sector's
// channels, which share each row's sectors, are adjacent clusters and
// run side by side.
//
// The epilogue without whole pulse rows in one block.  A thread owns the
// rows k = tid + 256 i (i < kRows) through all its block's rounds.  Per
// row the block shifts q by its first column's q (s_b: exact where a DC
// line dominates, so every later sum is at the noise's scale); per round
// it takes the mean mu_r, E_r = sum |q - mu_r|^2 and P_rc = sum (q - mu_r)
// ph_c in two passes over the round, and merges them into its running
// partials in registers (Chan's pairwise form, with the host's phasor
// sums Phi per round).  The unit's blocks form a thread-block cluster:
// each writes its per-row partials to its shared memory, and block b
// merges rows [b R, (b + 1) R) of all blocks in closed form over
// distributed shared memory, mu = sum n_b mu_b / n, E = sum [E_b +
// n_b |mu_b - mu|^2], D_c = sum [P_bc + (mu_b - mu) Phi_bc], and writes
// their power: one launch, no global scratch.
// ops/fullchain.merged_epilogue_reference is the same algebra in torch.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "chain_common.cuh"

namespace wrp {
namespace fft {

namespace cg = cooperative_groups;

constexpr int kRows = 2;                        // epilogue rows a thread owns
constexpr int kMaxM = 2 * kRows * kThreads;     // m <= 1024
constexpr int kMaxCluster = 8;                  // the portable cluster size
constexpr int kStat = 16;                       // floats per row exchanged

// cp.async: a 16-byte global -> shared copy that holds no register;
// src_bytes < 16 fills the rest of the destination with zeros (columns
// past n).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The load policies.
//
// Planar IQ x [units, 2, m, n], int16 or float (a uniform runtime switch,
// so both dtypes share one instantiation), is STAGED: each round the
// block copies its `cols` columns of every range row into shared memory
// ([plane][m][cols]) with 16-byte cp.async, one copy per row and plane at
// 8 int16 columns, issued for round r + 1 right after round r's pass 1
// has read the buffer; the copy holds no registers, so it runs under
// round r's pass 2 and epilogue.  Pass 1 then reads its rows from shared
// memory.
struct PlanarIq {
  static constexpr bool kStaged = true;
  const void* x;
  int is_int16;
  int m, n;

  __host__ __device__ int elem() const { return is_int16 ? 2 : 4; }
  // the staging buffer [plane][m][cols] in 32-bit words
  __host__ __device__ int words(int cols) const { return 2 * m * cols * elem() / 4; }

  __device__ __forceinline__ void stage(void* buf, int u, int j0, int cols) const {
    const int e = elem();
    const int nr = min(cols, n - j0);
    const size_t unit = static_cast<size_t>(u) * 2 * m * n;
    char* b = static_cast<char*>(buf);
    if ((cols * e) % 16 == 0 && (n * e) % 16 == 0 &&
        reinterpret_cast<uintptr_t>(x) % 16 == 0) {
      // a thread copies piece t % per_row of every (kThreads / per_row)-th
      // row: its addresses advance by constant strides
      const int per_row = cols * e / 16;        // a power of two
      const int piece = static_cast<int>(threadIdx.x) % per_row;
      const int col = piece * 16 / e;
      const int valid = max(0, min(16, (nr - col) * e));
      const int rstep = kThreads / per_row;
      int row = static_cast<int>(threadIdx.x) / per_row;      // plane * m + row
      const char* src = static_cast<const char*>(x) +
                        (unit + static_cast<size_t>(row) * n + j0 + (valid ? col : 0)) * e;
      char* dst = b + (static_cast<size_t>(row) * cols + col) * e;
      for (; row < 2 * m; row += rstep) {
        cp_async16(dst, src, valid);
        src += static_cast<size_t>(rstep) * n * e;
        dst += static_cast<size_t>(rstep) * cols * e;
      }
    } else {
      // rows not 16-byte aligned: copy element by element through registers
      for (int k = threadIdx.x; k < 2 * m * cols; k += kThreads) {
        const int row = k / cols;
        const int c = k - row * cols;
        const size_t at = unit + static_cast<size_t>(row) * n + j0 + c;
        if (is_int16) {
          reinterpret_cast<int16_t*>(b)[k] =
              c < nr ? __ldg(static_cast<const int16_t*>(x) + at) : static_cast<int16_t>(0);
        } else {
          reinterpret_cast<float*>(b)[k] = c < nr ? __ldg(static_cast<const float*>(x) + at) : 0.f;
        }
      }
    }
  }

  // rows row0 + i step of staged column c
  template <int N>
  __device__ __forceinline__ void read(const void* buf, int row0, int step, int c, int cols,
                                       float (&re)[N], float (&im)[N]) const {
    const int plane = m * cols;
    if (is_int16) {
      const auto* b = static_cast<const int16_t*>(buf) + row0 * cols + c;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        re[i] = static_cast<float>(b[i * step * cols]);
        im[i] = static_cast<float>(b[i * step * cols + plane]);
      }
    } else {
      const auto* b = static_cast<const float*>(buf) + row0 * cols + c;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        re[i] = b[i * step * cols];
        im[i] = b[i * step * cols + plane];
      }
    }
  }
};

// Wire words w [bs, m, ch n] int32: unit u is channel u % ch of sector
// u / ch, whose pulse j is word ch j + c of each row.  Read straight from
// device memory and decoded in registers (a channel's words are strided,
// so staging moves no fewer 32-byte sectors); the N loads of a column
// have no control flow between them, so all are in flight at once.
struct WireIq {
  static constexpr bool kStaged = false;
  const int32_t* w;
  int m, n, ch;

  __host__ __device__ int words(int) const { return 0; }

  template <int N>
  __device__ __forceinline__ void load(int u, int row0, int step, int j, float (&re)[N],
                                       float (&im)[N]) const {
    const int sec = u / ch;
    const size_t pitch = static_cast<size_t>(ch) * n;
    const int32_t* p = w + (static_cast<size_t>(sec) * m + row0) * pitch +
                       static_cast<size_t>(j) * ch + (u - sec * ch);
    int32_t v[N];
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = __ldg(p + i * step * pitch);
#pragma unroll
    for (int i = 0; i < N; ++i) decode_word(v[i], re[i], im[i]);
  }
};

// The plan's table (ops/fullchain.fft_tables): w_r c [m], then W_P^t
// (re, im) for t < P, the leaf's W_m^(k r2) at (r2 P + k), the leaf's
// W_L^(k2 r2) at (k2 L + r2).
struct Table {
  const float* win;
  const float* tw;
  const float* leaf_tw;
  const float* leaf;

  __host__ __device__ Table(const float* t, int m, int P, int L)
      : win(t), tw(t + m), leaf_tw(t + m + 2 * P), leaf(t + m + 2 * P + 2 * L * P) {}
};

__device__ __forceinline__ void cmul(float ar, float ai, float br, float bi, float& cr,
                                     float& ci) {
  cr = ar * br - ai * bi;
  ci = ar * bi + ai * br;
}

template <int N>
__host__ __device__ constexpr int log2i() {
  if constexpr (N <= 1) {
    return 0;
  } else {
    return 1 + log2i<N / 2>();
  }
}

// bit reversal of k over `bits` bits: where a DIF DFT leaves output k
__host__ __device__ constexpr int brev(int k, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r = (r << 1) | ((k >> b) & 1);
  return r;
}

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// One radix-2 decimation-in-frequency stage of span H over an N-point
// register array, then the next: in place, output in bit-reversed order.
// W_N^k = tw[2 k step] (the W_P table at step P / N).  W^0 and W^(N/4) =
// -i are applied exactly.
template <int N, int H>
__device__ __forceinline__ void dif_stage(float (&re)[N], float (&im)[N], const float* tw,
                                          int step) {
  if constexpr (H >= 1) {
#pragma unroll
    for (int base = 0; base < N; base += 2 * H) {
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const int a = base + j;
        const int b = a + H;
        const float tr = re[a] - re[b];
        const float ti = im[a] - im[b];
        re[a] += re[b];
        im[a] += im[b];
        constexpr int kStride = N / (2 * H);
        const int k = j * kStride;
        if (k == 0) {
          re[b] = tr;
          im[b] = ti;
        } else if (4 * k == N) {
          re[b] = ti;
          im[b] = -tr;
        } else {
          const float2 w = __ldg(reinterpret_cast<const float2*>(tw) + k * step);
          cmul(tr, ti, w.x, w.y, re[b], im[b]);
        }
      }
    }
    dif_stage<N, H / 2>(re, im, tw, step);
  }
}

template <int N>
__device__ __forceinline__ void dft_reg(float (&re)[N], float (&im)[N], const float* tw,
                                        int P) {
  dif_stage<N, N / 2>(re, im, tw, P / N);
}

// Shared memory of one block, in 32-bit words: A (pass 1's slot layout,
// then the natural Y [m/2][cols + 1]: in place where pass 2's tasks fit
// the block's threads and L = 1, after pass 3 for L > 1), B (pass 2's
// output where A cannot take it: L > 1, or more tasks than threads), the
// raw staging buffer S, the round's epilogue constants (wd, 4 phasor rows)
// and, reusing the front after the last round, the cluster exchange.
struct Layout {
  int sp;         // slot row pitch: P2 cols + pad
  int np;         // natural Y row pitch: cols + 1
  bool inplace;   // the natural Y overwrites A (L = 1, cols P1 <= threads)
  int size_a;     // complex values
  int size_b;
  int stage;      // words of S
  int words;      // in all

  __host__ __device__ Layout(int m, int L, int P1, int P2, int cols, bool fused,
                             int stage_words) {
    const int pad = cols < 32 ? cols : 0;
    sp = P2 * cols + pad;
    np = cols + 1;
    inplace = L == 1 && cols * P1 <= kThreads;
    size_a = imax(L * P1 * sp, L > 1 ? (m / 2) * np : 0);
    size_b = inplace ? 0 : (L == 1 ? (m / 2) * np : m * cols);
    stage = stage_words;
    const int data = 2 * (size_a + size_b) + stage + (fused ? 5 * cols : 0);
    const int stats = fused ? (m / 2) * kStat + 8 : 0;
    words = imax(data, stats);
  }
  __host__ __device__ size_t bytes() const { return static_cast<size_t>(words) * sizeof(float); }
};

// Src: PlanarIq or WireIq.  Grid (blocks, channels, sectors): unit u =
// sector * channels + channel; its block b = blockIdx.x owns the column
// chunks [q cols, min(n, (q + 1) cols)), q = b, b + blocks, ...  kFused: out = pow [units,
// m/2], launched as clusters of gridDim.x blocks; else (the A-stage) out =
// Y [units, 2, m/2, n] and wd, ph, phi are unused.
template <class Src, int P1, int P2, bool kFused>
__global__ void __launch_bounds__(kThreads, 2)
fft_chain_kernel(Src src, const float* __restrict__ tab, const float* __restrict__ phi,
                 const float* __restrict__ wd, const float* __restrict__ ph,
                 float* __restrict__ out, int m, int L, int n, int cols, float salt) {
  constexpr int P = P1 * P2;
  const int mh = m / 2;
  const int u = static_cast<int>(blockIdx.z * gridDim.y + blockIdx.y);
  const int K = static_cast<int>(gridDim.x);    // the unit's blocks: one cluster
  const int rank = static_cast<int>(blockIdx.x);
  const Table t(tab, m, P, L);
  const Layout lay(m, L, P1, P2, cols, kFused, src.words(cols));
  cg::cluster_group cluster = cg::this_cluster();

  extern __shared__ __align__(16) float smem[];
  float* a_re = smem;
  float* a_im = a_re + lay.size_a;
  float* b_re = a_im + lay.size_a;
  float* b_im = b_re + lay.size_b;
  float* stage = b_im + lay.size_b;             // the staged samples of one round
  float* rc = stage + lay.stage;                // [5][cols]: wd, ph rows
  float* y_re = L == 1 && !lay.inplace ? b_re : a_re;   // the natural Y [mh][np]
  float* y_im = L == 1 && !lay.inplace ? b_im : a_im;
  const int tid = static_cast<int>(threadIdx.x);

  // the epilogue's running partials of the rows this thread owns
  float s_r[kRows], s_i[kRows], mu_r[kRows], mu_i[kRows], e[kRows], d[kRows][8];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    s_r[i] = s_i[i] = mu_r[i] = mu_i[i] = e[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) d[i][c] = 0.f;
  }
  float phi_a[4] = {0.f, 0.f, 0.f, 0.f};
  float n_a = 0.f;

  if constexpr (Src::kStaged) {
    src.stage(stage, u, rank * cols, cols);
    cp_async_commit();
  }
  for (int r = 0; (r * K + rank) * cols < n; ++r) {
    const int q = r * K + rank;                 // this block's chunk
    const int j0 = q * cols;
    const int nr = min(cols, n - j0);           // valid columns of this round
    if constexpr (Src::kStaged) cp_async_wait_all();
    __syncthreads();                            // the round is staged; A is free
    if constexpr (kFused) {
      for (int k = tid; k < 5 * nr; k += kThreads) {
        const int row = k / nr;
        const int c = k - row * nr;
        rc[row * cols + c] = row == 0 ? __ldg(wd + j0 + c) : __ldg(ph + (row - 1) * n + j0 + c);
      }
    }

    // pass 1: samples, salt, window; P1-point DFT; twiddle W_P^(k1 n2)
    for (int task = tid; task < cols * P2 * L; task += kThreads) {
      const int c = task % cols;
      const int rest = task / cols;
      const int n2 = rest % P2;
      const int r2 = rest / P2;
      const int row0 = L * n2 + r2;
      // a column past n reads column j0 and is zeroed by its window
      const float keep = c < nr ? 1.f : 0.f;
      float re[P1], im[P1];
      if constexpr (Src::kStaged) {
        src.template read<P1>(stage, row0, L * P2, c, cols, re, im);
      } else {
        src.template load<P1>(u, row0, L * P2, c < nr ? j0 + c : j0, re, im);
      }
#pragma unroll
      for (int n1 = 0; n1 < P1; ++n1) {
        const float w = __ldg(t.win + row0 + n1 * L * P2) * keep;
        re[n1] = w * (re[n1] + salt);
        im[n1] = w * (im[n1] + salt);
      }
      dft_reg<P1>(re, im, t.tw, P);
      float* ar = a_re + (r2 * P1) * lay.sp + n2 * cols + c;
      float* ai = a_im + (r2 * P1) * lay.sp + n2 * cols + c;
#pragma unroll
      for (int k1 = 0; k1 < P1; ++k1) {
        float vr = re[brev(k1, log2i<P1>())];
        float vi = im[brev(k1, log2i<P1>())];
        if (P2 > 1 && k1 > 0) {        // W^0 = 1 exactly at n2 = 0: no branch
          const float2 w = __ldg(reinterpret_cast<const float2*>(t.tw) + (k1 * n2) % P);
          cmul(vr, vi, w.x, w.y, vr, vi);
        }
        ar[k1 * lay.sp] = vr;
        ai[k1 * lay.sp] = vi;
      }
    }
    __syncthreads();                            // A holds pass 1; the staging buffer is free
    if constexpr (Src::kStaged) {
      if (j0 + K * cols < n) src.stage(stage, u, j0 + K * cols, cols);   // under pass 2, epilogue
      cp_async_commit();
    }

    // pass 2: P2-point DFT over n2 -> X_r2[k1 + P1 k2]; in place, all of a
    // task's inputs are read before any output is written
    for (int t0 = 0; t0 < cols * P1 * L; t0 += kThreads) {
      const int task = t0 + tid;
      const bool has = task < cols * P1 * L;
      const int c = task % cols;
      const int rest = task / cols;
      const int k1 = rest % P1;
      const int r2 = rest / P1;
      float re[P2], im[P2];
      const int base = (r2 * P1 + k1) * lay.sp + c;
      if (has) {
#pragma unroll
        for (int n2 = 0; n2 < P2; ++n2) {
          re[n2] = a_re[base + n2 * cols];
          im[n2] = a_im[base + n2 * cols];
        }
      }
      if (lay.inplace) __syncthreads();
      if (has) {
        dft_reg<P2>(re, im, t.tw, P);
#pragma unroll
        for (int k2 = 0; k2 < P2; ++k2) {
          const int k = k1 + P1 * k2;
          const float vr = re[brev(k2, log2i<P2>())];
          const float vi = im[brev(k2, log2i<P2>())];
          if (L == 1) {
            if (k < mh) {
              y_re[k * lay.np + c] = vr;
              y_im[k * lay.np + c] = vi;
            }
          } else {
            b_re[(r2 * P + k) * cols + c] = vr;
            b_im[(r2 * P + k) * cols + c] = vi;
          }
        }
      }
    }
    __syncthreads();

    // pass 3 (L > 1): the leaf, Y[k + P k2] = sum_r2 W_L^(k2 r2) W_m^(k r2) X_r2[k]
    if (L > 1) {
      const auto* ltw = reinterpret_cast<const float2*>(t.leaf_tw);
      const auto* lf = reinterpret_cast<const float2*>(t.leaf);
      for (int task = tid; task < cols * P; task += kThreads) {
        const int c = task % cols;
        const int k = task / cols;
        for (int k2 = 0; k2 < L && k + P * k2 < mh; ++k2) {
          float acc_r = 0.f, acc_i = 0.f;
          for (int r2 = 0; r2 < L; ++r2) {
            float xr, xi;
            const float2 w = __ldg(ltw + r2 * P + k);
            cmul(b_re[(r2 * P + k) * cols + c], b_im[(r2 * P + k) * cols + c], w.x, w.y, xr, xi);
            const float2 f = __ldg(lf + k2 * L + r2);
            acc_r += f.x * xr - f.y * xi;
            acc_i += f.x * xi + f.y * xr;
          }
          y_re[(k + P * k2) * lay.np + c] = acc_r;
          y_im[(k + P * k2) * lay.np + c] = acc_i;
        }
      }
      __syncthreads();
    }

    if constexpr (!kFused) {
      // the A-stage: Y [units, 2, mh, n], coalesced row segments
      float* yo = out + static_cast<size_t>(u) * 2 * mh * n + j0;
      for (int k = tid; k < mh * nr; k += kThreads) {
        const int row = k / nr;
        const int c = k - row * nr;
        yo[static_cast<size_t>(row) * n + c] = y_re[row * lay.np + c];
        yo[static_cast<size_t>(mh + row) * n + c] = y_im[row * lay.np + c];
      }
    } else {
      // the round's partials of each owned row, merged into the running ones
      const float nb = static_cast<float>(nr);
      const float tot = n_a + nb;
      const float f = nb / tot;
      float phi_r[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) phi_r[cc] = __ldg(phi + q * 4 + cc);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int k = tid + i * kThreads;
        if (k >= mh) continue;
        const float* yr = y_re + k * lay.np;
        const float* yi = y_im + k * lay.np;
        if (r == 0) {
          s_r[i] = yr[0] * rc[0];
          s_i[i] = yi[0] * rc[0];
        }
        // two passes over the round, 8 columns at a time unrolled so their
        // shared-memory loads are in flight together
        float sr = 0.f, si = 0.f;
        for (int c0 = 0; c0 < nr; c0 += 8) {
#pragma unroll
          for (int c = c0; c < c0 + 8; ++c) {
            if (c < nr) {
              sr += yr[c] * rc[c] - s_r[i];
              si += yi[c] * rc[c] - s_i[i];
            }
          }
        }
        const float mr = sr / nb;
        const float mi = si / nb;
        float er = 0.f, dr[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int c0 = 0; c0 < nr; c0 += 8) {
#pragma unroll
          for (int c = c0; c < c0 + 8; ++c) {
            if (c < nr) {
              const float qr = (yr[c] * rc[c] - s_r[i]) - mr;
              const float qi = (yi[c] * rc[c] - s_i[i]) - mi;
              er += qr * qr + qi * qi;
#pragma unroll
              for (int cc = 0; cc < 4; ++cc) {
                const float p = rc[(cc + 1) * cols + c];
                dr[cc] += qr * p;
                dr[4 + cc] += qi * p;
              }
            }
          }
        }
        // Chan's merge: (n_a, mu, E, D, Phi_a) + (nb, m, er, dr, phi_r)
        const float dlr = mr - mu_r[i];
        const float dli = mi - mu_i[i];
        mu_r[i] += f * dlr;
        mu_i[i] += f * dli;
        e[i] += er + n_a * f * (dlr * dlr + dli * dli);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          d[i][cc] += dr[cc] - f * dlr * phi_a[cc] + (1.f - f) * dlr * phi_r[cc];
          d[i][4 + cc] += dr[4 + cc] - f * dli * phi_a[cc] + (1.f - f) * dli * phi_r[cc];
        }
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) phi_a[cc] += phi_r[cc];
      n_a = tot;
    }
  }

  if constexpr (kFused) {
    // the cluster's merge over distributed shared memory
    __syncthreads();                            // the last round's Y is consumed
    float* st = smem;                           // [mh][kStat], then Phi, n_b
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int k = tid + i * kThreads;
      if (k >= mh) continue;
      float* r = st + k * kStat;
      r[0] = s_r[i];
      r[1] = s_i[i];
      r[2] = mu_r[i];
      r[3] = mu_i[i];
      r[4] = e[i];
#pragma unroll
      for (int c = 0; c < 8; ++c) r[5 + c] = d[i][c];
    }
    if (tid == 0) {
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) st[mh * kStat + cc] = phi_a[cc];
      st[mh * kStat + 4] = n_a;
    }
    cluster.sync();

    const int per = (mh + K - 1) / K;
    const float nf = static_cast<float>(n);
    for (int k = rank * per + tid; k < min(mh, (rank + 1) * per); k += kThreads) {
      const float* r0 = cluster.map_shared_rank(st, 0) + k * kStat;
      const float o_r = r0[0], o_i = r0[1];     // block 0's shift: the origin
      float sr = 0.f, si = 0.f;
      for (int b = 0; b < K; ++b) {
        const float* sb = cluster.map_shared_rank(st, b);
        const float* r = sb + k * kStat;
        const float nb = sb[mh * kStat + 4];
        sr += nb * ((r[0] - o_r) + r[2]);
        si += nb * ((r[1] - o_i) + r[3]);
      }
      const float mr = sr / nf;
      const float mi = si / nf;
      float et = 0.f, dt[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int b = 0; b < K; ++b) {
        const float* sb = cluster.map_shared_rank(st, b);
        const float* r = sb + k * kStat;
        const float* phb = sb + mh * kStat;
        const float dmr = ((r[0] - o_r) + r[2]) - mr;
        const float dmi = ((r[1] - o_i) + r[3]) - mi;
        et += r[4] + phb[4] * (dmr * dmr + dmi * dmi);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          dt[cc] += r[5 + cc] + dmr * phb[cc];
          dt[4 + cc] += r[9 + cc] + dmi * phb[cc];
        }
      }
      float pw = nf * et;
      // |q . f_k|^2 = (qr.cos - qi.sin)^2 + (qr.sin + qi.cos)^2, k = k1, k2
#pragma unroll
      for (int cc = 0; cc < 4; cc += 2) {
        const float re = dt[cc] - dt[4 + cc + 1];
        const float im = dt[cc + 1] + dt[4 + cc];
        pw -= re * re + im * im;
      }
      out[static_cast<size_t>(u) * mh + k] = pw;
    }
    cluster.sync();                             // peers' shared memory stays until all read
  }
}

// The kernel for the plan's geometry: fn(P1, P2) dispatch over the P the
// radix plans give (16 <= P <= 1024; P1 = min(32, P)).
template <class Src, bool kFused, class Fn>
cudaError_t dispatch_p(int P, Fn&& fn) {
  switch (P) {
    case 16: return fn(fft_chain_kernel<Src, 16, 1, kFused>);
    case 32: return fn(fft_chain_kernel<Src, 32, 1, kFused>);
    case 64: return fn(fft_chain_kernel<Src, 32, 2, kFused>);
    case 128: return fn(fft_chain_kernel<Src, 32, 4, kFused>);
    case 256: return fn(fft_chain_kernel<Src, 32, 8, kFused>);
    case 512: return fn(fft_chain_kernel<Src, 32, 16, kFused>);
    case 1024: return fn(fft_chain_kernel<Src, 32, 32, kFused>);
    default: return cudaErrorInvalidValue;
  }
}

struct Geometry {
  int P, L, P1, P2;
  bool ok;
  Geometry(int m) {
    P = m & -m;
    L = m / imax(P, 1);
    P1 = P < 32 ? P : 32;
    P2 = P / imax(P1, 1);
    ok = m >= 16 && m <= kMaxM && m % 2 == 0 && P >= 16;
  }
};

// The smem bytes of a launch of `blocks` blocks per unit.
template <class Src>
size_t smem_bytes(const Src& src, const Geometry& g, int m, int cols, bool fused) {
  return Layout(m, g.L, g.P1, g.P2, cols, fused, src.words(cols)).bytes();
}

// One launch of `kernel` over units (sectors x channels), clusters of
// `blocks` blocks (one unit each).
template <class Kernel, class Src>
cudaError_t launch_clusters(Kernel kernel, size_t smem, int blocks, int channels, int sectors,
                            cudaStream_t stream, const Src& src, const float* tab,
                            const float* phi, const float* wd, const float* ph, float* out,
                            int m, int L, int n, int cols, float salt) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(channels),
                     static_cast<unsigned>(sectors));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(blocks);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, src, tab, phi, wd, ph, out, m, L, n, cols, salt);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The fused chain over units u = sector * channels + channel, clusters of
// `blocks` <= ceil(n / cols) blocks, on `stream` without synchronising.
// The caller validates shapes, dtypes and offsets.
template <class Src>
cudaError_t launch_fused(const Src& src, const float* tab, const float* phi, const float* wd,
                         const float* ph, float* out, int sectors, int channels, int m, int n,
                         int cols, int blocks, float salt, cudaStream_t stream) {
  const Geometry g(m);
  if (!g.ok || sectors <= 0 || sectors > 65535 || channels <= 0 || channels > 65535 ||
      n <= 0 || cols <= 0 || blocks <= 0 || blocks > kMaxCluster ||
      (blocks - 1) * cols >= n) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(src, g, m, cols, true);
  return dispatch_p<Src, true>(g.P, [&](auto kernel) {
    return launch_clusters(kernel, smem, blocks, channels, sectors, stream, src, tab, phi, wd,
                           ph, out, m, g.L, n, cols, salt);
  });
}

// The A-stage over `units` units of w pulses: Y [units, 2, m/2, w].
template <class Src>
cudaError_t launch_astage(const Src& src, const float* tab, float* y, int units, int m, int w,
                          int cols, int blocks, cudaStream_t stream) {
  const Geometry g(m);
  if (!g.ok || units <= 0 || units > 65535 || w <= 0 || cols <= 0 || blocks <= 0 ||
      blocks > kMaxCluster || (blocks - 1) * cols >= w) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(src, g, m, cols, false);
  return dispatch_p<Src, false>(g.P, [&](auto kernel) {
    return launch_clusters(kernel, smem, blocks, 1, units, stream, src, tab, nullptr, nullptr,
                           nullptr, y, m, g.L, w, cols, 0.f);
  });
}

// Resident blocks per SM and the clusters of `blocks` blocks the card can
// hold at once (cudaOccupancyMaxActiveClusters), at (m, cols) for the
// source `src` (its staging buffer's size).
template <class Src, bool kFused>
cudaError_t occupancy(const Src& src, int m, int cols, int blocks, int* blocks_per_sm,
                      int* clusters) {
  const Geometry g(m);
  if (!g.ok || cols <= 0 || blocks <= 0 || blocks > kMaxCluster) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(src, g, m, cols, kFused);
  return dispatch_p<Src, kFused>(g.P, [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(blocks), 1u, 1u);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(blocks);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  });
}

}  // namespace fft
}  // namespace wrp
