// The fused chain, stages 01-08, in FFT form for NVIDIA Hopper (sm_90a):
// one kernel body behind fused_chain_radix{,_salted}.cu (planar IQ; also
// the dense entries of fused_chain_dense.cu for every even m <= 1024 and
// m = 2 x odd in (2048, 4096]),
// fused_chain_wire{,_salted}.cu (raw wire words) and, storing Y instead of
// running the epilogue, fused_chain_astage.cu (the pulse-sharded path's
// A-stage); all for m <= 1024 only but the dense entries' long-ray form.
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
// The FFT (m = P L, P the largest power of two dividing m, 2 <= P <= 1024,
// L odd):
//   pass 1  per (column, r2, n2): a P1-point DFT in registers of rows
//           L (P2 n1 + n2) + r2, n1 < P1, loaded, converted to f32,
//           salted and windowed; the twiddle W_P^(k1 n2); to shared
//           memory (slot layout [r2][k1][n2][column], rows padded; for
//           P2 = 1 and L > 1 straight to the leaf's layout, as pass 2);
//   pass 2  per (column, r2, k1): a P2-point DFT in registers over n2,
//           X_r2[k1 + P1 k2]; for L > 1 times the leaf's twiddle
//           W_m^(k r2), to the leaf's layout [k][r2][column];
//   leaf    (L > 1) per (column, k): the L-point DFT over r2 as a
//           mixed-radix Stockham FFT in shared memory, one pass per
//           factor of L (radix 5, 3 and 7 unrolled in registers; any
//           other factor in one pass of its own size), its twiddles from
//           the table's L roots W_L^t; the last pass writes Y[k + P k2].
//           At m = 1000 = 8 x 125 the leaf is three radix-5 passes: about
//           a tenth of the matrix form's 125 x 125 complex MACs a column.
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
// memory with 16-byte cp.async (8-byte where a round's row is 8 bytes:
// 4 int16 columns at m = 1000), which holds no registers, so the next
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
//
// Which kernel serves which m.  This body serves m <= 1024 for every
// entry (fft_chain_kernel, the register body).  The dense entries' m = 2 x
// odd in (2048, 4096] run fft_chain_long_kernel below (P = 2); every other
// m up to 16384 that cluster_chain.cuh takes runs there (each ray split
// across a cluster of blocks: the radix, wire and A-stage entries, and the
// dense entries' m = S x odd); the rest the matrix forms
// (fused_chain_dense.cu, fused_chain_astage_matrix.cu).
// ops/fullchain.chain_route chooses from m alone.
//
// fft_chain_long_kernel, the dense entries' long-ray form, is the same
// body with two changes.  A thread would own m/512 rows, 13 floats of
// partials each (more than 52 live floats above m = 2048): they would
// spill.  So every row's partials live in shared memory, [13][m/2] floats,
// read and written once per row and round, and the cluster merges them in
// place (no exchange buffer).  And the leaf runs at every odd L up to 2047
// (m = 4094: 2047 = 23 x 89 has no factor 3, 5, 7, so one 2047-point
// pass), a pass of radix other than 3, 5, 7 spread over the block
// (leaf_pass_split: one thread's 2047 outputs would leave 2 of 256 threads
// busy at one column a round).
// Round sizes: ops/fullchain.fft_geometry; one block per SM
// (__launch_bounds__(256, 1): no spill).  Its kernel is instantiated in
// fused_chain_radix_long.cu, beside the m <= 1024 ones, so that nvcc
// builds them in parallel; the m <= 1024 instantiations are those of the
// register body, unchanged.
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
constexpr int kMaxM = 2 * kRows * kThreads;     // m <= 1024: partials in registers
constexpr int kLongMinM = 2050;                 // the long-ray body: m = 2 x odd, partials in smem
constexpr int kLongMaxM = 4096;
constexpr int kMaxCluster = 8;                  // the portable cluster size
constexpr int kStat = 16;                       // floats per row exchanged (m <= 1024)
constexpr int kPart = 13;                       // floats of a row's partials (long body)

// cp.async: a B-byte global -> shared copy that holds no register (B = 16:
// L2 only; B = 8, 4: through L1, the only such forms); src_bytes < B fills
// the rest of the destination with zeros (columns past n).
template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (B == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes));
  } else if constexpr (B == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes));
  } else {
    static_assert(B == 4, "cp.async copies 16, 8 or 4 bytes here");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(src_bytes));
  }
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
// 8 int16 columns (8-byte copies where a row of the round is 8 bytes, 4
// int16 columns), issued for round r + 1 right after round r's pass 1
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

  // the round's rows in B-byte pieces: a thread copies piece t % per_row of
  // every (kThreads / per_row)-th row, its addresses advancing by constant
  // strides
  template <int B>
  __device__ __forceinline__ void stage_pieces(char* b, size_t unit, int j0, int nr,
                                               int cols) const {
    const int e = elem();
    const int per_row = cols * e / B;           // a power of two
    const int piece = static_cast<int>(threadIdx.x) % per_row;
    const int col = piece * B / e;
    const int valid = max(0, min(B, (nr - col) * e));
    const int rstep = kThreads / per_row;
    int row = static_cast<int>(threadIdx.x) / per_row;      // plane * m + row
    const char* src = static_cast<const char*>(x) +
                      (unit + static_cast<size_t>(row) * n + j0 + (valid ? col : 0)) * e;
    char* dst = b + (static_cast<size_t>(row) * cols + col) * e;
    for (; row < 2 * m; row += rstep) {
      cp_async<B>(dst, src, valid);
      src += static_cast<size_t>(rstep) * n * e;
      dst += static_cast<size_t>(rstep) * cols * e;
    }
  }

  // kMinB: the narrowest copy an instantiation may stage a row with: 8 for
  // the leaf's geometries (4 int16 columns a round at m = 1000), 4 for the
  // long-ray body (1 or 2 int16 columns a round), 16 for the others, whose
  // code keeps the 16-byte path alone
  template <int kMinB>
  __device__ __forceinline__ void stage(void* buf, int u, int j0, int cols) const {
    const int e = elem();
    const int nr = min(cols, n - j0);
    const size_t unit = static_cast<size_t>(u) * 2 * m * n;
    char* b = static_cast<char*>(buf);
    const uintptr_t at = reinterpret_cast<uintptr_t>(x);
    if ((cols * e) % 16 == 0 && (n * e) % 16 == 0 && at % 16 == 0) {
      stage_pieces<16>(b, unit, j0, nr, cols);
    } else if (kMinB <= 8 && (cols * e) % 8 == 0 && (n * e) % 8 == 0 && at % 8 == 0) {
      stage_pieces<8>(b, unit, j0, nr, cols);
    } else if (kMinB <= 4 && (cols * e) % 4 == 0 && (n * e) % 4 == 0 && at % 4 == 0) {
      stage_pieces<4>(b, unit, j0, nr, cols);
    } else {
      // rows too narrow or not aligned: copy element by element through registers
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
// roots W_L^t for t < L.
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

// The leaf's factors: the radix of the next Stockham pass over the `rem`
// points still to combine (5, 3 and 7 first; any other factor whole), and
// the number of passes for L.
__host__ __device__ inline int leaf_radix(int rem) {
  return rem % 5 == 0 ? 5 : rem % 3 == 0 ? 3 : rem % 7 == 0 ? 7 : rem;
}
__host__ __device__ inline int leaf_passes(int L) {
  int passes = 0;
  for (int rem = L; rem > 1; rem /= leaf_radix(rem)) ++passes;
  return passes;
}

// One Stockham pass of radix R of the leaf: per column c < cols and
// sub-transform k < P, in[(k L + r) cols + c] (r < L, the points still in
// the order the previous pass left them) -> out.  Task (j, k, c), j <
// L / R: v_r = in[j + r L/R] times W_(ns R)^(r (j mod ns)), an R-point DFT,
// out[d + s ns] = its output s, d = (j / ns) ns R + j mod ns; ns is the
// product of the radices before this pass.  The last pass writes the
// natural Y instead: row k + P t (t = d + s ns) of pitch np, rows < m/2.
// `roots` are the table's W_L^t.  R = 0: a pass of radix `rr` (a factor
// other than 3, 5, 7) as loops, its inputs read from shared memory again
// for every output.
template <int R>
__device__ __forceinline__ void leaf_pass(const float* ire, const float* iim, float* ore,
                                          float* oim, const float2* __restrict__ roots, int L,
                                          int P, int cols, int ns, int rr, bool last, int mh,
                                          int np) {
  const int radix = R > 0 ? R : rr;
  const int lr = L / radix;                     // tasks per sub-transform and column
  const int step = L / (ns * radix);            // W_(ns R) = W_L^step
  const int tasks = P * cols * lr;
  for (int task = threadIdx.x; task < tasks; task += kThreads) {
    const int c = task % cols;
    const int rest = task / cols;
    const int j = rest % lr;
    const int k = rest / lr;
    const int kk = j % ns;
    const float* pr = ire + (k * L + j) * cols + c;
    const float* pi = iim + (k * L + j) * cols + c;
    const int d = (j / ns) * ns * radix + kk;
    auto store = [&](int s, float vr, float vi) {
      const int t = d + s * ns;
      if (last) {
        const int row = k + P * t;
        if (row < mh) {
          ore[row * np + c] = vr;
          oim[row * np + c] = vi;
        }
      } else {
        ore[(k * L + t) * cols + c] = vr;
        oim[(k * L + t) * cols + c] = vi;
      }
    };
    if constexpr (R > 0) {
      float re[R], im[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        re[r] = pr[r * lr * cols];
        im[r] = pi[r * lr * cols];
        if (r > 0 && kk > 0) {
          const float2 w = __ldg(roots + (r * kk * step) % L);
          cmul(re[r], im[r], w.x, w.y, re[r], im[r]);
        }
      }
      float2 wr[R];                             // W_R^t, t < R
#pragma unroll
      for (int t = 1; t < R; ++t) wr[t] = __ldg(roots + t * lr);
#pragma unroll
      for (int s = 0; s < R; ++s) {
        float ar = re[0], ai = im[0];
#pragma unroll
        for (int r = 1; r < R; ++r) {
          const float2 w = wr[(r * s) % R];
          if ((r * s) % R == 0) {
            ar += re[r];
            ai += im[r];
          } else {
            ar += re[r] * w.x - im[r] * w.y;
            ai += re[r] * w.y + im[r] * w.x;
          }
        }
        store(s, ar, ai);
      }
    } else {
      for (int s = 0; s < radix; ++s) {
        float ar = 0.f, ai = 0.f;
        for (int r = 0; r < radix; ++r) {
          float vr = pr[r * lr * cols], vi = pi[r * lr * cols];
          if (r > 0 && kk > 0) {
            const float2 w = __ldg(roots + (r * kk * step) % L);
            cmul(vr, vi, w.x, w.y, vr, vi);
          }
          const float2 w = __ldg(roots + ((r * s) % radix) * lr);
          ar += vr * w.x - vi * w.y;
          ai += vr * w.y + vi * w.x;
        }
        store(s, ar, ai);
      }
    }
  }
}

// The long-ray body's pass of radix `radix` (a factor other than 3, 5, 7),
// leaf_pass<0> spread over more threads: a task computes kLeafOuts
// outputs s of one (j, k, column), reading each input once for all of
// them; the root indices (r s) mod radix and the twiddle's (r kk step)
// mod L advance by addition, no division in the loop.  A 2047-point pass
// (m = 4094) otherwise gives P cols = 2 tasks 2047 outputs each.
constexpr int kLeafOuts = 8;
__device__ __forceinline__ void leaf_pass_split(const float* ire, const float* iim, float* ore,
                                                float* oim, const float2* __restrict__ roots,
                                                int L, int P, int cols, int ns, int radix,
                                                bool last, int mh, int np) {
  const int lr = L / radix;
  const int step = L / (ns * radix);            // W_(ns R) = W_L^step
  const int inner = P * cols * lr;
  const int groups = (radix + kLeafOuts - 1) / kLeafOuts;
  for (int task = threadIdx.x; task < inner * groups; task += kThreads) {
    const int g = task / inner;                 // outputs g kLeafOuts + t
    const int rest0 = task - g * inner;
    const int c = rest0 % cols;
    const int rest = rest0 / cols;
    const int j = rest % lr;
    const int k = rest / lr;
    const int kk = j % ns;
    const float* pr = ire + (k * L + j) * cols + c;
    const float* pi = iim + (k * L + j) * cols + c;
    int s[kLeafOuts], at[kLeafOuts];
    float ar[kLeafOuts], ai[kLeafOuts];
#pragma unroll
    for (int t = 0; t < kLeafOuts; ++t) {
      s[t] = min(g * kLeafOuts + t, radix - 1);  // a padded output repeats the last
      at[t] = 0;                                // (r s) mod radix at r = 0
      ar[t] = ai[t] = 0.f;
    }
    const int twstep = kk * step;               // < L / radix
    int tw = 0;                                 // (r kk step) mod L
#pragma unroll 2
    for (int r = 0; r < radix; ++r) {
      float vr = pr[r * lr * cols], vi = pi[r * lr * cols];
      if (tw > 0) {
        const float2 w = __ldg(roots + tw);
        cmul(vr, vi, w.x, w.y, vr, vi);
      }
#pragma unroll
      for (int t = 0; t < kLeafOuts; ++t) {
        const float2 w = __ldg(roots + at[t] * lr);
        ar[t] += vr * w.x - vi * w.y;
        ai[t] += vr * w.y + vi * w.x;
        at[t] += s[t];
        if (at[t] >= radix) at[t] -= radix;
      }
      tw += twstep;
      if (tw >= L) tw -= L;
    }
    const int d = (j / ns) * ns * radix + kk;
#pragma unroll
    for (int t = 0; t < kLeafOuts; ++t) {
      if (g * kLeafOuts + t >= radix) break;
      const int to = d + s[t] * ns;
      if (last) {
        const int row = k + P * to;
        if (row < mh) {
          ore[row * np + c] = ar[t];
          oim[row * np + c] = ai[t];
        }
      } else {
        ore[(k * L + to) * cols + c] = ar[t];
        oim[(k * L + to) * cols + c] = ai[t];
      }
    }
  }
}

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// Shared memory of one block, in 32-bit words: A (pass 1's slot layout,
// then the natural Y [m/2][cols + 1]: in place where pass 2's tasks fit
// the block's threads and L = 1), B (pass 2's output where A cannot take
// it: more tasks than threads), the raw staging buffer S, the round's
// epilogue constants (wd, 4 phasor rows) and, reusing the front after the
// last round, the cluster exchange.  For L > 1 the leaf's Stockham passes
// run between B (their input [P][L][cols]) and A in turn, the last one
// writing the natural Y to the other buffer of its input (A for an odd
// number of passes).  The long-ray body keeps the partials [kPart][m/2]
// (then the block's Phi and n_b) after the rest, for the whole launch.
// Each part is a multiple of 16 bytes.  ops/fullchain.fft_smem_bytes is
// the same arithmetic.
struct Layout {
  int sp;         // slot row pitch: P2 cols + pad
  int np;         // natural Y row pitch: cols + 1
  bool inplace;   // Y overwrites A (L = 1 and cols P1 <= threads)
  int size_a;     // complex values
  int size_b;
  int stage;      // words of S
  int part;       // the long body's partials, from this word
  int words;      // in all

  __host__ __device__ Layout(int m, int L, int P1, int P2, int cols, bool fused,
                             int stage_words, bool lng) {
    const int pad = cols < 32 ? cols : 0;
    sp = P2 * cols + pad;
    np = cols + 1;
    inplace = L == 1 && cols * P1 <= kThreads;
    const int leaf = imax(m * cols, (m / 2) * np);    // a leaf pass's buffer
    if (L == 1) {
      size_a = round4(L * P1 * sp);
      size_b = round4(inplace ? 0 : (m / 2) * np);
    } else {
      size_a = round4(imax(P2 > 1 ? L * P1 * sp : 0, leaf));
      size_b = round4(leaf);
    }
    stage = stage_words;
    const int data = 2 * (size_a + size_b) + stage + (fused ? 5 * cols : 0);
    part = data;
    if (lng) {
      words = data + (fused ? kPart * (m / 2) + 8 : 0);
    } else {
      const int stats = fused ? (m / 2) * kStat + 8 : 0;
      words = imax(data, stats);
    }
  }
  __host__ __device__ size_t bytes() const { return static_cast<size_t>(words) * sizeof(float); }
};

// One row's partials of a round merged into its running ones (the
// epilogue above): the round's nr columns of q = Y wd, shifted by s (set
// from the first column in the first round), their mean, E_r and P_rc in
// two passes, then Chan's merge (n_a, mu, E, D, Phi_a) + (nb, m, E_r,
// P_r, phi_r), f = nb / (n_a + nb).
__device__ __forceinline__ void merge_row(const float* yr, const float* yi, const float* rc,
                                          int cols, int nr, float nb, float f, float n_a,
                                          const float (&phi_a)[4], const float (&phi_r)[4],
                                          bool first, float& s_r, float& s_i, float& mu_r,
                                          float& mu_i, float& e, float (&d)[8]) {
  if (first) {
    s_r = yr[0] * rc[0];
    s_i = yi[0] * rc[0];
  }
  // two passes over the round, 8 columns at a time unrolled so their
  // shared-memory loads are in flight together
  float sr = 0.f, si = 0.f;
  for (int c0 = 0; c0 < nr; c0 += 8) {
#pragma unroll
    for (int c = c0; c < c0 + 8; ++c) {
      if (c < nr) {
        sr += yr[c] * rc[c] - s_r;
        si += yi[c] * rc[c] - s_i;
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
        const float qr = (yr[c] * rc[c] - s_r) - mr;
        const float qi = (yi[c] * rc[c] - s_i) - mi;
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
  const float dlr = mr - mu_r;
  const float dli = mi - mu_i;
  mu_r += f * dlr;
  mu_i += f * dli;
  e += er + n_a * f * (dlr * dlr + dli * dli);
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) {
    d[cc] += dr[cc] - f * dlr * phi_a[cc] + (1.f - f) * dlr * phi_r[cc];
    d[4 + cc] += dr[4 + cc] - f * dli * phi_a[cc] + (1.f - f) * dli * phi_r[cc];
  }
}

// The body of both kernels below.  Src: PlanarIq or WireIq.  Grid
// (blocks, channels, sectors): unit u = sector * channels + channel; its
// block b = blockIdx.x owns the column chunks [q cols, min(n, (q + 1)
// cols)), q = b, b + blocks, ...  kFused: out = pow [units, m/2], launched
// as clusters of gridDim.x blocks; else (the A-stage) out = Y [units, 2,
// m/2, n] and wd, ph, phi are unused.  kLong: the long-ray body (partials
// in shared memory).
template <class Src, int P1, int P2, bool kFused, bool kLong>
__device__ __forceinline__ void fft_chain_body(Src src, const float* __restrict__ tab,
                                               const float* __restrict__ phi,
                                               const float* __restrict__ wd,
                                               const float* __restrict__ ph,
                                               float* __restrict__ out, int m, int L, int n,
                                               int cols, float salt) {
  constexpr int P = P1 * P2;
  constexpr int Q = P2;                         // pass 1's n2 < Q
  // the leaf's code exists only where it can run: an odd L > 1 fits
  // m <= kMaxM for P <= 256 (the P = 512, 1024 bodies of the register
  // body are those of L = 1 alone); the long body runs L > 1 alone
  constexpr bool kLeaf = kLong || 3 * P <= kMaxM;
  constexpr int kStageB = kLong ? 4 : kLeaf ? 8 : 16;
  const int mh = m / 2;
  const int u = static_cast<int>(blockIdx.z * gridDim.y + blockIdx.y);
  const int K = static_cast<int>(gridDim.x);    // the unit's blocks: one cluster
  const int rank = static_cast<int>(blockIdx.x);
  const Table t(tab, m, P, L);
  const Layout lay(m, L, P1, P2, cols, kFused, src.words(cols), kLong);
  cg::cluster_group cluster = cg::this_cluster();

  extern __shared__ __align__(16) float smem[];
  float* a_re = smem;
  float* a_im = a_re + lay.size_a;
  float* b_re = a_im + lay.size_a;
  float* b_im = b_re + lay.size_b;
  float* stage = b_im + lay.size_b;             // the staged samples of one round
  float* rc = stage + lay.stage;                // [5][cols]: wd, ph rows
  float* part = smem + lay.part;                // kLong: [kPart][mh] partials, Phi, n_b
  // the natural Y [mh][np]
  const bool y_in_b = !kLeaf || L == 1 ? !lay.inplace : leaf_passes(L) % 2 == 0;
  float* y_re = y_in_b ? b_re : a_re;
  float* y_im = y_in_b ? b_im : a_im;
  const auto* ltw = reinterpret_cast<const float2*>(t.leaf_tw);
  const int tid = static_cast<int>(threadIdx.x);

  // the epilogue's running partials of the rows this thread owns (the
  // register body)
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
    src.template stage<kStageB>(stage, u, rank * cols, cols);
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
    for (int task = tid; task < cols * Q * L; task += kThreads) {
      const int c = task % cols;
      const int rest = task / cols;
      const int n2 = rest % Q;
      const int r2 = rest / Q;
      const int row0 = L * n2 + r2;
      // a column past n reads column j0 and is zeroed by its window
      const float keep = c < nr ? 1.f : 0.f;
      float re[P1], im[P1];
      if constexpr (Src::kStaged) {
        src.template read<P1>(stage, row0, L * Q, c, cols, re, im);
      } else {
        src.template load<P1>(u, row0, L * Q, c < nr ? j0 + c : j0, re, im);
      }
#pragma unroll
      for (int n1 = 0; n1 < P1; ++n1) {
        const float w = __ldg(t.win + row0 + n1 * L * Q) * keep;
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
        if (Q > 1 && k1 > 0) {         // W^0 = 1 exactly at n2 = 0: no branch
          const float2 w = __ldg(reinterpret_cast<const float2*>(t.tw) + (k1 * n2) % P);
          cmul(vr, vi, w.x, w.y, vr, vi);
        }
        if (Q == 1 && kLeaf && L > 1) {
          // X_r2[k1] is final: the leaf's twiddle, then its layout in B
          if (k1 > 0) {
            const float2 w = __ldg(ltw + r2 * P + k1);
            cmul(vr, vi, w.x, w.y, vr, vi);
          }
          b_re[(k1 * L + r2) * cols + c] = vr;
          b_im[(k1 * L + r2) * cols + c] = vi;
        } else {
          ar[k1 * lay.sp] = vr;
          ai[k1 * lay.sp] = vi;
        }
      }
    }
    __syncthreads();                            // A holds pass 1; the staging buffer is free
    if constexpr (Src::kStaged) {
      if (j0 + K * cols < n) {
        src.template stage<kStageB>(stage, u, j0 + K * cols, cols);   // under pass 2, epilogue
      }
      cp_async_commit();
    }

    // pass 2: P2-point DFT over n2 -> X_r2[k1 + P1 k2]; in place, all of a
    // task's inputs are read before any output is written (none for P2 = 1
    // and L > 1: pass 1 wrote the leaf's input)
    const int pass2 = P2 == 1 && kLeaf && L > 1 ? 0 : cols * P1 * L;
    for (int t0 = 0; t0 < pass2; t0 += kThreads) {
      const int task = t0 + tid;
      const bool has = task < pass2;
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
          if (!kLeaf || L == 1) {
            if (k < mh) {
              y_re[k * lay.np + c] = vr;
              y_im[k * lay.np + c] = vi;
            }
          } else {
            float wr, wi;
            const float2 w = __ldg(ltw + r2 * P + k);
            cmul(vr, vi, w.x, w.y, wr, wi);
            b_re[(k * L + r2) * cols + c] = wr;
            b_im[(k * L + r2) * cols + c] = wi;
          }
        }
      }
    }
    __syncthreads();

    // the leaf (L > 1): Y[k + P k2] = sum_r2 W_L^(k2 r2) (W_m^(k r2) X_r2[k]),
    // Stockham passes B -> A -> B ..., the last writing Y
    if constexpr (kLeaf) {
      if (L > 1) {
        const auto* roots = reinterpret_cast<const float2*>(t.leaf);
        float *ir = b_re, *ii = b_im, *orr = a_re, *oi = a_im;
        for (int rem = L, ns = 1; rem > 1;) {
          const int R = leaf_radix(rem);
          const bool last = R == rem;
          if (R == 5) {
            leaf_pass<5>(ir, ii, orr, oi, roots, L, P, cols, ns, R, last, mh, lay.np);
          } else if (R == 3) {
            leaf_pass<3>(ir, ii, orr, oi, roots, L, P, cols, ns, R, last, mh, lay.np);
          } else if (R == 7) {
            leaf_pass<7>(ir, ii, orr, oi, roots, L, P, cols, ns, R, last, mh, lay.np);
          } else if (kLong) {
            leaf_pass_split(ir, ii, orr, oi, roots, L, P, cols, ns, R, last, mh, lay.np);
          } else {
            leaf_pass<0>(ir, ii, orr, oi, roots, L, P, cols, ns, R, last, mh, lay.np);
          }
          __syncthreads();
          float* tr = ir;
          float* ti = ii;
          ir = orr;
          ii = oi;
          orr = tr;
          oi = ti;
          rem /= R;
          ns *= R;
        }
      }
    }

    if constexpr (!kFused) {
      // the A-stage: Y [units, 2, mh, n], coalesced row segments
      float* yo = out + static_cast<size_t>(u) * 2 * mh * n + j0;
      for (int k = tid; k < mh * nr; k += kThreads) {
        const int row = k / nr;
        const int c = k - row * nr;
        const int y = row * lay.np + c;
        yo[static_cast<size_t>(row) * n + c] = y_re[y];
        yo[static_cast<size_t>(mh + row) * n + c] = y_im[y];
      }
    } else {
      // the round's partials of each owned row, merged into the running ones
      const float nb = static_cast<float>(nr);
      const float tot = n_a + nb;
      const float f = nb / tot;
      float phi_r[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) phi_r[cc] = __ldg(phi + q * 4 + cc);
      if constexpr (kLong) {
        // every row's partials in shared memory: [j][k] at part[j mh + k]
        for (int k = tid; k < mh; k += kThreads) {
          float* pk = part + k;
          const bool first = r == 0;
          float ps_r = first ? 0.f : pk[0], ps_i = first ? 0.f : pk[mh];
          float pmu_r = first ? 0.f : pk[2 * mh], pmu_i = first ? 0.f : pk[3 * mh];
          float pe = first ? 0.f : pk[4 * mh];
          float pd[8];
#pragma unroll
          for (int c = 0; c < 8; ++c) pd[c] = first ? 0.f : pk[(5 + c) * mh];
          const int y = k * lay.np;
          merge_row(y_re + y, y_im + y, rc, cols, nr, nb, f, n_a, phi_a, phi_r, first, ps_r,
                    ps_i, pmu_r, pmu_i, pe, pd);
          pk[0] = ps_r;
          pk[mh] = ps_i;
          pk[2 * mh] = pmu_r;
          pk[3 * mh] = pmu_i;
          pk[4 * mh] = pe;
#pragma unroll
          for (int c = 0; c < 8; ++c) pk[(5 + c) * mh] = pd[c];
        }
      } else {
        // the register body's rows, kRows a thread (merge_row's arithmetic,
        // written out as before the long-ray body: its instantiations stay
        // as they were)
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
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) phi_a[cc] += phi_r[cc];
      n_a = tot;
    }
  }

  if constexpr (kFused && !kLong) {
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
  if constexpr (kFused && kLong) {
    // the same merge on the long body's partials, in place: stat j of row
    // k at part[j mh + k], the block's Phi and n_b after them
    __syncthreads();                            // every row's last round is merged
    float* st = part;
    const int tail = kPart * mh;
    if (tid == 0) {
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) st[tail + cc] = phi_a[cc];
      st[tail + 4] = n_a;
    }
    cluster.sync();

    const int per = (mh + K - 1) / K;
    const float nf = static_cast<float>(n);
    for (int k = rank * per + tid; k < min(mh, (rank + 1) * per); k += kThreads) {
      const float* r0 = cluster.map_shared_rank(st, 0) + k;
      const float o_r = r0[0], o_i = r0[mh];    // block 0's shift: the origin
      float sr = 0.f, si = 0.f;
      for (int b = 0; b < K; ++b) {
        const float* sb = cluster.map_shared_rank(st, b);
        const float* r = sb + k;
        const float nb = sb[tail + 4];
        sr += nb * ((r[0] - o_r) + r[2 * mh]);
        si += nb * ((r[mh] - o_i) + r[3 * mh]);
      }
      const float mr = sr / nf;
      const float mi = si / nf;
      float et = 0.f, dt[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int b = 0; b < K; ++b) {
        const float* sb = cluster.map_shared_rank(st, b);
        const float* r = sb + k;
        const float* phb = sb + tail;
        const float dmr = ((r[0] - o_r) + r[2 * mh]) - mr;
        const float dmi = ((r[mh] - o_i) + r[3 * mh]) - mi;
        et += r[4 * mh] + phb[4] * (dmr * dmr + dmi * dmi);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          dt[cc] += r[(5 + cc) * mh] + dmr * phb[cc];
          dt[4 + cc] += r[(9 + cc) * mh] + dmi * phb[cc];
        }
      }
      float pw = nf * et;
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

// The register body (m <= 1024): two blocks per SM.
template <class Src, int P1, int P2, bool kFused>
__global__ void __launch_bounds__(kThreads, 2)
fft_chain_kernel(Src src, const float* __restrict__ tab, const float* __restrict__ phi,
                 const float* __restrict__ wd, const float* __restrict__ ph,
                 float* __restrict__ out, int m, int L, int n, int cols, float salt) {
  fft_chain_body<Src, P1, P2, kFused, false>(src, tab, phi, wd, ph, out, m, L, n, cols, salt);
}

// The long-ray body (the dense entries' m = 2 x odd in (2048, 4096]): one
// block per SM (its shared memory allows no more), registers unbounded
// below 255.
template <class Src, int P1, int P2, bool kFused>
__global__ void __launch_bounds__(kThreads, 1)
fft_chain_long_kernel(Src src, const float* __restrict__ tab, const float* __restrict__ phi,
                      const float* __restrict__ wd, const float* __restrict__ ph,
                      float* __restrict__ out, int m, int L, int n, int cols, float salt) {
  fft_chain_body<Src, P1, P2, kFused, true>(src, tab, phi, wd, ph, out, m, L, n, cols, salt);
}

// The kernel for the plan's geometry: fn(P1, P2) dispatch over P (P1 =
// min(32, P)).  Radix plans give 16 <= P <= 1024; the planar fused chain
// (the dense entries: every even m) also takes P = 2, 4, 8.
template <class Src, bool kFused, class Fn>
cudaError_t dispatch_p(int P, Fn&& fn) {
  if constexpr (Src::kStaged && kFused) {
    switch (P) {
      case 2: return fn(fft_chain_kernel<Src, 2, 1, kFused>);
      case 4: return fn(fft_chain_kernel<Src, 4, 1, kFused>);
      case 8: return fn(fft_chain_kernel<Src, 8, 1, kFused>);
      default: break;
    }
  }
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

// The long-ray kernel: the dense entries' m = 2 x odd in (2048, 4096]
// (P = 2, an odd L >= 1025); the cluster body serves every other radix-1 m
// it takes.
template <class Src, bool kFused, class Fn>
cudaError_t dispatch_long(int P, Fn&& fn) {
  if constexpr (Src::kStaged && kFused) {
    if (P == 2) return fn(fft_chain_long_kernel<Src, 2, 1, kFused>);
  }
  return cudaErrorInvalidValue;
}

struct Geometry {
  int P, L, P1, P2;
  bool lng;       // the long-ray body
  bool ok;
  Geometry(int m) {
    P = m & -m;
    L = m / imax(P, 1);
    P1 = P < 32 ? P : 32;
    P2 = P / imax(P1, 1);
    lng = m > kMaxM;
    // P >= 2; wire and A-stage: P >= 16; the long-ray body: m = 2 x odd above 2048
    ok = m >= 2 && m % 2 == 0 && (m <= kMaxM || (m >= kLongMinM && m <= kLongMaxM && P == 2));
  }
};

// The smem bytes of a launch of `blocks` blocks per unit.
template <class Src>
size_t smem_bytes(const Src& src, const Geometry& g, int m, int cols, bool fused) {
  return Layout(m, g.L, g.P1, g.P2, cols, fused, src.words(cols), g.lng).bytes();
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

// The dispatch of the register body (kLong = false) or the long-ray body.
template <class Src, bool kFused, bool kLong, class Fn>
cudaError_t dispatch_body(int P, Fn&& fn) {
  if constexpr (kLong) {
    return dispatch_long<Src, kFused>(P, fn);
  } else {
    return dispatch_p<Src, kFused>(P, fn);
  }
}

// The planar long-ray body's entries, defined in fused_chain_radix_long.cu
// (the *_as<true> templates below): the m > 1024 kernels compile there, in
// parallel with the register body's.  The wire chain and the A-stage have
// none: above 1024 they run cluster_chain.cuh.
cudaError_t launch_fused_long(const PlanarIq& src, const float* tab, const float* phi,
                              const float* wd, const float* ph, float* out, int sectors,
                              int channels, int m, int n, int cols, int blocks, float salt,
                              cudaStream_t stream);
cudaError_t occupancy_long(const PlanarIq& src, int m, int cols, int blocks, int* blocks_per_sm,
                           int* clusters);

// The fused chain over units u = sector * channels + channel, clusters of
// `blocks` <= ceil(n / cols) blocks, on `stream` without synchronising,
// through the register body or (kLong) the long-ray body.  The caller
// validates shapes, dtypes and offsets.
template <bool kLong, class Src>
cudaError_t launch_fused_as(const Src& src, const float* tab, const float* phi, const float* wd,
                            const float* ph, float* out, int sectors, int channels, int m,
                            int n, int cols, int blocks, float salt, cudaStream_t stream) {
  const Geometry g(m);
  if (!g.ok || g.lng != kLong || sectors <= 0 || sectors > 65535 || channels <= 0 ||
      channels > 65535 || n <= 0 || cols <= 0 || blocks <= 0 || blocks > kMaxCluster ||
      (blocks - 1) * cols >= n) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(src, g, m, cols, true);
  return dispatch_body<Src, true, kLong>(g.P, [&](auto kernel) {
    return launch_clusters(kernel, smem, blocks, channels, sectors, stream, src, tab, phi, wd,
                           ph, out, m, g.L, n, cols, salt);
  });
}

// m > 1024: the planar long-ray body (the dense entries' m = 2 x odd above
// 2048); every other m above 1024 runs cluster_chain.cuh or the matrix
// kernel (cudaErrorInvalidValue here).
template <class Src>
cudaError_t launch_fused(const Src& src, const float* tab, const float* phi, const float* wd,
                         const float* ph, float* out, int sectors, int channels, int m, int n,
                         int cols, int blocks, float salt, cudaStream_t stream) {
  if (Geometry(m).lng) {
    if constexpr (Src::kStaged) {
      return launch_fused_long(src, tab, phi, wd, ph, out, sectors, channels, m, n, cols, blocks,
                               salt, stream);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  return launch_fused_as<false>(src, tab, phi, wd, ph, out, sectors, channels, m, n, cols,
                                blocks, salt, stream);
}

// The A-stage over `units` units of w pulses: Y [units, 2, m/2, w], on the
// register body (m <= 1024); above, the A-stage runs cluster_chain.cuh
// (cudaErrorInvalidValue here).
template <class Src>
cudaError_t launch_astage(const Src& src, const float* tab, float* y, int units, int m, int w,
                          int cols, int blocks, cudaStream_t stream) {
  const Geometry g(m);
  if (!g.ok || g.lng || units <= 0 || units > 65535 || w <= 0 || cols <= 0 || blocks <= 0 ||
      blocks > kMaxCluster || (blocks - 1) * cols >= w) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(src, g, m, cols, false);
  return dispatch_body<Src, false, false>(g.P, [&](auto kernel) {
    return launch_clusters(kernel, smem, blocks, 1, units, stream, src, tab, nullptr, nullptr,
                           nullptr, y, m, g.L, w, cols, 0.f);
  });
}

// Resident blocks per SM and the clusters of `blocks` blocks the card can
// hold at once (cudaOccupancyMaxActiveClusters), at (m, cols) for the
// source `src` (its staging buffer's size).
template <bool kLong, class Src, bool kFused>
cudaError_t occupancy_as(const Src& src, int m, int cols, int blocks, int* blocks_per_sm,
                         int* clusters) {
  const Geometry g(m);
  if (!g.ok || g.lng != kLong || cols <= 0 || blocks <= 0 || blocks > kMaxCluster) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes(src, g, m, cols, kFused);
  return dispatch_body<Src, kFused, kLong>(g.P, [&](auto kernel) {
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

template <class Src, bool kFused>
cudaError_t occupancy(const Src& src, int m, int cols, int blocks, int* blocks_per_sm,
                      int* clusters) {
  if (Geometry(m).lng) {
    // the dense entries' long-ray body; every other m above 1024 runs
    // cluster_chain.cuh or the matrix kernel
    if constexpr (kFused && Src::kStaged) {
      return occupancy_long(src, m, cols, blocks, blocks_per_sm, clusters);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  return occupancy_as<false, Src, kFused>(src, m, cols, blocks, blocks_per_sm, clusters);
}

}  // namespace fft
}  // namespace wrp
