// The cluster body: rays of 1024 < m <= 16384 range cells, each split
// across a thread-block cluster of S blocks, for NVIDIA Hopper (sm_90a).
// Behind fused_chain_astage_cluster.cu (the pulse-sharded path's A-stage,
// Y stored), fused_chain_radix_cluster.cu (the planar fused chain and its
// offset/salt entry; also the dense entries' radix-1 m) and
// fused_chain_wire_cluster.cu (the wire fused chain and its offset/salt
// entry), the last two with the Parseval epilogue fused.  It replaces, at
// those m, the TPU kernels wrp_tpu/ops/pallas/fullchain.py::
// fused_chain_astage (_kernel_radix_astage), fused_chain_power_radix
// (_kernel_radix, _kernel_radix_offset), fused_chain_power_wire
// (_kernel_radix_wire, _kernel_radix_wire_offset) and fused_chain_power /
// fused_chain_power_at (_kernel, _kernel_offset) at radix-1 m.
//
// Per unit (one channel of one sector) and pulse column j it computes
//
//   Y[k, j] = sum_r W_m^(k r) (w_r c)[r] (x[r, j] + salt (1 + i)),  k < m/2
//
// and, for the planar and wire chains, per row k the Parseval epilogue of
// fft_chain.cuh (Chan's merge of each round's partials, the shift by the
// row's first value), whose algebra ops/fullchain.merged_epilogue_reference
// states in torch.
//
// Why a cluster.  The long-ray form of fft_chain.cuh gave each block every
// range row and a chunk of pulse columns: at m = 4096 a round held one
// column (2-4 bytes of a 32-byte sector a row) and every row's 13 partials
// sat in shared memory, one block per SM.  Here a unit is one cluster of S
// blocks and every block sees every column: block b owns the range rows
// r = S t + b, t < m' = m / S, a round `cols` columns wide, as many as one
// block's shared memory holds (ops/fullchain.cluster_geometry: for the
// fused chains 64 at m = 1536-2048, 32 at 4096-4160 and 8224-9216, 16 at
// 8192, 12288 and 16384), since each round costs two cluster barriers.  S =
// 8 for a radix m (m % 16 == 0) up to 8192; above it S = 16 (a
// non-portable cluster size, m' = m / 16 <= 1024), for all three chains;
// at m = 16 x odd (8208 = 16 x 513) P = 1 there,
// so each block's m'-point DFT is the odd leaf alone, as at a radix-1 m =
// S x odd (S = 2, 4, 8: the dense entries), which splits by the power of
// two it has.
// With r = S t + b and k = k1 + m' k2 (k1 < m', k2 < S):
//
//   Y[k1 + m' k2] = sum_b W_S^(b k2) W_m^(b k1) F_b[k1],
//   F_b[k1] = sum_t W_m'^(t k1) x_w[S t + b],
//
// so a round is
//   1. in each block the m'-point DFT F_b of its rows, in its own shared
//      memory, in place in one buffer A: m' = P L (P the largest power of
//      two dividing m', L odd), a P1-point register DFT over rows
//      L (P2 n1 + n2) + r2, the twiddle W_P^(k1 n2), a P2-point register
//      DFT in place (P1 P2 = P <= 1024, each <= 32), slot k2 of row
//      (r2, k1) holding G_r2[k1 + P1 k2]; then for L > 1 the leaf's twiddle
//      W_m'^(k r2) and the leaf (below) over r2, in the same slots;
//   2. a cluster barrier; block b' takes the k1 of its slice (ceil(m' / S)
//      values) of all S blocks' F over distributed shared memory,
//      multiplies F_b[k1] by W_m^(b k1) and runs the S-point DFT across
//      the blocks for its S / 2 kept outputs k2 < S / 2 only (k < m/2): at
//      S = 8 two 4-point DFTs, exact in +-1, +-i, and W_8^k2 between them;
//      at S = 16 two 8-point DFTs (each two 4-point DFTs joined by W_8)
//      and W_16^k2 between them; at S = 4 two outputs of one, at S = 2 a
//      sum.  A block thus owns the m / 2S rows k1 + m' k2 of its slice
//      through every round;
//   3. the A-stage stores its rows of Y, `cols` contiguous floats a row and
//      plane; the fused chains write them to a local buffer and merge each
//      owned row's round into its Parseval partials, held in registers for
//      the whole unit (kRows rows a thread).  Every column of a row passes
//      through the one block that owns it, so no merge across blocks is
//      left at the end: each block writes its rows' power.
//
// The leaf (an odd L > 1; ops/fullchain.leaf_plan): one in-place
// decimation-in-frequency pass a prime factor of L, ascending.  Pass i of
// radix R and stride Lc (Lp = R Lc) takes, per block of Lp points and
// j < Lc, the points j + r Lc, an R-point DFT, and writes output s times
// W_Lp^(j s) back to j + s Lc; so each pass reads and writes the same
// slots, no second buffer (a round takes as many columns at an odd L as
// at L = 1), and frequency t ends at a mixed-radix digit-reversed
// position, which the combine reads from the plan's perm.  An R <= 31 is
// a register DFT unrolled for R (dft_odd: the H = (R - 1) / 2 sums and
// differences of v_r, v_(R-r), then cosines on the sums and sines on the
// differences: 4 H^2 real FMAs), its H cosines and sines held in
// registers for the pass, its twiddles read from the pass's table at one
// index a butterfly; a prime leaf of 3, 5 or 7 behind a P2-point pass 2
// (m = 1536 = 8 x 64 x 3) runs inside pass 2's registers instead, a task
// holding the L rows of its slot (pass2_leaf): no pass and no barrier of
// its own.  A larger prime p (at most one: L <= 1023 < 37^2;
// the last pass, so it has no twiddle) runs in Bluestein's form: the
// chirped inputs, a cyclic convolution of length N (the power of two >=
// 2p - 1: 512 at p = 229, m = 1832; 1024 at p = 257, m = 4112) with the
// chirp's N-point spectrum from the table, then the chirp: a 32-point and
// an N/32-point register DFT each way (bluestein_pass), `batch` (64 down
// to 4) convolutions at a time in the region the owned rows use after the
// leaf.  A task's indices come from shifts and masks of the power-of-two
// sizes (cols, P, the batch) and the plan's first points; no division and
// no remainder in a pass.
//
// Every twiddle and root comes from the plan's table
// (ops/fullchain.cluster_tables, leaf_tables: fp64 on the host, cast
// once); nothing calls sincosf.
//
// Overlap and barriers.  The A-stage's planar input is staged with
// cp.async (16-byte pieces where rows allow), round r + 1's copy issued
// right after round r's first pass has read the buffer, so it runs under
// the rest of the round; the planar and wire chains read pass 1's samples
// straight from device memory, which leaves their shared memory to a
// round's columns (twice the staged cut).  Two cluster barriers a round,
// the second split: arrive once the block has read its peers' F, wait at
// the start of the next round, whose first pass rewrites F's buffer, so
// the epilogue and the wait for the next round's samples run between
// them.  After the last round a block waits until its peers are done
// reading it before it exits.
//
// What bounds it: bytes.  The A-stage reads 4 m w bytes of int16 and
// writes 4 m w of Y a unit; the planar chain (int16) and the wire chain
// read 4 m n and write 2 m.  The FFT's ~5 m log2 m flops a column, the
// combine's and the epilogue's are ~16 per byte of input, under the fp32
// ridge (67 TFLOP/s over 3.35 TB/s = 20); fp32 on the CUDA cores
// throughout (the port's precision contract).
// The register DFTs hold up to 255 registers a thread
// (__launch_bounds__(256, 1)), so one block a SM, and a round's columns
// fill the shared memory that leaves (ops/fullchain.cluster_smem_bytes);
// the grid is S blocks a unit, clusters of S.  The L = 1 kernels
// (cluster_chain_kernel: m = 2048, 4096, 8192; cluster_chain16_kernel: m
// = 16384) carry no leaf code; every odd L runs cluster_leaf_kernel.  A
// cluster of 16 at one block an SM needs 16 free SMs of one GPC; how many
// the card holds at once is cudaOccupancyMaxActiveClusters' answer
// (`occupancy`).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "fft_chain.cuh"

namespace wrp {
namespace cluster {

namespace cg = cooperative_groups;

constexpr int kSplit = 8;       // a radix m's blocks a unit (one cluster) up to kMaxM8
constexpr int kSplitLong = 16;  // above kMaxM8: a cluster of 16 (a non-portable size)
constexpr int kOut = 4;         // outputs of a 4-point DFT across blocks
constexpr int kRows = 2;        // epilogue rows a thread owns: m / 2S <= 512
constexpr int kMinM = 1025;     // below: the register body (fft_chain.cuh)
constexpr int kMaxM8 = 8192;    // the longest ray split 8 ways
constexpr int kMaxM = 16384;
constexpr int kMaxMs = 1024;    // m' = m / S: P <= 1024, m / 2S <= kRows kThreads
constexpr int kMaxCols = 64;
constexpr int kMaxRadix = 31;   // the leaf's register DFTs: odd primes up to 31
constexpr int kMaxBluestein = 1024;  // Bluestein's N: a 32-point x N/32-point DFT
constexpr int kBluesteinN1 = 32;
constexpr int kMaxBatch = 64;   // Bluestein convolutions a block runs at a time
constexpr int kMinBatch = 4;
constexpr int kMaxWords = 227 * 1024 / 4;   // one block's shared memory

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The 4-point DFT (W_4 = -i, exact) of the blocks h, h + st, h + 2 st,
// h + 3 st: x[k] = sum_j W_4^(j k) g[h + st j].
template <int h, int st, int N>
__device__ __forceinline__ void dft4(const float (&gr)[N], const float (&gi)[N],
                                     float (&xr)[kOut], float (&xi)[kOut]) {
  const float sr = gr[h] + gr[h + 2 * st], si = gi[h] + gi[h + 2 * st];
  const float ar = gr[h] - gr[h + 2 * st], ai = gi[h] - gi[h + 2 * st];
  const float tr = gr[h + st] + gr[h + 3 * st], ti = gi[h + st] + gi[h + 3 * st];
  const float dr = gr[h + st] - gr[h + 3 * st], di = gi[h + st] - gi[h + 3 * st];
  xr[0] = sr + tr;
  xi[0] = si + ti;
  xr[1] = ar + di;                              // a - i d
  xi[1] = ai - dr;
  xr[2] = sr - tr;
  xi[2] = si - ti;
  xr[3] = ar - di;                              // a + i d
  xi[3] = ai + dr;
}

// The 8-point DFT from the 4-point DFTs a (even blocks) and c (odd):
// x[k] = a[k] + W_8^k c[k], x[k + 4] = a[k] - W_8^k c[k] (W_8^2 = -i
// exact; w1, w3: W_8^1, W_8^3).
__device__ __forceinline__ void join8(const float (&ar)[kOut], const float (&ai)[kOut],
                                      const float (&cr)[kOut], const float (&ci)[kOut],
                                      float2 w1, float2 w3, float (&xr)[8], float (&xi)[8]) {
  float vr[kOut], vi[kOut];
  vr[0] = cr[0];
  vi[0] = ci[0];
  fft::cmul(cr[1], ci[1], w1.x, w1.y, vr[1], vi[1]);
  vr[2] = ci[2];                                // -i c
  vi[2] = -cr[2];
  fft::cmul(cr[3], ci[3], w3.x, w3.y, vr[3], vi[3]);
#pragma unroll
  for (int k = 0; k < kOut; ++k) {
    xr[k] = ar[k] + vr[k];
    xi[k] = ai[k] + vi[k];
    xr[k + kOut] = ar[k] - vr[k];
    xi[k + kOut] = ai[k] - vi[k];
  }
}

// Planar IQ x [units, 2, m, n], int16 or float (a uniform runtime switch):
// the block stages its rows r = S t + b of both planes, `cols` columns a
// round, as [plane][t][cols] in shared memory.
struct PlanarRows {
  static constexpr bool kStaged = true;
  const void* x;
  int is_int16;
  int m, n;

  __host__ __device__ int elem() const { return is_int16 ? 2 : 4; }
  // the staging buffer at S blocks a unit in 32-bit words (a multiple of
  // 4: m' is even)
  __host__ __device__ int words(int cols, int S) const {
    return 2 * (m / S) * cols * elem() / 4;
  }

  template <int S, int B>
  __device__ __forceinline__ void stage_pieces(char* buf, size_t unit, int b, int j0, int nr,
                                               int cols) const {
    const int e = elem();
    const int ms = m / S;
    const int per_row = cols * e / B;           // a power of two
    const int piece = static_cast<int>(threadIdx.x) % per_row;
    const int col = piece * B / e;
    const int valid = max(0, min(B, (nr - col) * e));
    const int rstep = kThreads / per_row;
    const char* base = static_cast<const char*>(x) + (unit + j0 + (valid ? col : 0)) * e;
    for (int row = static_cast<int>(threadIdx.x) / per_row; row < 2 * ms; row += rstep) {
      const int plane = row >= ms;
      const int t = row - plane * ms;
      const size_t src = static_cast<size_t>(plane * m + S * t + b) * n;
      fft::cp_async<B>(buf + (static_cast<size_t>(row) * cols + col) * e, base + src * e, valid);
    }
  }

  // rows S t + b (t < m'), columns [j0, j0 + cols) of unit u; zeros past n
  template <int S>
  __device__ __forceinline__ void stage(void* buf, int u, int b, int j0, int cols) const {
    const int e = elem();
    const int ms = m / S;
    const int nr = min(cols, n - j0);
    const size_t unit = static_cast<size_t>(u) * 2 * m * n;
    char* bb = static_cast<char*>(buf);
    const uintptr_t at = reinterpret_cast<uintptr_t>(x);
    if ((cols * e) % 16 == 0 && (n * e) % 16 == 0 && at % 16 == 0) {
      stage_pieces<S, 16>(bb, unit, b, j0, nr, cols);
    } else if ((cols * e) % 8 == 0 && (n * e) % 8 == 0 && at % 8 == 0) {
      stage_pieces<S, 8>(bb, unit, b, j0, nr, cols);
    } else if ((cols * e) % 4 == 0 && (n * e) % 4 == 0 && at % 4 == 0) {
      stage_pieces<S, 4>(bb, unit, b, j0, nr, cols);
    } else {
      // rows too narrow or not aligned: element by element through registers
      for (int k = threadIdx.x; k < 2 * ms * cols; k += kThreads) {
        const int row = k / cols;
        const int c = k - row * cols;
        const int plane = row >= ms;
        const int t = row - plane * ms;
        const size_t src = unit + static_cast<size_t>(plane * m + S * t + b) * n + j0 + c;
        if (is_int16) {
          reinterpret_cast<int16_t*>(bb)[k] =
              c < nr ? __ldg(static_cast<const int16_t*>(x) + src) : static_cast<int16_t>(0);
        } else {
          reinterpret_cast<float*>(bb)[k] = c < nr ? __ldg(static_cast<const float*>(x) + src) : 0.f;
        }
      }
    }
  }

  // staged rows t0 + i step (i < N) of column c
  template <int S, int N>
  __device__ __forceinline__ void read(const void* buf, int t0, int step, int c, int cols,
                                       float (&re)[N], float (&im)[N]) const {
    const int plane = (m / S) * cols;
    if (is_int16) {
      const auto* p = static_cast<const int16_t*>(buf) + t0 * cols + c;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        re[i] = static_cast<float>(p[i * step * cols]);
        im[i] = static_cast<float>(p[i * step * cols + plane]);
      }
    } else {
      const auto* p = static_cast<const float*>(buf) + t0 * cols + c;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        re[i] = p[i * step * cols];
        im[i] = p[i * step * cols + plane];
      }
    }
  }
};

// Planar IQ x [units, 2, m, n], int16 or float (a uniform runtime switch),
// read straight from device memory in pass 1 (the planar fused chain):
// rows row0 + i step of column j, both planes.  A task's 2 N loads have no
// control flow between them, so all are in flight at once, and pass 1's
// tasks run column fastest, so a warp reads min(cols, 32) adjacent samples
// of a row: whole 32-byte sectors.  No staging buffer, so a round takes the
// wire chain's columns (ops/fullchain.cluster_geometry with elem 0).
struct PlanarDirect {
  static constexpr bool kStaged = false;
  const void* x;
  int is_int16;
  int m, n;

  template <int N>
  __device__ __forceinline__ void load(int u, int row0, int step, int j, float (&re)[N],
                                       float (&im)[N]) const {
    const size_t at = (static_cast<size_t>(u) * 2 * m + row0) * n + j;
    const size_t plane = static_cast<size_t>(m) * n;
    const size_t stride = static_cast<size_t>(step) * n;
    if (is_int16) {
      const int16_t* p = static_cast<const int16_t*>(x) + at;
      int16_t vr[N], vi[N];
#pragma unroll
      for (int i = 0; i < N; ++i) {
        vr[i] = __ldg(p + i * stride);
        vi[i] = __ldg(p + plane + i * stride);
      }
#pragma unroll
      for (int i = 0; i < N; ++i) {
        re[i] = static_cast<float>(vr[i]);
        im[i] = static_cast<float>(vi[i]);
      }
    } else {
      const float* p = static_cast<const float*>(x) + at;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        re[i] = __ldg(p + i * stride);
        im[i] = __ldg(p + plane + i * stride);
      }
    }
  }
};


// The words of a source's staging buffer at S blocks a unit (0: the
// source reads device memory in pass 1).
template <class Src>
__host__ __device__ int stage_words(const Src& src, int cols, int S) {
  if constexpr (Src::kStaged) {
    return src.words(cols, S);
  } else {
    return 0;
  }
}

// The plan's table (ops/fullchain.cluster_tables): w_r c [m]; W_P^t (re,
// im) for t < P; the leaf's W_m'^(k r2) at (r2 P + k); the cluster's
// W_m^(b k1) at (b m' + k1); W_S^t, t < S; for L > 1 the leaf's plan
// (ops/fullchain.leaf_tables), int32 words: npass, perm's offset, then per
// pass R, Lc, nq = L / R and its data's offset, each from the plan's start.
struct Table {
  const float* win;
  const float* tw;
  const float2* leaf_tw;
  const float2* ctw;
  const float2* ws;
  const int* plan;

  __host__ __device__ Table(const float* t, int m, int ms, int P, int L, int S)
      : win(t),
        tw(t + m),
        leaf_tw(reinterpret_cast<const float2*>(t + m + 2 * P)),
        ctw(reinterpret_cast<const float2*>(t + m + 2 * P + 2 * L * P)),
        ws(reinterpret_cast<const float2*>(t + m + 2 * P + 2 * L * P + 2 * S * ms)),
        plan(reinterpret_cast<const int*>(t + m + 2 * P + 2 * L * P + 2 * S * ms + 2 * S)) {}
};

// Shared memory of one block, in 32-bit words, each part a multiple of 16
// bytes: A (pass 1's slots [r2][k1][n2][column], rows padded where pass 2
// reads them at cols < 32; pass 2 and every leaf pass run in place, so F
// stays there: G_r2[k1 + P1 k2] in slot k2 of row (r2, k1), frequency
// t of the leaf at row perm[t] of its sub-transform), the staged samples
// S, then one region X: the fused chains' owned rows [S/2 span][cols + 1]
// after the leaf, a Bluestein leaf's `batch` convolutions [N][batch]
// during it (the largest power of two from 64 down to 4 that fits); then
// for the fused chains
// the round's epilogue constants (wd, 4 phasor rows).
// ops/fullchain._cluster_layout is the same arithmetic.
struct Layout {
  int sp;         // slot row pitch: P2 cols + pad
  int np;         // the owned rows' pitch: cols + 1
  int span;       // k1 a block combines: ceil(m' / S)
  int size_a;     // complex values
  int stage;      // words of S
  int own;        // complex values of the owned rows
  int batch;      // Bluestein convolutions at a time (0: none)
  int xw;         // words of X
  int words;

  __host__ __device__ Layout(int ms, int L, int P1, int P2, int S, int cols, bool fused,
                             int stage_words, int nbl) {
    const int pad = cols < 32 && P2 > 1 ? cols : 0;
    sp = P2 * cols + pad;
    np = cols + 1;
    span = (ms + S - 1) / S;
    size_a = fft::round4(L * P1 * sp);
    stage = fft::round4(stage_words);
    own = fused ? fft::round4(S / 2 * span * np) : 0;
    const int base = 2 * size_a + stage + (fused ? fft::round4(5 * cols) : 0);
    batch = 0;
    if (nbl > 0) {
      for (int g = kMaxBatch; g >= kMinBatch; g /= 2) {
        if (base + fft::imax(2 * own, 2 * g * nbl) <= kMaxWords) {
          batch = g;
          break;
        }
      }
    }
    xw = fft::imax(2 * own, 2 * batch * nbl);
    words = base + xw;
  }
  __host__ __device__ size_t bytes() const { return static_cast<size_t>(words) * sizeof(float); }
};

__host__ __device__ constexpr int cmod(int a, int b) { return a - b * (a / b); }

// Where sub-transform k's point 0 lies in A: slot row k1 = k mod P1, slot
// k2 = k / P1 of row r2 = 0 (P, P1 powers of two).
template <int P1>
__device__ __forceinline__ int slot(int k, int sp, int cols) {
  return (k & (P1 - 1)) * sp + (k >> fft::log2i<P1>()) * cols;
}

// The first point of butterfly d of a pass in A: d = c + cols (k + P jj),
// the column c, the sub-transform k, and jj, which the pass's first points
// `pos` map to a position (P, cols powers of two; lc = log2 cols).
template <int P, int P1>
__device__ __forceinline__ int first_point(int d, const int* pos, int sp, int cols, int lc) {
  const int q = d >> lc;
  const int k = q & (P - 1);
  return slot<P1>(k, sp, cols) + __ldg(pos + (q >> fft::log2i<P>())) * (P1 * sp) +
         (d & (cols - 1));
}

// The R-point DFT (R an odd prime) of x in registers, natural order in
// and out: a_r = x_r + x_(R-r), b_r = x_r - x_(R-r) (r = 1..H), X_0 = x_0
// + sum a_r, and for s = 1..H, C = x_0 + sum a_r cos(2 pi r s / R), T =
// sum b_r sin(2 pi r s / R): X_s = C - i T, X_(R-s) = C + i T.  cs, sn:
// cos and sin (2 pi t / R), t = 1..H, at t - 1; r s folds to one of them
// at compile time.
template <int R>
__device__ __forceinline__ void dft_odd(float (&xr)[R], float (&xi)[R], const float (&cs)[(R - 1) / 2],
                                        const float (&sn)[(R - 1) / 2]) {
  constexpr int H = (R - 1) / 2;
  float ar[H], ai[H], br[H], bi[H];
  const float x0r = xr[0], x0i = xi[0];
  float s0r = x0r, s0i = x0i;
#pragma unroll
  for (int r = 1; r <= H; ++r) {
    ar[r - 1] = xr[r] + xr[R - r];
    ai[r - 1] = xi[r] + xi[R - r];
    br[r - 1] = xr[r] - xr[R - r];
    bi[r - 1] = xi[r] - xi[R - r];
    s0r += ar[r - 1];
    s0i += ai[r - 1];
  }
  xr[0] = s0r;
  xi[0] = s0i;
#pragma unroll
  for (int s = 1; s <= H; ++s) {
    float cr = x0r, ci = x0i, tr = 0.f, ti = 0.f;
#pragma unroll
    for (int r = 1; r <= H; ++r) {
      const int e = cmod(r * s, R);
      const int f = (e <= H ? e : R - e) - 1;
      const float c = cs[f];
      const float sg = e <= H ? sn[f] : -sn[f];
      cr += ar[r - 1] * c;
      ci += ai[r - 1] * c;
      tr += br[r - 1] * sg;
      ti += bi[r - 1] * sg;
    }
    xr[s] = cr + ti;
    xi[s] = ci - tr;
    xr[R - s] = cr - ti;
    xi[R - s] = ci + tr;
  }
}

// A leaf pass of radix R <= 31 on A (im at re + fim): per butterfly d
// (nq P cols of them) the points first + r Lc lstride, dft_odd, output s
// times W_Lp^(j s) (Lc > 1: the table's twiddles at [jj][s - 1]) back to
// first + s Lc lstride.  Its data: pos [nq] ints (padded to even), then
// (cos, sin) of t = 1..H, then the twiddles.
template <int R, int P, int P1>
__device__ __forceinline__ void radix_pass(float* re, int fim, const int* pd, int Lc, int nq,
                                           int sp, int cols, int lc) {
  constexpr int H = (R - 1) / 2;
  const auto* roots = reinterpret_cast<const float2*>(pd + nq + (nq & 1));
  const float2* tw = roots + H;
  float cs[H], sn[H];
#pragma unroll
  for (int t = 0; t < H; ++t) {
    const float2 w = __ldg(roots + t);
    cs[t] = w.x;
    sn[t] = w.y;
  }
  const int step = Lc * P1 * sp;
  const int tasks = (nq * P) << lc;
  for (int d = static_cast<int>(threadIdx.x); d < tasks; d += kThreads) {
    float* pr = re + first_point<P, P1>(d, pd, sp, cols, lc);
    float xr[R], xi[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      xr[r] = pr[r * step];
      xi[r] = pr[r * step + fim];
    }
    dft_odd<R>(xr, xi, cs, sn);
    if (Lc > 1) {
      const float2* w = tw + ((d >> lc) >> fft::log2i<P>()) * (R - 1);
#pragma unroll
      for (int s = 1; s < R; ++s) {
        const float2 v = __ldg(w + s - 1);
        fft::cmul(xr[s], xi[s], v.x, v.y, xr[s], xi[s]);
      }
    }
#pragma unroll
    for (int s = 0; s < R; ++s) {
      pr[s * step] = xr[s];
      pr[s * step + fim] = xi[s];
    }
  }
}

// One radix-2 decimation-in-frequency stage of span H over an N-point
// register array (N <= 32), then the next: output in bit-reversed order,
// W_N^k = w[k 32 / N] from the 16 roots W_32^t held in registers (W^0 and
// W^(N/4) = -i exactly).
template <int N, int H>
__device__ __forceinline__ void dif_w32(float (&re)[N], float (&im)[N], const float2 (&w)[16]) {
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
        const int k = j * (N / (2 * H));
        if (k == 0) {
          re[b] = tr;
          im[b] = ti;
        } else if (4 * k == N) {
          re[b] = ti;
          im[b] = -tr;
        } else {
          const float2 v = w[k * (32 / N)];
          fft::cmul(tr, ti, v.x, v.y, re[b], im[b]);
        }
      }
    }
    dif_w32<N, H / 2>(re, im, w);
  }
}

// The leaf's Bluestein pass (a prime p > 31, the last pass: Lc = 1, so
// butterfly d's points are first + t lstride, t < p, and no twiddle):
//   X_t = c_t sum_u (x_u c_u) conj(c_(t-u)),  c_t = exp(-i pi t^2 / p),
// the sum a cyclic convolution of length N = 32 N2 >= 2p - 1, by `batch`
// butterflies at a time in X ([k1 N2 + n2][batch], re then im):
//   1. per (butterfly, n2): the chirped inputs t = N2 n1 + n2 (zero past
//      p), a 32-point DFT over n1, times W_N^(k1 n2);
//   2. per (butterfly, k1): an N2-point DFT over n2 (A[k1 + 32 k2]), times
//      the filter's spectrum (its 1/N folded in), conjugated, an N2-point
//      DFT over k2, times W_N^(k1 n2): in place;
//   3. per (butterfly, n2): a 32-point DFT over k1, conjugated (the
//      inverse transform's), times the chirp: X_t, t = n2 + N2 n1 < p,
//      back to the butterfly's points.
// Its data: pos [nq] ints (padded to even), the chirp [p], the spectrum
// [N], W_N^(k1 n2) at [n2][k1], W_32^t (t < 32; the first 16 held in
// registers).
template <int N, int P, int P1>
__device__ __forceinline__ void bluestein_pass(float* re, int fim, const int* pd, int p, int nq,
                                               int sp, int cols, int lc, float* xre, int batch) {
  constexpr int N1 = kBluesteinN1;
  constexpr int N2 = N / N1;
  const auto* chirp = reinterpret_cast<const float2*>(pd + nq + (nq & 1));
  const float2* bh = chirp + p;
  const float2* ftw = bh + N;
  const float2* r32 = ftw + N;
  float2 w[16];
#pragma unroll
  for (int t = 0; t < 16; ++t) w[t] = __ldg(r32 + t);
  float* xim = xre + batch * N;
  const int lgb = __ffs(batch) - 1;
  const int lstride = P1 * sp;
  const int nd = (nq * P) << lc;
  const int tid = static_cast<int>(threadIdx.x);
  for (int d0 = 0; d0 < nd; d0 += batch) {
    for (int task = tid; task < batch * N2; task += kThreads) {
      const int g = task & (batch - 1);
      const int n2 = task >> lgb;
      float vr[N1], vi[N1];
      const bool live = d0 + g < nd;
      const float* pr = live ? re + first_point<P, P1>(d0 + g, pd, sp, cols, lc) : re;
#pragma unroll
      for (int n1 = 0; n1 < N1; ++n1) {
        const int t = N2 * n1 + n2;
        vr[n1] = vi[n1] = 0.f;
        if (t < p && live) {
          const float2 c = __ldg(chirp + t);
          fft::cmul(pr[t * lstride], pr[t * lstride + fim], c.x, c.y, vr[n1], vi[n1]);
        }
      }
      dif_w32<N1, N1 / 2>(vr, vi, w);
#pragma unroll
      for (int k1 = 0; k1 < N1; ++k1) {
        float ur = vr[fft::brev(k1, fft::log2i<N1>())];
        float ui = vi[fft::brev(k1, fft::log2i<N1>())];
        if (k1 > 0 && n2 > 0) {
          const float2 v = __ldg(ftw + n2 * N1 + k1);
          fft::cmul(ur, ui, v.x, v.y, ur, ui);
        }
        xre[(k1 * N2 + n2) * batch + g] = ur;
        xim[(k1 * N2 + n2) * batch + g] = ui;
      }
    }
    __syncthreads();
    for (int task = tid; task < batch * N1; task += kThreads) {
      const int g = task & (batch - 1);
      const int k1 = task >> lgb;
      float yr[N2], yi[N2], zr[N2], zi[N2];
#pragma unroll
      for (int n2 = 0; n2 < N2; ++n2) {
        yr[n2] = xre[(k1 * N2 + n2) * batch + g];
        yi[n2] = xim[(k1 * N2 + n2) * batch + g];
      }
      dif_w32<N2, N2 / 2>(yr, yi, w);
#pragma unroll
      for (int k2 = 0; k2 < N2; ++k2) {
        const float2 b = __ldg(bh + k1 + N1 * k2);
        float vr, vi;
        fft::cmul(yr[fft::brev(k2, fft::log2i<N2>())], yi[fft::brev(k2, fft::log2i<N2>())], b.x,
                  b.y, vr, vi);
        zr[k2] = vr;
        zi[k2] = -vi;
      }
      dif_w32<N2, N2 / 2>(zr, zi, w);
#pragma unroll
      for (int n2 = 0; n2 < N2; ++n2) {
        float ur = zr[fft::brev(n2, fft::log2i<N2>())];
        float ui = zi[fft::brev(n2, fft::log2i<N2>())];
        if (k1 > 0 && n2 > 0) {
          const float2 v = __ldg(ftw + n2 * N1 + k1);
          fft::cmul(ur, ui, v.x, v.y, ur, ui);
        }
        xre[(k1 * N2 + n2) * batch + g] = ur;
        xim[(k1 * N2 + n2) * batch + g] = ui;
      }
    }
    __syncthreads();
    for (int task = tid; task < batch * N2; task += kThreads) {
      const int g = task & (batch - 1);
      const int n2 = task >> lgb;
      float vr[N1], vi[N1];
#pragma unroll
      for (int k1 = 0; k1 < N1; ++k1) {
        vr[k1] = xre[(k1 * N2 + n2) * batch + g];
        vi[k1] = xim[(k1 * N2 + n2) * batch + g];
      }
      dif_w32<N1, N1 / 2>(vr, vi, w);
      if (d0 + g < nd) {
        float* pr = re + first_point<P, P1>(d0 + g, pd, sp, cols, lc);
#pragma unroll
        for (int n1 = 0; n1 < N1; ++n1) {
          const int t = n2 + N2 * n1;
          if (t < p) {
            const float2 c = __ldg(chirp + t);
            const int at = fft::brev(n1, fft::log2i<N1>());
            fft::cmul(vr[at], -vi[at], c.x, c.y, pr[t * lstride], pr[t * lstride + fim]);
          }
        }
      }
    }
    __syncthreads();
  }
}

// Which leaf passes an instantiation of P needs: a radix R <= L <= m' / P;
// a Bluestein prime p >= N / 4 + 1 likewise.
template <int R, int P>
constexpr bool kRadixFits = R * P <= kMaxMs;
template <int N, int P>
constexpr bool kBluesteinFits = (N / 4 + 1) * P <= kMaxMs;

template <int R, int P, int P1>
__device__ __forceinline__ void radix_case(float* re, int fim, const int* pd, int Lc, int nq,
                                           int sp, int cols, int lc) {
  if constexpr (kRadixFits<R, P>) radix_pass<R, P, P1>(re, fim, pd, Lc, nq, sp, cols, lc);
}

template <int N, int P, int P1>
__device__ __forceinline__ void bluestein_case(float* re, int fim, const int* pd, int p, int nq,
                                               int sp, int cols, int lc, float* x, int batch) {
  if constexpr (kBluesteinFits<N, P>) {
    bluestein_pass<N, P, P1>(re, fim, pd, p, nq, sp, cols, lc, x, batch);
  }
}

// Pass 2 with a prime leaf R <= 7 (L = R, one pass) in registers: a task
// (k1, column) holds the R rows r2 of its slots, each row's P2-point DFT
// times the leaf's twiddle W_m'^(k r2), then per k2 the R-point DFT across
// them, written back to the same slots (one pass leaves frequency t at
// position t).  Returns false where P cannot carry such a leaf.
template <int R, int P1, int P2>
__device__ __forceinline__ bool pass2_leaf(float* re, int fim, int sp, int cols, int lc,
                                           const float* tw, const float2* leaf_tw,
                                           const int* plan) {
  constexpr int P = P1 * P2;
  if constexpr (kRadixFits<R, P>) {
    constexpr int H = (R - 1) / 2;
    // the one pass's data: pos [1] (padded to 2 words), then its roots
    const auto* roots = reinterpret_cast<const float2*>(plan + __ldg(plan + 5) + 2);
    float cs[H], sn[H];
#pragma unroll
    for (int t = 0; t < H; ++t) {
      const float2 w = __ldg(roots + t);
      cs[t] = w.x;
      sn[t] = w.y;
    }
    for (int task = static_cast<int>(threadIdx.x); task < cols * P1; task += kThreads) {
      const int c = task & (cols - 1);
      const int k1 = task >> lc;
      float gr[P2][R], gi[P2][R];
#pragma unroll
      for (int r2 = 0; r2 < R; ++r2) {
        const float* pr = re + (r2 * P1 + k1) * sp + c;
        float xr[P2], xi[P2];
#pragma unroll
        for (int n2 = 0; n2 < P2; ++n2) {
          xr[n2] = pr[n2 * cols];
          xi[n2] = pr[n2 * cols + fim];
        }
        fft::dft_reg<P2>(xr, xi, tw, P);
#pragma unroll
        for (int k2 = 0; k2 < P2; ++k2) {
          const float2 w = __ldg(leaf_tw + r2 * P + k1 + P1 * k2);
          fft::cmul(xr[fft::brev(k2, fft::log2i<P2>())], xi[fft::brev(k2, fft::log2i<P2>())],
                    w.x, w.y, gr[k2][r2], gi[k2][r2]);
        }
      }
#pragma unroll
      for (int k2 = 0; k2 < P2; ++k2) {
        dft_odd<R>(gr[k2], gi[k2], cs, sn);
#pragma unroll
        for (int t = 0; t < R; ++t) {
          re[(t * P1 + k1) * sp + k2 * cols + c] = gr[k2][t];
          re[(t * P1 + k1) * sp + k2 * cols + c + fim] = gi[k2][t];
        }
      }
    }
    return true;
  } else {
    return false;
  }
}

// The leaf: the plan's passes in order, a barrier after each (a pass reads
// points the last one wrote in other threads).  nbl: Bluestein's N (0:
// none); x, batch: its region and butterflies at a time.
template <int P, int P1>
__device__ __forceinline__ void leaf(float* re, int fim, const int* plan, int sp, int cols,
                                     int lc, float* x, int batch, int nbl) {
  const int npass = __ldg(plan);
  for (int i = 0; i < npass; ++i) {
    const int* e = plan + 2 + 4 * i;
    const int R = __ldg(e);
    const int Lc = __ldg(e + 1);
    const int nq = __ldg(e + 2);
    const int* pd = plan + __ldg(e + 3);
    switch (R) {
      case 3: radix_case<3, P, P1>(re, fim, pd, Lc, nq, sp, cols, lc); break;
      case 5: radix_case<5, P, P1>(re, fim, pd, Lc, nq, sp, cols, lc); break;
      case 7: radix_case<7, P, P1>(re, fim, pd, Lc, nq, sp, cols, lc); break;
      case 11: radix_case<11, P, P1>(re, fim, pd, Lc, nq, sp, cols, lc); break;
      case 13: radix_case<13, P, P1>(re, fim, pd, Lc, nq, sp, cols, lc); break;
      case 17: radix_case<17, P, P1>(re, fim, pd, Lc, nq, sp, cols, lc); break;
      case 19: radix_case<19, P, P1>(re, fim, pd, Lc, nq, sp, cols, lc); break;
      case 23: radix_case<23, P, P1>(re, fim, pd, Lc, nq, sp, cols, lc); break;
      case 29: radix_case<29, P, P1>(re, fim, pd, Lc, nq, sp, cols, lc); break;
      case 31: radix_case<31, P, P1>(re, fim, pd, Lc, nq, sp, cols, lc); break;
      default:
        switch (nbl) {
          case 128: bluestein_case<128, P, P1>(re, fim, pd, R, nq, sp, cols, lc, x, batch); break;
          case 256: bluestein_case<256, P, P1>(re, fim, pd, R, nq, sp, cols, lc, x, batch); break;
          case 512: bluestein_case<512, P, P1>(re, fim, pd, R, nq, sp, cols, lc, x, batch); break;
          case 1024: bluestein_case<1024, P, P1>(re, fim, pd, R, nq, sp, cols, lc, x, batch); break;
          default: break;
        }
    }
    __syncthreads();
  }
}

// The body.  Src: PlanarRows (the A-stage), PlanarDirect (the planar chain)
// or fft::WireIq (the wire chain).  Grid (S, channels, sectors), clusters
// of S along x: unit u = sector * channels + channel, block rank b =
// blockIdx.x.  kFused: out = pow [units, m/2] (the planar and wire chains);
// else out = Y [units, 2, m/2, n] (the A-stage) and wd, ph, phi are unused.
// kOdd: L > 1, the leaf; nbl its Bluestein N (0: none).
template <class Src, int S, int P1, int P2, bool kFused, bool kOdd>
__device__ __forceinline__ void cluster_body(Src src, const float* __restrict__ tab,
                                             const float* __restrict__ phi,
                                             const float* __restrict__ wd,
                                             const float* __restrict__ ph,
                                             float* __restrict__ out, int m, int L, int n,
                                             int cols, float salt, int nbl) {
  constexpr int P = P1 * P2;
  constexpr int Q = P2;                          // pass 1's n2 < Q
  constexpr int kKeep = S / 2;                   // outputs k2 of the S-point DFT kept
  const int ms = m / S;
  const int mh = m / 2;
  const int u = static_cast<int>(blockIdx.z * gridDim.y + blockIdx.y);
  const int b = static_cast<int>(blockIdx.x);    // rank in the unit's cluster
  const int tid = static_cast<int>(threadIdx.x);
  const Table t(tab, m, ms, P, L, S);
  const Layout lay(ms, L, P1, P2, S, cols, kFused, stage_words(src, cols, S), kOdd ? nbl : 0);
  cg::cluster_group cluster = cg::this_cluster();

  extern __shared__ __align__(16) float smem[];
  float* a_re = smem;
  float* a_im = a_re + lay.size_a;
  float* stage = a_im + lay.size_a;
  float* o_re = stage + lay.stage;               // X: kFused, the owned rows [kKeep span][np]
  float* o_im = o_re + lay.own;
  float* rc = o_re + lay.xw;                     // kFused: [5][cols]: wd, ph rows

  const int lo = b * lay.span;                   // this block's k1 slice
  const int cnt = min(ms, lo + lay.span) - lo;
  float2 w8_1 = {0.f, 0.f}, w8_3 = {0.f, 0.f};
  float2 w16[8];                                 // S = 16: W_16^k, k < 8
  if constexpr (S == 8) {
    w8_1 = __ldg(t.ws + 1);                      // W_8^1
    w8_3 = __ldg(t.ws + 3);                      // W_8^3
  } else if constexpr (S == 16) {
#pragma unroll
    for (int k = 0; k < 8; ++k) w16[k] = __ldg(t.ws + k);
  }

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
    src.template stage<S>(stage, u, b, 0, cols);
    fft::cp_async_commit();
  }
  for (int r = 0; r * cols < n; ++r) {
    const int j0 = r * cols;
    const int nr = min(cols, n - j0);            // valid columns of this round
    if constexpr (Src::kStaged) fft::cp_async_wait_all();
    __syncthreads();                             // the round is staged
    if (r > 0) cluster_wait();                   // peers have read F of round r - 1
    if constexpr (kFused) {
      for (int k = tid; k < 5 * nr; k += kThreads) {
        const int row = k / nr;
        const int c = k - row * nr;
        rc[row * cols + c] = row == 0 ? __ldg(wd + j0 + c) : __ldg(ph + (row - 1) * n + j0 + c);
      }
    }

    // pass 1: samples, salt, window; P1-point DFT over the rows
    // t = L (Q n1 + n2) + r2 (global rows S t + b); twiddle W_P^(k1 n2), or
    // for P2 = 1 and an odd L the leaf's W_m'^(k1 r2)
    if constexpr (kOdd && P1 < 8) {
      // P1 < 8 (so Q = 1): a task holds only 2 P1 loads, too few in flight,
      // so a thread takes kBatch tasks at once, every load issued first
      constexpr int kBatch = 8 / P1;
      const int ntask = cols * L;                // task (r2, c)
      const int lc = __ffs(cols) - 1;
      for (int t0 = tid; t0 < ntask; t0 += kBatch * kThreads) {
        float re[kBatch][P1], im[kBatch][P1], w[kBatch][P1];
#pragma unroll
        for (int v = 0; v < kBatch; ++v) {
          const int task = min(t0 + v * kThreads, ntask - 1);   // past the end: not stored
          const int c = task & (cols - 1);
          const int r2 = task >> lc;
          if constexpr (Src::kStaged) {
            src.template read<S, P1>(stage, r2, L, c, cols, re[v], im[v]);
          } else {
            src.template load<P1>(u, S * r2 + b, S * L, c < nr ? j0 + c : j0, re[v], im[v]);
          }
#pragma unroll
          for (int n1 = 0; n1 < P1; ++n1) {
            w[v][n1] = c < nr ? __ldg(t.win + S * (r2 + n1 * L) + b) : 0.f;
          }
        }
#pragma unroll
        for (int v = 0; v < kBatch; ++v) {
          const int task = t0 + v * kThreads;
          if (task < ntask) {
            const int c = task & (cols - 1);
            const int r2 = task >> lc;
#pragma unroll
            for (int n1 = 0; n1 < P1; ++n1) {
              re[v][n1] = w[v][n1] * (re[v][n1] + salt);
              im[v][n1] = w[v][n1] * (im[v][n1] + salt);
            }
            fft::dft_reg<P1>(re[v], im[v], t.tw, P);
#pragma unroll
            for (int k1 = 0; k1 < P1; ++k1) {
              float vr = re[v][fft::brev(k1, fft::log2i<P1>())];
              float vi = im[v][fft::brev(k1, fft::log2i<P1>())];
              if (k1 > 0) {                       // G_r2[k1] is final: the leaf's twiddle
                const float2 tw = __ldg(t.leaf_tw + r2 * P + k1);
                fft::cmul(vr, vi, tw.x, tw.y, vr, vi);
              }
              a_re[(r2 * P1 + k1) * lay.sp + c] = vr;
              a_im[(r2 * P1 + k1) * lay.sp + c] = vi;
            }
          }
        }
      }
    } else {
      for (int task = tid; task < cols * Q * L; task += kThreads) {
        const int c = task % cols;
        const int rest = task / cols;
        const int n2 = rest % Q;
        const int r2 = rest / Q;
        const int t0 = L * n2 + r2;
        const int tstep = L * Q;
        // a column past n reads column j0 and is zeroed by its window
        const float keep = c < nr ? 1.f : 0.f;
        float re[P1], im[P1];
        if constexpr (Src::kStaged) {
          src.template read<S, P1>(stage, t0, tstep, c, cols, re, im);
        } else {
          src.template load<P1>(u, S * t0 + b, S * tstep, c < nr ? j0 + c : j0, re, im);
        }
#pragma unroll
        for (int n1 = 0; n1 < P1; ++n1) {
          const float w = __ldg(t.win + S * (t0 + n1 * tstep) + b) * keep;
          re[n1] = w * (re[n1] + salt);
          im[n1] = w * (im[n1] + salt);
        }
        fft::dft_reg<P1>(re, im, t.tw, P);
#pragma unroll
        for (int k1 = 0; k1 < P1; ++k1) {
          float vr = re[fft::brev(k1, fft::log2i<P1>())];
          float vi = im[fft::brev(k1, fft::log2i<P1>())];
          if constexpr (kOdd && Q == 1) {
            if (k1 > 0) {                           // G_r2[k1] is final: the leaf's twiddle
              const float2 w = __ldg(t.leaf_tw + r2 * P + k1);
              fft::cmul(vr, vi, w.x, w.y, vr, vi);
            }
          } else if (Q > 1 && k1 > 0) {            // W^0 = 1 exactly at n2 = 0: no branch
            const float2 w = __ldg(reinterpret_cast<const float2*>(t.tw) + (k1 * n2) % P);
            fft::cmul(vr, vi, w.x, w.y, vr, vi);
          }
          a_re[(r2 * P1 + k1) * lay.sp + n2 * cols + c] = vr;
          a_im[(r2 * P1 + k1) * lay.sp + n2 * cols + c] = vi;
        }
      }
    }
    __syncthreads();                             // A holds pass 1; S is free
    if constexpr (Src::kStaged) {
      if (j0 + cols < n) src.template stage<S>(stage, u, b, j0 + cols, cols);   // under the round
      fft::cp_async_commit();
    }

    bool leaf_done = false;                      // a leaf of 3, 5 or 7 inside pass 2
    if constexpr (Q > 1) {
      if constexpr (kOdd) {
        const int lc = __ffs(cols) - 1;
        switch (L) {
          case 3: leaf_done = pass2_leaf<3, P1, P2>(a_re, lay.size_a, lay.sp, cols, lc, t.tw,
                                                    t.leaf_tw, t.plan); break;
          case 5: leaf_done = pass2_leaf<5, P1, P2>(a_re, lay.size_a, lay.sp, cols, lc, t.tw,
                                                    t.leaf_tw, t.plan); break;
          case 7: leaf_done = pass2_leaf<7, P1, P2>(a_re, lay.size_a, lay.sp, cols, lc, t.tw,
                                                    t.leaf_tw, t.plan); break;
          default: break;
        }
      }
      // pass 2: P2-point DFT over n2 -> G_r2[k1 + P1 k2] in place, slot k2
      // of row (r2, k1) (a task reads and writes only its own slots, so no
      // barrier inside), for an odd L times the leaf's twiddle
      for (int task = tid; !leaf_done && task < cols * P1 * L; task += kThreads) {
        const int c = task % cols;
        const int rest = task / cols;
        const int k1 = rest % P1;
        const int r2 = rest / P1;
        const int base = (r2 * P1 + k1) * lay.sp + c;
        float re[P2], im[P2];
#pragma unroll
        for (int n2 = 0; n2 < P2; ++n2) {
          re[n2] = a_re[base + n2 * cols];
          im[n2] = a_im[base + n2 * cols];
        }
        fft::dft_reg<P2>(re, im, t.tw, P);
#pragma unroll
        for (int k2 = 0; k2 < P2; ++k2) {
          float vr = re[fft::brev(k2, fft::log2i<P2>())];
          float vi = im[fft::brev(k2, fft::log2i<P2>())];
          if constexpr (kOdd) {
            const float2 w = __ldg(t.leaf_tw + r2 * P + k1 + P1 * k2);
            fft::cmul(vr, vi, w.x, w.y, vr, vi);
          }
          a_re[base + k2 * cols] = vr;
          a_im[base + k2 * cols] = vi;
        }
      }
      __syncthreads();
    }

    // the leaf (L > 1): F[k + P t] = sum_r2 W_L^(t r2) G'_r2[k], in place
    if constexpr (kOdd) {
      if (!leaf_done) {
        leaf<P, P1>(a_re, lay.size_a, t.plan, lay.sp, cols, __ffs(cols) - 1, o_re, lay.batch,
                    nbl);
      }
    }

    // every block's F of this round is complete
    cluster_arrive();
    cluster_wait();

    // the combine: for each k1 of this block's slice and column c, the S
    // blocks' F_b[k1] over distributed shared memory, times W_m^(b k1), then
    // the kept outputs k2 < S / 2 of their S-point DFT, Y[k1 + m' k2]
    const int* perm = nullptr;
    if constexpr (kOdd) perm = t.plan + __ldg(t.plan + 1);
    // F_b[k1] of column c in A: slot k1 mod P1, k2 of row k1 / P1 (L = 1);
    // for an odd L, sub-transform k1 mod P at the leaf's perm[k1 / P]
    auto f_at = [&](int k1, int c) {
      if constexpr (kOdd) {
        return slot<P1>(k1 & (P - 1), lay.sp, cols) +
               __ldg(perm + (k1 >> fft::log2i<P>())) * (P1 * lay.sp) + c;
      } else {
        return (k1 % P1) * lay.sp + (k1 / P1) * cols + c;     // L = 1: A's slots
      }
    };
    // the twiddles, the S-point DFT's kept outputs and their store
    auto finish = [&](float (&gr)[S], float (&gi)[S], int k1, int i, int c) {
#pragma unroll
      for (int q = 1; q < S; ++q) {
        if (k1 > 0) {
          const float2 w = __ldg(t.ctw + q * ms + k1);
          fft::cmul(gr[q], gi[q], w.x, w.y, gr[q], gi[q]);
        }
      }
      float yr[kKeep], yi[kKeep];
      if constexpr (S == 8) {
        // E[k2] + W_8^k2 O[k2] (E, O: the 4-point DFTs of the even and odd blocks)
        float er[kOut], ei[kOut], orr[kOut], oi[kOut];
        dft4<0, 2>(gr, gi, er, ei);               // E: blocks 0, 2, 4, 6
        dft4<1, 2>(gr, gi, orr, oi);              // O: blocks 1, 3, 5, 7
        yr[0] = er[0] + orr[0];
        yi[0] = ei[0] + oi[0];
        float vr, vi;
        fft::cmul(orr[1], oi[1], w8_1.x, w8_1.y, vr, vi);
        yr[1] = er[1] + vr;
        yi[1] = ei[1] + vi;
        fft::cmul(orr[3], oi[3], w8_3.x, w8_3.y, vr, vi);
        yr[3] = er[3] + vr;
        yi[3] = ei[3] + vi;
        yr[2] = er[2] + oi[2];                    // + (-i) O
        yi[2] = ei[2] - orr[2];
      } else if constexpr (S == 16) {
        // E[k2] + W_16^k2 O[k2], E and O the 8-point DFTs of the even and
        // odd blocks, each two 4-point DFTs joined by W_8 (join8)
        float er[8], ei[8], orr[8], oi[8];
        {
          float ar[kOut], ai[kOut], cr[kOut], ci[kOut];
          dft4<0, 4>(gr, gi, ar, ai);             // blocks 0, 4, 8, 12
          dft4<2, 4>(gr, gi, cr, ci);             // blocks 2, 6, 10, 14
          join8(ar, ai, cr, ci, w16[2], w16[6], er, ei);
          dft4<1, 4>(gr, gi, ar, ai);             // blocks 1, 5, 9, 13
          dft4<3, 4>(gr, gi, cr, ci);             // blocks 3, 7, 11, 15
          join8(ar, ai, cr, ci, w16[2], w16[6], orr, oi);
        }
        yr[0] = er[0] + orr[0];
        yi[0] = ei[0] + oi[0];
        yr[4] = er[4] + oi[4];                    // + (-i) O
        yi[4] = ei[4] - orr[4];
#pragma unroll
        for (int k2 = 1; k2 < 8; ++k2) {
          if (k2 != 4) {
            float vr, vi;
            fft::cmul(orr[k2], oi[k2], w16[k2].x, w16[k2].y, vr, vi);
            yr[k2] = er[k2] + vr;
            yi[k2] = ei[k2] + vi;
          }
        }
      } else if constexpr (S == 4) {
        // outputs 0, 1 of the 4-point DFT: (g0 + g2) + (g1 + g3), (g0 - g2) - i (g1 - g3)
        yr[0] = (gr[0] + gr[2]) + (gr[1] + gr[3]);
        yi[0] = (gi[0] + gi[2]) + (gi[1] + gi[3]);
        yr[1] = (gr[0] - gr[2]) + (gi[1] - gi[3]);
        yi[1] = (gi[0] - gi[2]) - (gr[1] - gr[3]);
      } else {
        yr[0] = gr[0] + gr[1];
        yi[0] = gi[0] + gi[1];
      }
      if constexpr (kFused) {
#pragma unroll
        for (int k2 = 0; k2 < kKeep; ++k2) {
          o_re[(k2 * cnt + i) * lay.np + c] = yr[k2];
          o_im[(k2 * cnt + i) * lay.np + c] = yi[k2];
        }
      } else if (c < nr) {
        // the A-stage: Y [units, 2, mh, n], `cols` contiguous floats a row
        float* yo = out + static_cast<size_t>(u) * 2 * mh * n + j0 + c;
#pragma unroll
        for (int k2 = 0; k2 < kKeep; ++k2) {
          const size_t row = static_cast<size_t>(k1 + ms * k2);
          yo[row * n] = yr[k2];
          yo[(mh + row) * n] = yi[k2];
        }
      }
    };
    if constexpr (S < kSplit) {
      // fewer than 8 blocks: kBatch tasks a thread at once, so that 8 reads
      // over distributed shared memory are in flight, as at S = 8
      constexpr int kBatch = kSplit / S;
      const int ntask = cnt * cols;
      for (int t0 = tid; t0 < ntask; t0 += kBatch * kThreads) {
        float gr[kBatch][S], gi[kBatch][S];
#pragma unroll
        for (int v = 0; v < kBatch; ++v) {
          const int task = min(t0 + v * kThreads, ntask - 1);   // past the end: not stored
          const int i = task / cols;
          float* mine = a_re + f_at(lo + i, task - i * cols);
#pragma unroll
          for (int q = 0; q < S; ++q) {
            const float* p = cluster.map_shared_rank(mine, q);
            gr[v][q] = p[0];
            gi[v][q] = p[lay.size_a];
          }
        }
#pragma unroll
        for (int v = 0; v < kBatch; ++v) {
          const int task = t0 + v * kThreads;
          if (task < ntask) {
            const int i = task / cols;
            finish(gr[v], gi[v], lo + i, i, task - i * cols);
          }
        }
      }
    } else {
      for (int task = tid; task < cnt * cols; task += kThreads) {
        const int c = task % cols;
        const int i = task / cols;
        const int k1 = lo + i;
        float* mine = a_re + f_at(k1, c);
        float gr[S], gi[S];
#pragma unroll
        for (int q = 0; q < S; ++q) {
          const float* p = cluster.map_shared_rank(mine, q);
          gr[q] = p[0];
          gi[q] = p[lay.size_a];
        }
        finish(gr, gi, k1, i, c);
      }
    }
    cluster_arrive();                            // this block has read its peers' F

    if constexpr (kFused) {
      __syncthreads();                           // the owned rows are written
      // the round's partials of each owned row, merged into the running ones
      const float nb = static_cast<float>(nr);
      const float tot = n_a + nb;
      const float f = nb / tot;
      float phi_r[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) phi_r[cc] = __ldg(phi + r * 4 + cc);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int row = tid + i * kThreads;
        if (row < kKeep * cnt) {
          fft::merge_row(o_re + row * lay.np, o_im + row * lay.np, rc, cols, nr, nb, f, n_a,
                         phi_a, phi_r, r == 0, s_r[i], s_i[i], mu_r[i], mu_i[i], e[i], d[i]);
        }
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) phi_a[cc] += phi_r[cc];
      n_a = tot;
    }
  }
  cluster_wait();                                // peers are done reading this block

  if constexpr (kFused) {
    // every column of an owned row went through this block: pow = n E -
    // |q.f_k1|^2 - |q.f_k2|^2 from its partials, no merge across blocks
    const float nf = static_cast<float>(n);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = tid + i * kThreads;
      if (row < kKeep * cnt) {
        const int k2 = row / cnt;
        const int k = lo + (row - k2 * cnt) + ms * k2;
        float pw = nf * e[i];
#pragma unroll
        for (int cc = 0; cc < 4; cc += 2) {
          const float re = d[i][cc] - d[i][4 + cc + 1];
          const float im = d[i][cc + 1] + d[i][4 + cc];
          pw -= re * re + im * im;
        }
        out[static_cast<size_t>(u) * mh + k] = pw;
      }
    }
  }
}

// L = 1 (a radix m whose m' = m / 8 is a power of two: 2048, 4096, 8192):
// no leaf.
template <class Src, int P1, int P2, bool kFused>
__global__ void __launch_bounds__(kThreads, 1)
cluster_chain_kernel(Src src, const float* __restrict__ tab, const float* __restrict__ phi,
                     const float* __restrict__ wd, const float* __restrict__ ph,
                     float* __restrict__ out, int m, int L, int n, int cols, float salt, int nbl) {
  cluster_body<Src, kSplit, P1, P2, kFused, false>(src, tab, phi, wd, ph, out, m, L, n, cols,
                                                   salt, 0);
}

// L = 1 at a cluster of 16 (m = 16384, m' = 1024): no leaf.
template <class Src, int P1, int P2, bool kFused>
__global__ void __launch_bounds__(kThreads, 1)
cluster_chain16_kernel(Src src, const float* __restrict__ tab, const float* __restrict__ phi,
                       const float* __restrict__ wd, const float* __restrict__ ph,
                       float* __restrict__ out, int m, int L, int n, int cols, float salt,
                       int nbl) {
  cluster_body<Src, kSplitLong, P1, P2, kFused, false>(src, tab, phi, wd, ph, out, m, L, n,
                                                       cols, salt, 0);
}

// An odd L > 1 (every other m the body takes): the leaf, clusters of S.
template <class Src, int S, int P1, int P2, bool kFused>
__global__ void __launch_bounds__(kThreads, 1)
cluster_leaf_kernel(Src src, const float* __restrict__ tab, const float* __restrict__ phi,
                    const float* __restrict__ wd, const float* __restrict__ ph,
                    float* __restrict__ out, int m, int L, int n, int cols, float salt, int nbl) {
  cluster_body<Src, S, P1, P2, kFused, true>(src, tab, phi, wd, ph, out, m, L, n, cols, salt,
                                             nbl);
}

// The kernels compile in parts, one source file each, so that nvcc builds
// them in parallel: at S = 8, kWide (L = 1, P = 256, 512, 1024: m = 2048,
// 4096, 8192; an odd leaf at P = 32..256) in the entry's own file; an odd
// leaf at P = 2, 4 (kP2: fused_chain_{radix,wire,astage}_cluster_p2.cu) and
// at P = 8, 16 (kP8: ..._cluster_p8.cu); at S = 16 (8192 < m <= 16384,
// every chain) the same three cuts and a fourth,
// kWide16 (L = 1 at P = 1024: m = 16384; a leaf at P = 32..256) in
// fused_chain_{radix,wire,astage}_cluster16.cu, kP2S16 and kP8S16 in
// ..._cluster16_p2.cu and ..._cluster16_p8.cu, and P = 1 (m = 16 x odd:
// the odd leaf alone, then the 8-of-16 combine) kP1S16 in
// ..._cluster16_p1.cu; P = 1 at S <= 8, the dense entries' m = S x odd on
// the planar chain alone, S = 8 (kS8: fused_chain_dense_cluster8.cu) and
// S = 2, 4 (kS24: fused_chain_dense_cluster24.cu).
enum class Part { kWide, kP2, kP8, kS8, kS24, kWide16, kP2S16, kP8S16, kP1S16 };

template <Part kPart>
constexpr bool kPartS16 = kPart == Part::kWide16 || kPart == Part::kP2S16 ||
                          kPart == Part::kP8S16 || kPart == Part::kP1S16;

// The kernel of one part for m' = P L split S ways (a radix m: S = 8, or
// 16 above kMaxM8).
template <Part kPart, class Src, bool kFused, class Fn>
cudaError_t dispatch(int S, int P, int L, Fn&& fn) {
  if constexpr (kPart == Part::kWide || kPart == Part::kWide16) {
    constexpr int kS = kPart == Part::kWide ? kSplit : kSplitLong;
    if (S != kS) return cudaErrorInvalidValue;
    if (L == 1) {
      if constexpr (kS == kSplit) {
        switch (P) {
          case 256: return fn(cluster_chain_kernel<Src, 32, 8, kFused>);
          case 512: return fn(cluster_chain_kernel<Src, 32, 16, kFused>);
          case 1024: return fn(cluster_chain_kernel<Src, 32, 32, kFused>);
          default: return cudaErrorInvalidValue;
        }
      } else {
        if (P == 1024) return fn(cluster_chain16_kernel<Src, 32, 32, kFused>);
        return cudaErrorInvalidValue;
      }
    }
    switch (P) {
      case 32: return fn(cluster_leaf_kernel<Src, kS, 32, 1, kFused>);
      case 64: return fn(cluster_leaf_kernel<Src, kS, 32, 2, kFused>);
      case 128: return fn(cluster_leaf_kernel<Src, kS, 32, 4, kFused>);
      case 256: return fn(cluster_leaf_kernel<Src, kS, 32, 8, kFused>);
      default: return cudaErrorInvalidValue;
    }
  } else if constexpr (kPart == Part::kP2 || kPart == Part::kP8 || kPart == Part::kP2S16 ||
                       kPart == Part::kP8S16) {
    constexpr int kS = kPartS16<kPart> ? kSplitLong : kSplit;
    if (S != kS || L == 1) return cudaErrorInvalidValue;
    constexpr int lo = kPart == Part::kP2 || kPart == Part::kP2S16 ? 2 : 8;
    if (P == lo) return fn(cluster_leaf_kernel<Src, kS, lo, 1, kFused>);
    if (P == 2 * lo) return fn(cluster_leaf_kernel<Src, kS, 2 * lo, 1, kFused>);
    return cudaErrorInvalidValue;
  } else if constexpr (kPart == Part::kP1S16) {
    // the planar and wire chains (PlanarDirect, fft::WireIq; fused) and
    // the A-stage (PlanarRows)
    if (S == kSplitLong && P == 1 && L > 1) {
      return fn(cluster_leaf_kernel<Src, kSplitLong, 1, 1, kFused>);
    }
    return cudaErrorInvalidValue;
  } else {
    if constexpr (std::is_same_v<Src, PlanarDirect> && kFused) {
      if (P == 1 && L > 1) {
        if constexpr (kPart == Part::kS8) {
          if (S == 8) return fn(cluster_leaf_kernel<Src, 8, 1, 1, kFused>);
        } else {
          if (S == 2) return fn(cluster_leaf_kernel<Src, 2, 1, 1, kFused>);
          if (S == 4) return fn(cluster_leaf_kernel<Src, 4, 1, 1, kFused>);
        }
      }
    }
    return cudaErrorInvalidValue;
  }
}

// Bluestein's N for the leaf of an odd L: 0 where every prime factor is
// <= kMaxRadix, else the power of two >= 2p - 1 for the largest prime p
// (ops/fullchain.leaf_plan).
__host__ inline int bluestein_n(int L) {
  int p = 1;
  for (int q = 2, v = L; v > 1; ++q) {
    while (v % q == 0) {
      v /= q;
      p = q;
    }
    if (q * q > v && v > 1) {
      p = v;
      break;
    }
  }
  if (p <= kMaxRadix) return 0;
  int nb = 1;
  while (nb < 2 * p - 1) nb *= 2;
  return nb;
}

// S = 8 for a radix m up to kMaxM8, 16 above it (P = 1 at m = 16 x odd);
// the power of two in a radix-1 m = S x odd.
struct Geometry {
  int S, ms, P, L, P1, P2, nbl;
  bool ok;
  explicit Geometry(int m) {
    S = m % 16 != 0 ? (m & -m) : m > kMaxM8 ? kSplitLong : kSplit;
    ms = m / fft::imax(S, 1);
    P = ms & -ms;
    L = ms / fft::imax(P, 1);
    P1 = P < 32 ? P : 32;
    P2 = P / fft::imax(P1, 1);
    nbl = L > 1 ? bluestein_n(L) : 0;
    ok = m >= kMinM && m <= kMaxM && m % 2 == 0 && S >= 2 && ms <= kMaxMs &&
         nbl <= kMaxBluestein;
  }
};

__host__ inline bool cols_ok(int cols) {
  return cols >= 1 && cols <= kMaxCols && (cols & (cols - 1)) == 0;
}

inline cudaLaunchConfig_t launch_config(int S, int channels, int sectors, size_t smem,
                                        cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(S), static_cast<unsigned>(channels),
                     static_cast<unsigned>(sectors));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(S);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// A kernel's attributes before its launch or occupancy query: a block of
// `smem` bytes; at S = 16 the non-portable cluster size.
template <class Kernel>
cudaError_t set_attributes(Kernel kernel, int S, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess || S <= kSplit) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// The block's layout at (m, cols), or false where the block does not fit
// (a Bluestein leaf with no batch in one block's shared memory).
template <class Src, bool kFused>
bool layout_for(const Src& src, const Geometry& g, int cols, size_t* smem) {
  const Layout lay(g.ms, g.L, g.P1, g.P2, g.S, cols, kFused, stage_words(src, cols, g.S), g.nbl);
  *smem = lay.bytes();
  return lay.words <= kMaxWords && (g.nbl == 0 || lay.batch > 0);
}

// One launch of a part's kernel over units u = sector * channels +
// channel, a cluster of S blocks each, on `stream` without synchronising,
// at the geometry g of m and a block of `smem` bytes.
template <Part kPart, class Src, bool kFused>
cudaError_t launch_part(const Src& src, const float* tab, const float* phi, const float* wd,
                        const float* ph, float* out, int sectors, int channels, int m, int n,
                        int cols, float salt, size_t smem, cudaStream_t stream) {
  const Geometry g(m);
  return dispatch<kPart, Src, kFused>(g.S, g.P, g.L, [&](auto kernel) {
    cudaError_t err = set_attributes(kernel, g.S, smem);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = launch_config(g.S, channels, sectors, smem, stream, attr);
    err = cudaLaunchKernelEx(&cfg, kernel, src, tab, phi, wd, ph, out, m, g.L, n, cols, salt,
                             g.nbl);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  });
}

// Resident blocks per SM and clusters of S the card holds at once
// (cudaOccupancyMaxActiveClusters) of a part's kernel at m and a block of
// `smem` bytes.
template <Part kPart, class Src, bool kFused>
cudaError_t occupancy_part(int m, size_t smem, int* blocks_per_sm, int* clusters) {
  const Geometry g(m);
  return dispatch<kPart, Src, kFused>(g.S, g.P, g.L, [&](auto kernel) {
    cudaError_t err = set_attributes(kernel, g.S, smem);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = launch_config(g.S, 1, 1, smem, nullptr, attr);
    return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  });
}

// The parts compiled in their own files: `kind` is `extern template` here,
// `template` (the explicit instantiation) in the part's file.
#define WRP_CLUSTER_PART(kind, kPart, Src, kFused)                                            \
  kind cudaError_t launch_part<kPart, Src, kFused>(                                           \
      const Src&, const float*, const float*, const float*, const float*, float*, int, int,   \
      int, int, int, float, size_t, cudaStream_t);                                            \
  kind cudaError_t occupancy_part<kPart, Src, kFused>(int, size_t, int*, int*);
WRP_CLUSTER_PART(extern template, Part::kP2, PlanarDirect, true)
WRP_CLUSTER_PART(extern template, Part::kP2, fft::WireIq, true)
WRP_CLUSTER_PART(extern template, Part::kP2, PlanarRows, false)
WRP_CLUSTER_PART(extern template, Part::kP8, PlanarDirect, true)
WRP_CLUSTER_PART(extern template, Part::kP8, fft::WireIq, true)
WRP_CLUSTER_PART(extern template, Part::kP8, PlanarRows, false)
WRP_CLUSTER_PART(extern template, Part::kS8, PlanarDirect, true)
WRP_CLUSTER_PART(extern template, Part::kS24, PlanarDirect, true)
WRP_CLUSTER_PART(extern template, Part::kWide16, PlanarDirect, true)
WRP_CLUSTER_PART(extern template, Part::kWide16, fft::WireIq, true)
WRP_CLUSTER_PART(extern template, Part::kWide16, PlanarRows, false)
WRP_CLUSTER_PART(extern template, Part::kP2S16, PlanarDirect, true)
WRP_CLUSTER_PART(extern template, Part::kP2S16, fft::WireIq, true)
WRP_CLUSTER_PART(extern template, Part::kP2S16, PlanarRows, false)
WRP_CLUSTER_PART(extern template, Part::kP8S16, PlanarDirect, true)
WRP_CLUSTER_PART(extern template, Part::kP8S16, fft::WireIq, true)
WRP_CLUSTER_PART(extern template, Part::kP8S16, PlanarRows, false)
WRP_CLUSTER_PART(extern template, Part::kP1S16, PlanarDirect, true)
WRP_CLUSTER_PART(extern template, Part::kP1S16, fft::WireIq, true)
WRP_CLUSTER_PART(extern template, Part::kP1S16, PlanarRows, false)

__host__ inline Part part_of(const Geometry& g) {
  const bool s16 = g.S == kSplitLong;
  if (g.P == 1) return s16 ? Part::kP1S16 : g.S == kSplit ? Part::kS8 : Part::kS24;
  if (g.L == 1 || g.P >= 32) return s16 ? Part::kWide16 : Part::kWide;
  if (g.P <= 4) return s16 ? Part::kP2S16 : Part::kP2;
  return s16 ? Part::kP8S16 : Part::kP8;
}

// A part's function: fn(std::integral_constant<Part, part>) for g's part.
template <class Fn>
cudaError_t for_part(const Geometry& g, Fn&& fn) {
  switch (part_of(g)) {
    case Part::kWide: return fn(std::integral_constant<Part, Part::kWide>{});
    case Part::kP2: return fn(std::integral_constant<Part, Part::kP2>{});
    case Part::kP8: return fn(std::integral_constant<Part, Part::kP8>{});
    case Part::kS8: return fn(std::integral_constant<Part, Part::kS8>{});
    case Part::kWide16: return fn(std::integral_constant<Part, Part::kWide16>{});
    case Part::kP2S16: return fn(std::integral_constant<Part, Part::kP2S16>{});
    case Part::kP8S16: return fn(std::integral_constant<Part, Part::kP8S16>{});
    case Part::kP1S16: return fn(std::integral_constant<Part, Part::kP1S16>{});
    default: return fn(std::integral_constant<Part, Part::kS24>{});
  }
}

// One launch over units u = sector * channels + channel, a cluster of S
// blocks each, on `stream` without synchronising.  The caller validates
// shapes, dtypes and offsets; cudaErrorInvalidValue for an m, cols or grid
// this body does not take.
template <class Src, bool kFused>
cudaError_t launch(const Src& src, const float* tab, const float* phi, const float* wd,
                   const float* ph, float* out, int sectors, int channels, int m, int n,
                   int cols, float salt, cudaStream_t stream) {
  const Geometry g(m);
  size_t smem = 0;
  if (!g.ok || sectors <= 0 || sectors > 65535 || channels <= 0 || channels > 65535 || n <= 0 ||
      !cols_ok(cols) || !layout_for<Src, kFused>(src, g, cols, &smem)) {
    return cudaErrorInvalidValue;
  }
  return for_part(g, [&](auto part) {
    return launch_part<decltype(part)::value, Src, kFused>(
        src, tab, phi, wd, ph, out, sectors, channels, m, n, cols, salt, smem, stream);
  });
}

// Resident blocks per SM and clusters of S the card holds at once
// (cudaOccupancyMaxActiveClusters) at (m, cols) for the source `src` (its
// staging buffer's size).
template <class Src, bool kFused>
cudaError_t occupancy(const Src& src, int m, int cols, int* blocks_per_sm, int* clusters) {
  const Geometry g(m);
  size_t smem = 0;
  if (!g.ok || !cols_ok(cols) || !layout_for<Src, kFused>(src, g, cols, &smem)) {
    return cudaErrorInvalidValue;
  }
  return for_part(g, [&](auto part) {
    return occupancy_part<decltype(part)::value, Src, kFused>(m, smem, blocks_per_sm, clusters);
  });
}

}  // namespace cluster
}  // namespace wrp
