// The cluster body: rays of 1024 < m <= 8192 range cells, each split across
// a thread-block cluster of 8 blocks, for NVIDIA Hopper (sm_90a).  Behind
// fused_chain_astage_cluster.cu (the pulse-sharded path's A-stage, Y
// stored), fused_chain_radix_cluster.cu (the planar fused chain and its
// offset/salt entry) and fused_chain_wire_cluster.cu (the wire fused chain
// and its offset/salt entry), the last two with the Parseval epilogue
// fused.  It replaces, at those m, the TPU kernels wrp_tpu/ops/pallas/
// fullchain.py::fused_chain_astage (_kernel_radix_astage),
// fused_chain_power_radix (_kernel_radix, _kernel_radix_offset) and
// fused_chain_power_wire (_kernel_radix_wire, _kernel_radix_wire_offset).
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
// sat in shared memory, one block per SM.  Here a unit is one cluster of 8
// blocks and every block sees every column: block b owns the range rows
// r = 8 t + b, t < m' = m / 8, a round `cols` columns wide, as many as one
// block's shared memory holds (ops/fullchain.cluster_geometry: for the
// wire and planar chains and the int16 A-stage 64 at m = 2048, 32 at 4096,
// 16 at 8192 and near 4096 with an odd leaf; at least a row's whole
// 32-byte sector of int16), since each round costs two cluster barriers.  With r = 8 t + b
// and k = k1 + m' k2 (k1 < m', k2 < 8):
//
//   Y[k1 + m' k2] = sum_b W_8^(b k2) W_m^(b k1) F_b[k1],
//   F_b[k1] = sum_t W_m'^(t k1) x_w[8 t + b],
//
// so a round is
//   1. in each block the m'-point DFT F_b of its rows, in its own shared
//      memory, with the register body's passes: m' = P L (P the largest
//      power of two dividing m', L odd), a P1-point register DFT over
//      rows L (P2 n1 + n2) + r2, the twiddle W_P^(k1 n2), a P2-point
//      register DFT (P1 P2 = P <= 1024, each <= 32; for L = 1 in place, F
//      left in pass 1's slots), then for L > 1 the leaf's twiddle
//      W_m'^(k r2) and its Stockham passes (radix 3, 5, 7 unrolled; any
//      other factor in one O(L^2) pass, fft_chain.cuh leaf_pass_split);
//   2. a cluster barrier; block b' takes the k1 of its slice (ceil(m' / 8)
//      values) of all eight blocks' F over distributed shared memory,
//      multiplies F_b[k1] by W_m^(b k1) and runs the 8-point DFT across
//      the blocks for its 4 kept outputs k2 < 4 only (k < m/2): two
//      4-point DFTs, exact in +-1, +-i, and W_8^k2 between them.  A block
//      thus owns the m/16 rows k1 + m' k2 of its slice through every round;
//   3. the A-stage stores its rows of Y, `cols` contiguous floats a row and
//      plane; the fused chains write them to a local buffer and merge each
//      owned row's round into its Parseval partials, held in registers for
//      the whole unit (kRows rows a thread).  Every column of a row passes
//      through the one block that owns it, so no merge across blocks is
//      left at the end: each block writes its rows' power.
// Every twiddle comes from the plan's table (ops/fullchain.cluster_tables:
// fp64 on the host, cast once); nothing calls sincosf.
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
// them.  After the last round a block
// waits until its peers are done reading it before it exits.
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
// the grid is 8 blocks a unit, clusters of 8.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "fft_chain.cuh"

namespace wrp {
namespace cluster {

namespace cg = cooperative_groups;

constexpr int kSplit = 8;       // blocks a unit (one cluster); rows decimated by 8
constexpr int kOut = 4;         // outputs k2 < 4 of the 8-point DFT across blocks (k < m/2)
constexpr int kRows = 2;        // epilogue rows a thread owns: m/16 <= 512
constexpr int kMinM = 1025;     // below: the register body (fft_chain.cuh)
constexpr int kMaxM = 8192;     // m' = m / 8 <= 1024, P <= 1024
constexpr int kMaxCols = 64;

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// The 4-point DFT (W_4 = -i, exact) of the blocks h, h + 2, h + 4, h + 6:
// x[k] = sum_j W_4^(j k) g[h + 2 j].
template <int h>
__device__ __forceinline__ void dft4(const float (&gr)[kSplit], const float (&gi)[kSplit],
                                     float (&xr)[kOut], float (&xi)[kOut]) {
  const float sr = gr[h] + gr[h + 4], si = gi[h] + gi[h + 4];
  const float ar = gr[h] - gr[h + 4], ai = gi[h] - gi[h + 4];
  const float tr = gr[h + 2] + gr[h + 6], ti = gi[h + 2] + gi[h + 6];
  const float dr = gr[h + 2] - gr[h + 6], di = gi[h + 2] - gi[h + 6];
  xr[0] = sr + tr;
  xi[0] = si + ti;
  xr[1] = ar + di;                              // a - i d
  xi[1] = ai - dr;
  xr[2] = sr - tr;
  xi[2] = si - ti;
  xr[3] = ar - di;                              // a + i d
  xi[3] = ai + dr;
}

// Planar IQ x [units, 2, m, n], int16 or float (a uniform runtime switch):
// the block stages its rows r = 8 t + b of both planes, `cols` columns a
// round, as [plane][t][cols] in shared memory.
struct PlanarRows {
  static constexpr bool kStaged = true;
  const void* x;
  int is_int16;
  int m, n;

  __host__ __device__ int elem() const { return is_int16 ? 2 : 4; }
  // the staging buffer in 32-bit words (a multiple of 4: m' is even)
  __host__ __device__ int words(int cols) const {
    return 2 * (m / kSplit) * cols * elem() / 4;
  }

  template <int B>
  __device__ __forceinline__ void stage_pieces(char* buf, size_t unit, int b, int j0, int nr,
                                               int cols) const {
    const int e = elem();
    const int ms = m / kSplit;
    const int per_row = cols * e / B;           // a power of two
    const int piece = static_cast<int>(threadIdx.x) % per_row;
    const int col = piece * B / e;
    const int valid = max(0, min(B, (nr - col) * e));
    const int rstep = kThreads / per_row;
    const char* base = static_cast<const char*>(x) + (unit + j0 + (valid ? col : 0)) * e;
    for (int row = static_cast<int>(threadIdx.x) / per_row; row < 2 * ms; row += rstep) {
      const int plane = row >= ms;
      const int t = row - plane * ms;
      const size_t src = static_cast<size_t>(plane * m + kSplit * t + b) * n;
      fft::cp_async<B>(buf + (static_cast<size_t>(row) * cols + col) * e, base + src * e, valid);
    }
  }

  // rows 8 t + b (t < m'), columns [j0, j0 + cols) of unit u; zeros past n
  __device__ __forceinline__ void stage(void* buf, int u, int b, int j0, int cols) const {
    const int e = elem();
    const int ms = m / kSplit;
    const int nr = min(cols, n - j0);
    const size_t unit = static_cast<size_t>(u) * 2 * m * n;
    char* bb = static_cast<char*>(buf);
    const uintptr_t at = reinterpret_cast<uintptr_t>(x);
    if ((cols * e) % 16 == 0 && (n * e) % 16 == 0 && at % 16 == 0) {
      stage_pieces<16>(bb, unit, b, j0, nr, cols);
    } else if ((cols * e) % 8 == 0 && (n * e) % 8 == 0 && at % 8 == 0) {
      stage_pieces<8>(bb, unit, b, j0, nr, cols);
    } else if ((cols * e) % 4 == 0 && (n * e) % 4 == 0 && at % 4 == 0) {
      stage_pieces<4>(bb, unit, b, j0, nr, cols);
    } else {
      // rows too narrow or not aligned: element by element through registers
      for (int k = threadIdx.x; k < 2 * ms * cols; k += kThreads) {
        const int row = k / cols;
        const int c = k - row * cols;
        const int plane = row >= ms;
        const int t = row - plane * ms;
        const size_t src = unit + static_cast<size_t>(plane * m + kSplit * t + b) * n + j0 + c;
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
  template <int N>
  __device__ __forceinline__ void read(const void* buf, int t0, int step, int c, int cols,
                                       float (&re)[N], float (&im)[N]) const {
    const int plane = (m / kSplit) * cols;
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

  __host__ __device__ int words(int) const { return 0; }

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

// The plan's table (ops/fullchain.cluster_tables): w_r c [m]; W_P^t (re,
// im) for t < P; the leaf's W_m'^(k r2) at (r2 P + k); the leaf's roots
// W_L^t; the cluster's W_m^(b k1) at (b m' + k1); W_8^t, t < 8.
struct Table {
  const float* win;
  const float* tw;
  const float2* leaf_tw;
  const float2* leaf;
  const float2* ctw;
  const float2* w8;

  __host__ __device__ Table(const float* t, int m, int ms, int P, int L)
      : win(t),
        tw(t + m),
        leaf_tw(reinterpret_cast<const float2*>(t + m + 2 * P)),
        leaf(reinterpret_cast<const float2*>(t + m + 2 * P + 2 * L * P)),
        ctw(reinterpret_cast<const float2*>(t + m + 2 * P + 2 * L * P + 2 * L)),
        w8(reinterpret_cast<const float2*>(t + m + 2 * P + 2 * L * P + 2 * L + 2 * kSplit * ms)) {}
};

// Shared memory of one block, in 32-bit words, each part a multiple of 16
// bytes: A (pass 1's slots [r2][k1][n2][column], rows padded; for L = 1
// pass 2 runs in place and leaves F[k1 + P1 k2] in slot k2 of row k1; for
// L > 1 at least one leaf buffer), B (L > 1: pass 2's output in the leaf's
// layout [k][r2][column]; the Stockham passes run B -> A -> B ..., and F
// stays in the last one's buffer, natural index k + P t at row k L + t),
// the staged samples S, and for the fused chains the block's rows of Y
// [kOut span][cols + 1] and the round's epilogue constants (wd, 4 phasor
// rows).  ops/fullchain.cluster_smem_bytes is the same arithmetic.
struct Layout {
  int sp;         // slot row pitch: P2 cols + pad
  int np;         // the owned rows' pitch: cols + 1
  int span;       // k1 a block combines: ceil(m' / 8)
  int size_a;     // complex values
  int size_b;
  int stage;      // words of S
  int own;        // complex values of the owned rows
  int words;

  __host__ __device__ Layout(int ms, int L, int P1, int P2, int cols, bool fused,
                             int stage_words) {
    const int pad = cols < 32 ? cols : 0;
    sp = P2 * cols + pad;
    np = cols + 1;
    span = (ms + kSplit - 1) / kSplit;
    const int leaf = ms * cols;
    if (L == 1) {
      size_a = fft::round4(P1 * sp);
      size_b = 0;
    } else {
      size_a = fft::round4(fft::imax(P2 > 1 ? L * P1 * sp : 0, leaf));
      size_b = fft::round4(leaf);
    }
    stage = fft::round4(stage_words);
    own = fused ? fft::round4(kOut * span * np) : 0;
    words = 2 * (size_a + size_b) + stage + 2 * own + (fused ? fft::round4(5 * cols) : 0);
  }
  __host__ __device__ size_t bytes() const { return static_cast<size_t>(words) * sizeof(float); }
};

// The body.  Src: PlanarRows (the A-stage), PlanarDirect (the planar chain)
// or fft::WireIq (the wire chain).  Grid (8, channels, sectors), clusters
// of 8 along x: unit u = sector * channels + channel, block rank b =
// blockIdx.x.  kFused: out = pow [units, m/2] (the planar and wire chains);
// else out = Y [units, 2, m/2, n] (the A-stage) and wd, ph, phi are unused.
template <class Src, int P1, int P2, bool kFused>
__global__ void __launch_bounds__(kThreads, 1)
cluster_chain_kernel(Src src, const float* __restrict__ tab, const float* __restrict__ phi,
                     const float* __restrict__ wd, const float* __restrict__ ph,
                     float* __restrict__ out, int m, int L, int n, int cols, float salt) {
  constexpr int P = P1 * P2;
  constexpr int Q = P2;                          // pass 1's n2 < Q
  constexpr bool kLeaf = P < 1024;               // m' <= 1024: P = 1024 has L = 1
  const int ms = m / kSplit;
  const int mh = m / 2;
  const int u = static_cast<int>(blockIdx.z * gridDim.y + blockIdx.y);
  const int b = static_cast<int>(blockIdx.x);    // rank in the unit's cluster
  const int tid = static_cast<int>(threadIdx.x);
  const Table t(tab, m, ms, P, L);
  const Layout lay(ms, L, P1, P2, cols, kFused, src.words(cols));
  cg::cluster_group cluster = cg::this_cluster();

  extern __shared__ __align__(16) float smem[];
  float* a_re = smem;
  float* a_im = a_re + lay.size_a;
  float* b_re = a_im + lay.size_a;
  float* b_im = b_re + lay.size_b;
  float* stage = b_im + lay.size_b;
  float* o_re = stage + lay.stage;               // kFused: the owned rows [kOut span][np]
  float* o_im = o_re + lay.own;
  float* rc = o_im + lay.own;                    // kFused: [5][cols]: wd, ph rows
  // where F lies after the sub-DFT: A's slots (L = 1), else the last leaf
  // pass's buffer (A for an odd number of passes).  Pass 1 writes A or B,
  // so a round starts once its peers have read the last round's F.
  bool in_a = true;
  if constexpr (kLeaf) in_a = L == 1 || fft::leaf_passes(L) % 2 == 1;
  float* f_re = in_a ? a_re : b_re;
  const int f_im = in_a ? lay.size_a : lay.size_b;   // im - re

  const int lo = b * lay.span;                   // this block's k1 slice
  const int cnt = min(ms, lo + lay.span) - lo;
  const float2 w8_1 = __ldg(t.w8 + 1);          // W_8^1
  const float2 w8_3 = __ldg(t.w8 + 3);          // W_8^3

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
    src.stage(stage, u, b, 0, cols);
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
    // t = L (Q n1 + n2) + r2 (global rows 8 t + b); twiddle W_P^(k1 n2)
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
        src.template read<P1>(stage, t0, tstep, c, cols, re, im);
      } else {
        src.template load<P1>(u, kSplit * t0 + b, kSplit * tstep, c < nr ? j0 + c : j0, re, im);
      }
#pragma unroll
      for (int n1 = 0; n1 < P1; ++n1) {
        const float w = __ldg(t.win + kSplit * (t0 + n1 * tstep) + b) * keep;
        re[n1] = w * (re[n1] + salt);
        im[n1] = w * (im[n1] + salt);
      }
      fft::dft_reg<P1>(re, im, t.tw, P);
#pragma unroll
      for (int k1 = 0; k1 < P1; ++k1) {
        float vr = re[fft::brev(k1, fft::log2i<P1>())];
        float vi = im[fft::brev(k1, fft::log2i<P1>())];
        if (Q == 1 && L > 1) {
          // F_r2[k1] of the P-point DFT is final: the leaf's twiddle, its layout in B
          if (k1 > 0) {
            const float2 w = __ldg(t.leaf_tw + r2 * P + k1);
            fft::cmul(vr, vi, w.x, w.y, vr, vi);
          }
          b_re[(k1 * L + r2) * cols + c] = vr;
          b_im[(k1 * L + r2) * cols + c] = vi;
        } else {
          if (Q > 1 && k1 > 0) {                  // W^0 = 1 exactly at n2 = 0: no branch
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
      if (j0 + cols < n) src.stage(stage, u, b, j0 + cols, cols);   // under the rest of the round
      fft::cp_async_commit();
    }

    if constexpr (Q > 1) {
      // pass 2: P2-point DFT over n2 -> F_r2[k1 + P1 k2]: for L = 1 in place
      // (a task reads and writes only its own slots, so no barrier inside),
      // slot k2 of row k1; otherwise to B in the leaf's layout, with its
      // twiddle
      for (int task = tid; task < cols * P1 * L; task += kThreads) {
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
          const int k = k1 + P1 * k2;
          float vr = re[fft::brev(k2, fft::log2i<P2>())];
          float vi = im[fft::brev(k2, fft::log2i<P2>())];
          if (L == 1) {
            a_re[base + k2 * cols] = vr;
            a_im[base + k2 * cols] = vi;
          } else {
            const float2 w = __ldg(t.leaf_tw + r2 * P + k);
            fft::cmul(vr, vi, w.x, w.y, vr, vi);
            b_re[(k * L + r2) * cols + c] = vr;
            b_im[(k * L + r2) * cols + c] = vi;
          }
        }
      }
      __syncthreads();
    }

    // the leaf (L > 1): F[k + P t] = sum_r2 W_L^(t r2) (W_m'^(k r2) F_r2[k]),
    // Stockham passes B -> A -> B ..., every one in the [k][t] layout
    if constexpr (kLeaf) {
      if (L > 1) {
        float *ir = b_re, *ii = b_im, *orr = a_re, *oi = a_im;
        for (int rem = L, ns = 1; rem > 1;) {
          const int R = fft::leaf_radix(rem);
          if (R == 5) {
            fft::leaf_pass<5>(ir, ii, orr, oi, t.leaf, L, P, cols, ns, R, false, 0, 0);
          } else if (R == 3) {
            fft::leaf_pass<3>(ir, ii, orr, oi, t.leaf, L, P, cols, ns, R, false, 0, 0);
          } else if (R == 7) {
            fft::leaf_pass<7>(ir, ii, orr, oi, t.leaf, L, P, cols, ns, R, false, 0, 0);
          } else {
            fft::leaf_pass_split(ir, ii, orr, oi, t.leaf, L, P, cols, ns, R, false, 0, 0);
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

    // every block's F of this round is complete
    cluster_arrive();
    cluster_wait();

    // the combine: for each k1 of this block's slice and column c, the eight
    // blocks' F_b[k1] over distributed shared memory, times W_m^(b k1), then
    // Y[k1 + m' k2] = E[k2] + W_8^k2 O[k2] for k2 < 4 (E, O: the 4-point
    // DFTs of the even and odd blocks)
    for (int task = tid; task < cnt * cols; task += kThreads) {
      const int c = task % cols;
      const int i = task / cols;
      const int k1 = lo + i;
      int at = (k1 % P1) * lay.sp + (k1 / P1) * cols;     // L = 1: A's slots
      if constexpr (kLeaf) {
        if (L > 1) at = ((k1 % P) * L + k1 / P) * cols;
      }
      float* mine = f_re + at + c;
      float gr[kSplit], gi[kSplit];
#pragma unroll
      for (int q = 0; q < kSplit; ++q) {
        const float* p = cluster.map_shared_rank(mine, q);
        gr[q] = p[0];
        gi[q] = p[f_im];
      }
#pragma unroll
      for (int q = 1; q < kSplit; ++q) {
        if (k1 > 0) {
          const float2 w = __ldg(t.ctw + q * ms + k1);
          fft::cmul(gr[q], gi[q], w.x, w.y, gr[q], gi[q]);
        }
      }
      float er[kOut], ei[kOut], orr[kOut], oi[kOut];
      dft4<0>(gr, gi, er, ei);                    // E: blocks 0, 2, 4, 6
      dft4<1>(gr, gi, orr, oi);                   // O: blocks 1, 3, 5, 7
      float yr[kOut], yi[kOut];
      yr[0] = er[0] + orr[0];
      yi[0] = ei[0] + oi[0];
      {
        float vr, vi;
        fft::cmul(orr[1], oi[1], w8_1.x, w8_1.y, vr, vi);
        yr[1] = er[1] + vr;
        yi[1] = ei[1] + vi;
        fft::cmul(orr[3], oi[3], w8_3.x, w8_3.y, vr, vi);
        yr[3] = er[3] + vr;
        yi[3] = ei[3] + vi;
      }
      yr[2] = er[2] + oi[2];                      // + (-i) O
      yi[2] = ei[2] - orr[2];
      if constexpr (kFused) {
#pragma unroll
        for (int k2 = 0; k2 < kOut; ++k2) {
          o_re[(k2 * cnt + i) * lay.np + c] = yr[k2];
          o_im[(k2 * cnt + i) * lay.np + c] = yi[k2];
        }
      } else if (c < nr) {
        // the A-stage: Y [units, 2, mh, n], `cols` contiguous floats a row
        float* yo = out + static_cast<size_t>(u) * 2 * mh * n + j0 + c;
#pragma unroll
        for (int k2 = 0; k2 < kOut; ++k2) {
          const size_t row = static_cast<size_t>(k1 + ms * k2);
          yo[row * n] = yr[k2];
          yo[(mh + row) * n] = yi[k2];
        }
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
        if (row < kOut * cnt) {
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
      if (row < kOut * cnt) {
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

// The kernel for m' = P L: dispatch over P (P1 = min(32, P)).  A radix m
// (m % 16 == 0) in 1024 < m <= 8192 gives 2 <= P <= 1024.
template <class Src, bool kFused, class Fn>
cudaError_t dispatch(int P, Fn&& fn) {
  switch (P) {
    case 2: return fn(cluster_chain_kernel<Src, 2, 1, kFused>);
    case 4: return fn(cluster_chain_kernel<Src, 4, 1, kFused>);
    case 8: return fn(cluster_chain_kernel<Src, 8, 1, kFused>);
    case 16: return fn(cluster_chain_kernel<Src, 16, 1, kFused>);
    case 32: return fn(cluster_chain_kernel<Src, 32, 1, kFused>);
    case 64: return fn(cluster_chain_kernel<Src, 32, 2, kFused>);
    case 128: return fn(cluster_chain_kernel<Src, 32, 4, kFused>);
    case 256: return fn(cluster_chain_kernel<Src, 32, 8, kFused>);
    case 512: return fn(cluster_chain_kernel<Src, 32, 16, kFused>);
    case 1024: return fn(cluster_chain_kernel<Src, 32, 32, kFused>);
    default: return cudaErrorInvalidValue;
  }
}

struct Geometry {
  int ms, P, L, P1, P2;
  bool ok;
  explicit Geometry(int m) {
    ms = m / kSplit;
    P = ms & -ms;
    L = ms / fft::imax(P, 1);
    P1 = P < 32 ? P : 32;
    P2 = P / fft::imax(P1, 1);
    ok = m >= kMinM && m <= kMaxM && m % 16 == 0;
  }
};

__host__ inline bool cols_ok(int cols) {
  return cols >= 1 && cols <= kMaxCols && (cols & (cols - 1)) == 0;
}

inline cudaLaunchConfig_t launch_config(int channels, int sectors, size_t smem,
                                        cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(kSplit), static_cast<unsigned>(channels),
                     static_cast<unsigned>(sectors));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(kSplit);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// One launch over units u = sector * channels + channel, a cluster of 8
// blocks each, on `stream` without synchronising.  The caller validates
// shapes, dtypes and offsets; cudaErrorInvalidValue for an m, cols or grid
// this body does not take.
template <class Src, bool kFused>
cudaError_t launch(const Src& src, const float* tab, const float* phi, const float* wd,
                   const float* ph, float* out, int sectors, int channels, int m, int n,
                   int cols, float salt, cudaStream_t stream) {
  const Geometry g(m);
  if (!g.ok || sectors <= 0 || sectors > 65535 || channels <= 0 || channels > 65535 || n <= 0 ||
      !cols_ok(cols)) {
    return cudaErrorInvalidValue;
  }
  const size_t smem = Layout(g.ms, g.L, g.P1, g.P2, cols, kFused, src.words(cols)).bytes();
  return dispatch<Src, kFused>(g.P, [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = launch_config(channels, sectors, smem, stream, attr);
    err = cudaLaunchKernelEx(&cfg, kernel, src, tab, phi, wd, ph, out, m, g.L, n, cols, salt);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
  });
}

// Resident blocks per SM and clusters of 8 the card holds at once
// (cudaOccupancyMaxActiveClusters) at (m, cols) for the source `src` (its
// staging buffer's size).
template <class Src, bool kFused>
cudaError_t occupancy(const Src& src, int m, int cols, int* blocks_per_sm, int* clusters) {
  const Geometry g(m);
  if (!g.ok || !cols_ok(cols)) return cudaErrorInvalidValue;
  const size_t smem = Layout(g.ms, g.L, g.P1, g.P2, cols, kFused, src.words(cols)).bytes();
  return dispatch<Src, kFused>(g.P, [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, smem);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = launch_config(1, 1, smem, nullptr, attr);
    return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  });
}

}  // namespace cluster
}  // namespace wrp
