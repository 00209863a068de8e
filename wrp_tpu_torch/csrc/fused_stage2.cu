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
// one factor, tap_sum, and the kernel is a GEMM with a row-reduction
// epilogue of |Z|^2: Z never leaves registers.  B is an operand, so the
// kernel assumes nothing of its structure.
//
// What bounds it on this card: the product's 8 n flops per element of Y
// (51.5 GFLOP for 48 channel-sectors of 512 x 512) against 8 bytes per
// element of Y read: n = 512 flops per byte, far above every ridge, so the
// multiply rate bounds it.  On the fp32 CUDA cores that is 0.769 ms; so the
// product runs on the TF32 tensor cores (495 TFLOP/s dense) with the TPU
// kernel's own split-precision idea (its _dot3, bf16 x 3) in TF32: each
// fp32 operand x = hi + lo, both TF32 values (11 significant bits; see the
// split below); Z = hi_Y hi_B + hi_Y lo_B + lo_Y hi_B in fp32 accumulators
// (the lo lo term, ~2^-21 relative, is dropped).  3 x 51.5 = 154.6 GFLOP:
// 0.312 ms at the TF32 peak.  (The function's least work, the Doppler
// transform as an FFT, is bound by the bytes; chip_smoke.py's bound counts
// that.)
//
// Design:
//   * The real form: one real GEMM, A = [Yr | Yi] (K = 2n) times
//     B2 = [[Br, Bi], [-Bi, Br]] (2n x 2n) = [Zr | Zi].  A small kernel
//     (real_operator_kernel) writes B2's transpose once per call, K-major
//     ([column][k], each half of K padded to the depth tile; 4 MB at
//     n = 512), into the caller's scratch.
//   * The split.  Y: x = hi + lo, hi = x rounded to TF32 (cvt.rna), lo the
//     remainder rounded, in registers: |x - hi - lo| <= 2^-22 |x|.  B: the
//     tensor cores read a TF32 operand's top 19 bits, so B's fp32 tile as
//     loaded is its hi, truncated to TF32, and each stage computes the lo
//     plane rna(b - hi) in shared memory: |b - hi - lo| <= 2^-21 |b|.  One
//     fp32 plane of B crosses from L2 instead of two (the loads bind this
//     kernel before the tensor cores do).
//   * The GEMM: a block owns kBM = 192 rows of Y (all channel-sectors' rows
//     are one flat matrix) and kBN = 128 columns of Z per tile; each of its
//     three warpgroups runs wgmma m64n128k8 TF32 on 64 of the rows, fp32
//     accumulators in registers, the Y fragment from registers (ldmatrix),
//     B's hi and lo tiles read by the tensor cores from shared memory.
//     Three warpgroups hide more of each other's waits (below) than two,
//     and reread B for more rows.
//   * The loads: one thread copies each stage's Y and B tiles with TMA
//     (no other thread spends registers or issue slots on them, which ran
//     faster than every thread issuing 16-byte cp.async), three stages
//     ahead in a 4-stage ring; a stage's mbarrier counts the bytes
//     landed.  Tiles are 128-byte rows with the 128-byte swizzle (ldmatrix
//     XORs the 16-byte chunk with row % 8; the wgmma descriptor names the
//     swizzle).  A block walks all the column tiles of its rows, so no sum
//     leaves it.  (Multicasting Y to the blocks of a cluster that split
//     the columns, so Y crosses from L2 once, ran slower: every block then
//     waits for the slowest of its cluster at every stage.)
//   * Accuracy: the tensor cores add into their accumulator with
//     truncation, which biases a long chain of adds toward zero: with all
//     of K in one accumulator the power misses its plain version's 1e-6
//     (tests/test_torch_stage2.py emulates the truncation: a chain over K
//     misses it, a chain of two k8 steps holds it).  So the products of
//     two k8 steps (6 wgmma, the first from zero) join the running sum
//     through IEEE fp32 adds.  A warpgroup waits for its chain before adding it (a
//     plain instruction reading an accumulator of a running wgmma makes
//     ptxas serialize every wgmma); the other warpgroups' chains run
//     meanwhile.
//   * The epilogue: a column tile's |Z|^2 is folded into per-row sums in
//     registers (a warp holds all 128 columns of its 16 rows), tile after
//     tile, then over the quad's lanes.  Every sum has a fixed order: the
//     result is deterministic and independent of the caller's row
//     blocking.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper_async.cuh"

namespace {

constexpr int kWarpgroups = 3;
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kBM = 64 * kWarpgroups;  // rows of Z per block (64 per warpgroup)
constexpr int kBN = 128;               // columns of Z per tile (wgmma n128)
constexpr int kBK = 32;                // depth per stage: one 128-byte row of fp32
constexpr int kStages = 4;
constexpr int kChain = 2;              // k8 steps per chain of accumulating wgmma
constexpr int kYBytes = kBM * kBK * 4;                     // the Y tile
constexpr int kBBytes = kBN * kBK * 4;                     // one B plane's tile
constexpr int kStageBytes = kYBytes + 2 * kBBytes;         // Y, B hi, B lo
constexpr size_t kSmemBytes = 1024 /* alignment */ + static_cast<size_t>(kStages) * kStageBytes +
                              kStages * sizeof(uint64_t);

static_assert(kBK % (8 * kChain) == 0, "whole chains per stage");
static_assert(kYBytes % 1024 == 0 && kBBytes % 1024 == 0, "swizzle atoms stay aligned");

using wrp::smem_u32;

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, each a TF32 value in an fp32 word (the low 13 bits zero)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// Byte offset of 16-byte chunk q of row r in a tile of 128-byte rows with
// the 128-byte swizzle (TMA's CU_TENSOR_MAP_SWIZZLE_128B, tile 1024-byte
// aligned): the chunk index XORed with r % 8.
__device__ __forceinline__ uint32_t swz(int r, int q) {
  return static_cast<uint32_t>(r * 128 + ((q ^ (r & 7)) << 4));
}

// Four 8 x 8 b16 matrices from shared memory (ldmatrix .x4): 8 rows of 4
// 32-bit words each, lane l addressing row l % 8 of matrix l / 8; lane l
// receives word l % 4 of row l / 4 of each, r[i] from matrix i: the TF32
// A fragment's element order (the PTX ISA's m16n8k8 .tf32 layout, which
// wgmma's A in registers repeats per warp).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The shared-memory descriptor of a K-major B tile with the 128-byte
// swizzle: 128-byte rows (all kBK of a column), 8-row atoms 1024 bytes
// apart (stride byte offset); a k8 step starts 32 bytes on in the row.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return wrp::sw128_desc(addr, 16, 1024);
}

// D (+)= A B for the warpgroup: m64n128k8, A (TF32) from registers, B from
// the descriptor; scale_d = 0 ignores D's old value.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
// wait until no committed wgmma group is in flight; d is read only after
__device__ __forceinline__ void wgmma_wait_all(float (&d)[64]) {
  wrp::wgmma_wait<0>();
  wrp::fence_regs(d);
}

// B2^T: bt[j][h kh + k] (j < np_ columns, h = 0, 1 the halves of K, k <
// kh = n rounded up to kBK) = B2[h n + k][j]: Br[k][j], Bi[k][j - n],
// -Bi[k][j], Br[k][j - n] by quadrant; zero past n in a half and past 2n
// columns.  A 32 x 32 tile per block, transposed through shared memory so
// both the reads and the writes are coalesced.
__global__ void __launch_bounds__(256)
real_operator_kernel(const float* __restrict__ br, const float* __restrict__ bi,
                     float* __restrict__ bt, int n, int kh) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32;
  const int j0 = blockIdx.y * 32;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;              // 8 rows a pass
  for (int i = ty; i < 32; i += 8) {
    const int kk = k0 + i;
    const int h = kk / kh;
    const int k = kk - h * kh;
    const int j = j0 + tx;
    float v = 0.f;
    if (k < n && j < 2 * n) {
      const size_t at = static_cast<size_t>(k) * n + (j < n ? j : j - n);
      if (h == 0) {
        v = j < n ? br[at] : bi[at];
      } else {
        v = j < n ? -bi[at] : br[at];
      }
    }
    tile[i][tx] = v;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    bt[static_cast<size_t>(j0 + i) * (2 * kh) + k0 + tx] = tile[tx][i];
  }
}

// One chain: kChain k8 steps from depth k0 of the stage (Y at ys, B hi at
// bh, B lo at bl: shared addresses), three products each (lo hi, hi lo,
// hi hi), the first from zero, into d; committed as one wgmma group.  B's
// hi is its fp32 tile as loaded (the tensor cores read the top 19 bits of
// a TF32 operand: B truncated to TF32), its lo the stage's plane from
// split_stage.  a_row: this lane's ldmatrix row, a_q its chunk offset.
__device__ __forceinline__ void chain(float (&d)[64], uint32_t ys, uint32_t bh, uint32_t bl,
                                      int a_row, int a_q, int k0) {
  uint32_t a_hi[kChain][4], a_lo[kChain][4];
#pragma unroll
  for (int s = 0; s < kChain; ++s) {
    uint32_t v[4];
    ldmatrix_x4(v, ys + swz(a_row, (k0 + 8 * s) / 4 + a_q));
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(v[e]), a_hi[s][e], a_lo[s][e]);
  }
  wrp::wgmma_fence();                           // A and d were written by plain instructions
#pragma unroll
  for (int s = 0; s < kChain; ++s) {
    const uint32_t kb = (k0 + 8 * s) * 4;       // the k8 step's bytes into each row
    wgmma_tf32(d, a_lo[s], b_desc(bh + kb), s > 0);
    wgmma_tf32(d, a_hi[s], b_desc(bl + kb), 1);
    wgmma_tf32(d, a_hi[s], b_desc(bh + kb), 1);
  }
  wrp::wgmma_commit();
}

// The stage's B lo plane: lo = rna(b - trunc(b)), trunc(b) the TF32 value
// the tensor cores read from b's word (its low 13 bits cleared); b - trunc(b)
// is exact, so b = trunc(b) + lo to 2^-21 |b|.  Elementwise, so the
// swizzled layout carries over.
__device__ __forceinline__ void split_stage(const char* bh_ptr, char* bl_ptr) {
  const float4* bh = reinterpret_cast<const float4*>(bh_ptr);
  float4* bl = reinterpret_cast<float4*>(bl_ptr);
  auto lo = [](float x) {
    return __uint_as_float(tf32_rna(x - __uint_as_float(__float_as_uint(x) & 0xFFFFE000u)));
  };
  for (int i = static_cast<int>(threadIdx.x); i < kBBytes / 16; i += kThreads) {
    const float4 v = bh[i];
    bl[i] = make_float4(lo(v.x), lo(v.y), lo(v.z), lo(v.w));
  }
}

// Grid: one block per kBM rows, walking every column tile.  Y is [Yr | Yi]
// through two tensor maps (boxes of kBK columns x kBM rows), B2^T through
// one (kBK x kBN); the depth tiles run over Yr's kh / kBK, then Yi's.
__global__ void __launch_bounds__(kThreads, 1)
fused_stage2_kernel(const __grid_constant__ CUtensorMap map_yr,
                    const __grid_constant__ CUtensorMap map_yi,
                    const __grid_constant__ CUtensorMap map_bt, float* __restrict__ out,
                    long long total_rows, int n, int kh, float tap_sum) {
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                       ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kStages * kStageBytes);   // [kStages]

  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int wrow = (warp >> 2) * 64 + (warp & 3) * 16;   // the warp's 16 rows
  const int r0 = static_cast<int>(blockIdx.x) * kBM;
  const int ntiles = (2 * n + kBN - 1) / kBN;
  const int khalf = kh / kBK;                   // depth tiles of each half of K
  const int ktiles = 2 * khalf;
  const int total = ntiles * ktiles;            // the block's depth tiles in all
  // ldmatrix: lane l addresses row (l % 8) + 8 ((l / 8) % 2), chunk l / 16
  const int a_row = wrow + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int a_q = lane >> 4;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) wrp::mbar_init(&full[s], 1);
    wrp::fence_mbar_init();
  }
  __syncthreads();

  // the copies of depth tile `it` (the block's sequence) into its stage;
  // the stage's last reader finished before the __syncthreads that ended
  // its iteration
  auto issue = [&](int it) {
    const int s = it % kStages;
    const int tile = it / ktiles;
    const int kt = it - tile * ktiles;
    const int half = kt / khalf;
    const int col = (kt - half * khalf) * kBK;
    char* st = smem + s * kStageBytes;
    wrp::mbar_expect_tx(&full[s], kYBytes + kBBytes);
    wrp::tma_2d(smem_u32(st), half ? &map_yi : &map_yr, col, r0, &full[s]);
    wrp::tma_2d(smem_u32(st + kYBytes), &map_bt, half * kh + col, tile * kBN, &full[s]);
  };
  if (tid == 0) {
    for (int it = 0; it < kStages - 1 && it < total; ++it) issue(it);
  }

  float rows[2] = {0.f, 0.f};                   // |Z|^2 sums of rows g, g + 8
  for (int tile = 0; tile < ntiles; ++tile) {
    float acc[64], d[64];                       // the running sums; one chain
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = d[i] = 0.f;
    for (int kt = 0; kt < ktiles; ++kt) {
      const int it = tile * ktiles + kt;
      if (tid == 0 && it + kStages - 1 < total) issue(it + kStages - 1);
      const int s = it % kStages;
      char* st = smem + s * kStageBytes;
      wrp::mbar_wait(&full[s], (it / kStages) & 1);  // Y and B landed
      split_stage(st + kYBytes, st + kYBytes + kBBytes);
      wrp::fence_proxy_async();
      __syncthreads();                          // the lo plane is written
      const uint32_t ys = smem_u32(st);
#pragma unroll
      for (int k0 = 0; k0 < kBK; k0 += 8 * kChain) {
        chain(d, ys, ys + kYBytes, ys + kYBytes + kBBytes, a_row, a_q, k0);
        wgmma_wait_all(d);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += d[i];
      }
      wrp::fence_proxy_async();
      __syncthreads();                          // every warpgroup is done with stage s
    }
    // |Z|^2 of this tile into the rows: acc[4 i + 0, 1] are row g, columns
    // 8 i + 2c, + 1; acc[4 i + 2, 3] row g + 8 (columns past 2n are zero)
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      rows[0] += acc[4 * i] * acc[4 * i] + acc[4 * i + 1] * acc[4 * i + 1];
      rows[1] += acc[4 * i + 2] * acc[4 * i + 2] + acc[4 * i + 3] * acc[4 * i + 3];
    }
  }

  // the quad's lanes hold one row's columns: xor 1, then xor 2
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = rows[h];
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    const long long row = static_cast<long long>(r0) + wrow + h * 8 + g;
    if (c == 0 && row < total_rows) out[row] = tap_sum * v;
  }
}

// A 2-D fp32 tensor map of rows x cols (row pitch cols), boxes of box_rows
// x kBK with the 128-byte swizzle; reads past the edges give zeros.
cudaError_t tensor_map(CUtensorMap* map, const void* base, long long rows, int cols,
                       int box_rows) {
  return wrp::tensor_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sizeof(float), base, rows, cols,
                            kBK, box_rows);
}

}  // namespace

extern "C" {

// yr, yi [total_rows, n] float (all channel-sectors' rows, contiguous,
// 16-byte aligned), br, bi [n, n] float, out [total_rows] float; n % 4 == 0.
// scratch: `scratch_floats` floats for B's real form, [np_][kp] with np_ =
// 2n rounded up to the column tile kBN = 128 and kp = 2 (n rounded up to
// the depth tile kBK = 32); too few return cudaErrorInvalidValue.  Two
// launches on `stream` without synchronising: the real operator, then the
// GEMM.  Returns the first failure's cudaError_t (0 on success).  The
// caller validates shapes and dtypes.
int wrp_fused_stage2(const void* yr, const void* yi, const void* br, const void* bi,
                     void* scratch, long long scratch_floats, void* out, long long total_rows,
                     int n, float tap_sum, void* stream) {
  if (total_rows <= 0 || n <= 0 || n % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = (total_rows + kBM - 1) / kBM;
  if (total_rows > 0x7fffffffLL - kBM) return static_cast<int>(cudaErrorInvalidValue);
  const int np_ = (2 * n + kBN - 1) / kBN * kBN;
  const int kp = 2 * ((n + kBK - 1) / kBK * kBK);
  if (scratch_floats < static_cast<long long>(np_) * kp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int kh = kp / 2;
  auto st = static_cast<cudaStream_t>(stream);
  auto* bt = static_cast<float*>(scratch);
  real_operator_kernel<<<dim3(static_cast<unsigned>(kp / 32), static_cast<unsigned>(np_ / 32)),
                         256, 0, st>>>(static_cast<const float*>(br),
                                       static_cast<const float*>(bi), bt, n, kh);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  CUtensorMap map_yr, map_yi, map_bt;
  if ((err = tensor_map(&map_yr, yr, total_rows, n, kBM)) != cudaSuccess ||
      (err = tensor_map(&map_yi, yi, total_rows, n, kBM)) != cudaSuccess ||
      (err = tensor_map(&map_bt, bt, np_, kp, kBN)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  err = cudaFuncSetAttribute(fused_stage2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_stage2_kernel<<<static_cast<unsigned>(groups), kThreads, kSmemBytes, st>>>(
      map_yr, map_yi, map_bt, static_cast<float*>(out), total_rows, n, kh, tap_sum);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
