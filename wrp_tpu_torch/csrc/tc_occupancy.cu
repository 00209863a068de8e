// The tensor-core occupancy probe, for NVIDIA Hopper (sm_90a): bf16 wgmma
// fed by TMA.
//
// Replaces the TPU kernel tools/mxu_occupancy.py (`pl.pallas_call` at :110,
// body `kern` at :96-106): matrix-unit throughput against dot width at the
// chain kernel's operand shapes.  Step b computes
//
//   out[b, :] = rowsum( sum_{d < ndots} A_d @ X[:, slab(b)] )
//
// for A [ndots_max, M, K] bf16 and X [K, distinct * wmax] bf16, slab(b) the
// `width` columns from column (b mod distinct) * wmax, ndots = lanes_total /
// width: the same multiply-adds per step at every width (M K lanes_total).
//
// What bounds it: 2 M K lanes_total flops a step, 1.208 GFLOP at 128 x 384
// x 12,288; 512 steps are 618 GFLOP, 0.625 ms at the data sheet's 989.4
// TFLOP/s dense bf16: the tensor cores.  Only wgmma reaches that rate on
// Hopper (mma.sync, this kernel's first form, reached a quarter of it).
// The feed: each element of X a block fetches meets the block's rows of A
// once; with the 128 rows of one A_d that is 128 multiply-adds, 128 FLOP a
// byte of X, and the card's peak would need ~7.7 TB/s of L2 reads, at or
// over what H100's L2 delivers.  So the design cuts the L2 bytes per
// multiply-add by keeping more rows of A resident.
//
// The work is never shortened: every multiply-add of M K lanes_total a step
// runs on the tensor cores.  The A_d are not pre-summed, X's row sums are
// not used, and the steps that reread a slab (`distinct` cycles them on
// purpose) reload and recompute it; a shortcut of that kind would make the
// probe measure nothing.  Only the order of the sums is free.
//
// Design:
//   * The dots stacked: rows d M + r of A_stack = A[:ndots] viewed as
//     [ndots M, K].  Step b's row r is the sum over d of the row sums of
//     rows d M + r of A_stack @ X[:, slab(b)], the same products in
//     another order.  A block holds kRows = 256 rows of A_stack resident in
//     shared memory (192 KB at K = 384), so every X element it fetches
//     meets 256 rows: 256 FLOP a byte of X, half the L2 bytes of one A_d a
//     block.  Rows past ndots M come in as zeros (TMA's fill), are
//     computed and never stored; so any M and any ndots M take one kernel.
//   * Units of work: (row block rb of A_stack, step b, column tile ct of
//     kBN = 128 columns of the slab), ordered rb, b, ct.  A persistent grid
//     (one block per SM, planned by the wrapper: ops/probes.tc_probe_plan)
//     gives block i the units [U i / G, U (i + 1) / G), so a block changes
//     row block at most a few times and loads A once per change.
//   * One producer warp issues TMA copies: A's row block in 64-deep chunks
//     (boxes of 64 x 256, the 128-byte swizzle), then each unit's X tile
//     in stages of kBK = 32 rows x 128 columns (two 64-column boxes), into
//     a kStages-deep mbarrier ring, running ahead across units.
//   * Two consumer warpgroups of 128 rows each run wgmma m64n128k16 bf16 ->
//     fp32 on two 64-row halves, A (K-major) and X (MN-major: the
//     transpose-B immediate, bf16 allows it) both read from shared memory
//     by descriptor.
//   * Accuracy: the tensor cores add into an accumulator with truncation,
//     which biases a long chain toward zero (tests/test_torch_stage2.py),
//     so a chain is one unit's K (24 k16 steps at K = 384, as the mma.sync
//     form chained): the unit's accumulators start from zero, and after
//     the unit their columns past `width` are dropped and the rest fold
//     into per-row sums in IEEE fp32 adds.  Consecutive units of one (rb,
//     b) keep folding into the same sums; when (rb, b) changes, a quad
//     shuffle finishes each row and one atomic add per row joins out[b, r]
//     (out is zeroed by the caller; the order of the atomics is free).
//
// Takes: M >= 1 (any), K % 16 == 0 and 16 <= K <= 384 (A's row block must
// fit shared memory), width % 8 == 0, wmax % 8 == 0, width <= wmax,
// ndots M <= 2^31 - 1, steps >= 1, distinct >= 1, blocks >= 1; 16-byte
// aligned operands.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper_async.cuh"

namespace {

constexpr int kConsumerWGs = 2;
constexpr int kRows = 128 * kConsumerWGs;   // rows of A_stack a block holds (two m64 a warpgroup)
constexpr int kConsumers = 128 * kConsumerWGs;
constexpr int kThreads = kConsumers + 32;   // + one producer warp
constexpr int kBN = 128;                    // columns of a unit (wgmma n128)
constexpr int kBK = 32;                     // X rows a stage
constexpr int kK16 = kBK / 16;              // k16 steps a stage
constexpr int kStages = 4;
constexpr int kKMax = 384;
constexpr int kAChunk = kRows * 128;        // one 64-deep chunk of the row block: 32 KB
constexpr int kXHalf = kBK * 128;           // 64 columns x kBK rows: 4 KB
constexpr int kStageBytes = 2 * kXHalf;

static_assert(kXHalf % 1024 == 0 && kAChunk % 1024 == 0, "swizzle atoms stay aligned");
static_assert(64 % kBK == 0, "a stage's k16 steps lie in one 64-deep chunk of A");

size_t smem_bytes(int K) {
  const int chunks = (K + 63) / 64;
  return 1024 /* alignment */ + static_cast<size_t>(chunks) * kAChunk +
         static_cast<size_t>(kStages) * kStageBytes + (2 * kStages + 2) * sizeof(uint64_t);
}

// D (+)= A B for the warpgroup: m64n128k16 bf16 -> fp32, A (K-major) and B
// (MN-major: imm-trans-b 1) from shared-memory descriptors; scale_d = 0
// ignores D's old value.
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// Add the unit's accumulator columns below `lim` into the row sums of rows
// g (s[0]) and g + 8 (s[1]): d[4 i + 0, 1] are row g, columns 8 i + 2c, +1;
// d[4 i + 2, 3] row g + 8.
__device__ __forceinline__ void fold(const float (&d)[64], float (&s)[2], int c, int lim) {
  if (lim >= kBN) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      s[0] += d[4 * i] + d[4 * i + 1];
      s[1] += d[4 * i + 2] + d[4 * i + 3];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int col = 8 * i + 2 * c;
      if (col < lim) {
        s[0] += d[4 * i];
        s[1] += d[4 * i + 2];
      }
      if (col + 1 < lim) {
        s[0] += d[4 * i + 1];
        s[1] += d[4 * i + 3];
      }
    }
  }
}

struct Unit {
  int rb, b, ct;
};

__device__ __forceinline__ Unit decode(long long u, int steps, int ctiles) {
  const long long t = u / ctiles;
  return {static_cast<int>(t / steps), static_cast<int>(t % steps),
          static_cast<int>(u - t * ctiles)};
}

__global__ void __launch_bounds__(kThreads, 1)
tc_dot_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_x,
              float* __restrict__ out, int M, int K, int width, int wmax, int distinct,
              int stacked_rows, int steps, int ctiles, long long units) {
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                       ~static_cast<uintptr_t>(1023));
  const int chunks = (K + 63) / 64;
  char* a_s = smem;                                   // [chunks][kRows][128 B]
  char* x_s = smem + static_cast<size_t>(chunks) * kAChunk;  // [kStages][2][kBK][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(x_s + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* a_full = empty + kStages;
  uint64_t* a_empty = a_full + 1;

  const int tid = static_cast<int>(threadIdx.x);
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kstages = (K + kBK - 1) / kBK;
  const long long u0 = units * blockIdx.x / gridDim.x;
  const long long u1 = units * (blockIdx.x + 1) / gridDim.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      wrp::mbar_init(&full[s], 1);
      wrp::mbar_init(&empty[s], kConsumers / 32);   // one arrival per consumer warp
    }
    wrp::mbar_init(a_full, 1);
    wrp::mbar_init(a_empty, kConsumers / 32);
    wrp::fence_mbar_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // the producer: lane 0 issues every copy, running ahead of the consumers
    if (lane == 0) {
      int cur_rb = -1, a_loads = 0;
      long long it = 0;
      for (long long u = u0; u < u1; ++u) {
        const Unit w = decode(u, steps, ctiles);
        if (w.rb != cur_rb) {
          // the previous row block's last reader has arrived
          if (a_loads > 0) wrp::mbar_wait(a_empty, (a_loads - 1) & 1);
          wrp::mbar_expect_tx(a_full, chunks * kAChunk);
          for (int kc = 0; kc < chunks; ++kc) {
            wrp::tma_2d(wrp::smem_u32(a_s + kc * kAChunk), &map_a, 64 * kc, w.rb * kRows, a_full);
          }
          cur_rb = w.rb;
          ++a_loads;
        }
        const int c0 = (w.b % distinct) * wmax + w.ct * kBN;
        for (int ks = 0; ks < kstages; ++ks, ++it) {
          const int s = static_cast<int>(it % kStages);
          wrp::mbar_wait(&empty[s], static_cast<int>((it / kStages) & 1) ^ 1);
          char* st = x_s + s * kStageBytes;
          wrp::mbar_expect_tx(&full[s], kStageBytes);
          wrp::tma_2d(wrp::smem_u32(st), &map_x, c0, ks * kBK, &full[s]);
          wrp::tma_2d(wrp::smem_u32(st + kXHalf), &map_x, c0 + 64, ks * kBK, &full[s]);
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg holds rows 128 wg .. 128 wg + 127 of the
  // row block, two m64 halves; warp q of it rows 16 q .. 16 q + 15 of each
  const int wg = warp >> 2;
  const int q = warp & 3;
  const int g = lane >> 2;
  const int c = lane & 3;
  const uint32_t a_base = wrp::smem_u32(a_s) + wg * 128 * 128;
  const uint32_t x_base = wrp::smem_u32(x_s);

  float acc0[64], acc1[64];
  float sums[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [half][row g, g + 8]
  int cur_rb = -1, a_uses = 0, sum_rb = -1, sum_b = -1;
  long long it = 0;

  // one atomic add per row of the finished (rb, b): the quad's lanes hold
  // a row's columns, xor 1 then xor 2
  auto flush = [&]() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = sums[h][e];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        sums[h][e] = 0.f;
        const int row = sum_rb * kRows + wg * 128 + h * 64 + q * 16 + e * 8 + g;
        if (c == 0 && row < stacked_rows) {
          atomicAdd(out + static_cast<size_t>(sum_b) * M + row % M, v);
        }
      }
    }
  };
  auto release = [&](long long i) {
    __syncwarp();
    if (lane == 0) wrp::mbar_arrive(&empty[i % kStages]);
  };

  for (long long u = u0; u < u1; ++u) {
    const Unit w = decode(u, steps, ctiles);
    if (sum_b >= 0 && (w.rb != sum_rb || w.b != sum_b)) flush();
    sum_rb = w.rb;
    sum_b = w.b;
    if (w.rb != cur_rb) {
      if (cur_rb >= 0) {  // every wgmma on the old row block has completed
        __syncwarp();
        if (lane == 0) wrp::mbar_arrive(a_empty);
      }
      wrp::mbar_wait(a_full, a_uses & 1);
      ++a_uses;
      cur_rb = w.rb;
    }
    for (int ks = 0; ks < kstages; ++ks, ++it) {
      const int s = static_cast<int>(it % kStages);
      wrp::mbar_wait(&full[s], static_cast<int>((it / kStages) & 1));
      wrp::wgmma_fence();
#pragma unroll
      for (int j = 0; j < kK16; ++j) {
        const int kk = kK16 * ks + j;  // the k16 step in K
        const uint32_t a_addr = a_base + (kk >> 2) * kAChunk + (kk & 3) * 32;
        const uint64_t db = wrp::sw128_desc(x_base + s * kStageBytes + j * 16 * 128, kXHalf, 1024);
        const int scale = kk > 0;
        wgmma_bf16(acc0, wrp::sw128_desc(a_addr, 16, 1024), db, scale);
        wgmma_bf16(acc1, wrp::sw128_desc(a_addr + 64 * 128, 16, 1024), db, scale);
      }
      wrp::wgmma_commit();
      if (ks > 0) {
        wrp::wgmma_wait<1>();  // the previous stage's products are done with it
        release(it - 1);
      }
    }
    wrp::wgmma_wait<0>();
    wrp::fence_regs(acc0);
    wrp::fence_regs(acc1);
    release(it - 1);
    const int lim = width - w.ct * kBN;
    fold(acc0, sums[0], c, lim);
    fold(acc1, sums[1], c, lim);
  }
  if (sum_b >= 0) flush();
}

}  // namespace

extern "C" {

// a [>= ndots, M, K] bf16, x [K, distinct * wmax] bf16, out [steps, M] float
// ZEROED by the caller; `blocks` persistent blocks (ops/probes.tc_probe_plan:
// at most one per SM, at most one per unit).  Takes the shapes in the note
// above.  Launches on `stream` without synchronising; returns the launch's
// cudaError_t (0 on success; cudaErrorInvalidValue for shapes it does not
// take).
int wrp_tc_dot_probe(const void* a, const void* x, void* out, int M, int K, int width, int wmax,
                     int distinct, int ndots, int steps, int blocks, void* stream) {
  if (M <= 0 || K < 16 || K % 16 != 0 || K > kKMax || width <= 0 || width % 8 != 0 ||
      width > wmax || wmax % 8 != 0 || distinct <= 0 || ndots <= 0 || steps <= 0 ||
      blocks <= 0 || static_cast<long long>(ndots) * M > 0x7fffffffLL ||
      static_cast<long long>(distinct) * wmax > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int stacked = ndots * M;
  const long long rblocks = (stacked + kRows - 1) / kRows;
  const int ctiles = (width + kBN - 1) / kBN;
  const long long units = rblocks * steps * ctiles;
  if (blocks > units) return static_cast<int>(cudaErrorInvalidValue);

  CUtensorMap map_a, map_x;
  cudaError_t err;
  if ((err = wrp::tensor_map_2d(&map_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, stacked, K, 64,
                                kRows)) != cudaSuccess ||
      (err = wrp::tensor_map_2d(&map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, K,
                                static_cast<long long>(distinct) * wmax, 64, kBK)) !=
          cudaSuccess) {
    return static_cast<int>(err);
  }
  const size_t smem = smem_bytes(K);
  err = cudaFuncSetAttribute(tc_dot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  tc_dot_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                  static_cast<cudaStream_t>(stream)>>>(map_a, map_x, static_cast<float*>(out), M,
                                                       K, width, wmax, distinct, stacked, steps,
                                                       ctiles, units);
  return static_cast<int>(cudaGetLastError());
}

// The units of a call, rb x steps x column tiles (the persistent grid's
// work), or -1 for shapes wrp_tc_dot_probe refuses.
long long wrp_tc_dot_probe_units(int M, int K, int width, int ndots, int steps) {
  if (M <= 0 || K < 16 || K % 16 != 0 || K > kKMax || width <= 0 || width % 8 != 0 ||
      ndots <= 0 || steps <= 0 || static_cast<long long>(ndots) * M > 0x7fffffffLL) {
    return -1;
  }
  const long long rblocks = (static_cast<long long>(ndots) * M + kRows - 1) / kRows;
  return rblocks * steps * ((width + kBN - 1) / kBN);
}

}  // extern "C"
