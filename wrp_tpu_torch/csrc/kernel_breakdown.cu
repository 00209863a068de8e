// The in-kernel time breakdown of the TPU algorithm's fused radix chain,
// for NVIDIA Hopper (sm_90a): its own arithmetic (bf16 hi/lo operands, the
// K-concatenated operator, fp32 accumulation) on the tensor cores, whole or
// with work removed.
//
// Replaces the TPU kernel tools/kernel_breakdown.py (`pl.pallas_call` at
// :158, body `kern` at :80-135): four ablations of the benchmark's salted
// radix offset kernel (wrp_tpu/ops/pallas/fullchain.py `_radix_contract`
// :551-666 with strided rows, layout "kcat", split "f32"; `_kernel_radix`
// :667), timed one against another to split its time among its parts.
// Per unit (one channel-sector, rows in natural order), for branches p < 8
// (rows p::8, M = m / 8 sub-DFT rows t) and the three Gauss products
// (re, im, re + im of x, salted in f32):
//
//   dots     X = [xh; xh; xh], xh = bf16(x): no lo planes; the 24 dots
//            m_g = A_pg @ X against the kcat operator [ah | ah | al]
//            (ops/probes.kcat_operator); g_p = (m1 - m2, m3 - m1 - m2);
//            row s M + t gets sum_j (Re + Im)(g_s + g_{s+4})[t, j]
//   splits   the same with the lo planes, X = [xh; xl; xh], xl = bf16(x - xh)
//   combine  Y_s = sum_p fac[s][p] g_p; the row sums of Yr + Yi
//   full     the Parseval epilogue of Y: the whole salted chain
//
// All four are instantiations of ONE body (`breakdown_kernel<kMode>`) on
// one grid with one dynamic shared memory, so at one occupancy: that is
// what makes the deltas mean something.  Beside them the matrix-form
// A-stage of radix_chain.cuh (fp32 SIMT), at its own shared memory and at
// this body's (min_smem).
//
// What bounds it: the bytes bound is the slab's int16 (100.7 MB per 48
// channel-sectors, 0.030 ms at 3.35 TB/s).  The matrix form's work is 24
// dots x 2 x 128 x 384 x 512 = 1.208 GFLOP per channel-sector (58 GFLOP
// per 48, 0.0586 ms at 989.4 TFLOP/s bf16), above the bytes.  The operator
// (8 x 3 x 128 x 384 bf16, 2.36 MB) is ten times a block's shared memory,
// so it streams from L2.  Timed by the SM's clock inside the kernel, a
// block spends the most time issuing and waiting on wgmma, then splitting
// x, then waiting for operator slots: no one part bounds it (PERF.md, #10).
//
// Design:
//   * Row halves are independent: Y[s M + t] needs rows t of the g_p only.
//     A block owns one half h (64 rows t, wgmma's m64) of one unit and a
//     tile of 64 pulses; the unit's n / 64 pulse tiles of one half form a
//     thread-block cluster (8 at n = 512) for the epilogue's merge: 96
//     (unit, half) items of 48 channel-sectors at 1 block per SM (226.5 KB
//     of shared memory).  The grid is persistent: as many clusters as the
//     card holds at once (cudaOccupancyMaxActiveClusters), each walking
//     its items, so the next item's x and first operator slots load while
//     the consumers merge the last one.
//   * A producer warpgroup (setmaxnreg 40; the consumers get 232) whose
//     first thread issues the TMA copies: per branch the int16 rows p::8 of
//     both planes for the tile (a 4-D box over x viewed as [unit x 2 +
//     plane, q, p, j]: [2, M, 64] int16, 32 KB), issued during the previous
//     branch; and the operator in slots of 24 KB, one 3-D box of the
//     operator viewed as [R x 3, M, 3M] holding the three Gauss products'
//     64 t x 64 k chunks of one K chunk (128-byte swizzle), through a
//     4-slot mbarrier ring (a branch's slots at M = 128).  The kcat operator
//     [ah | ah | al] holds ah twice: a branch loads the ah chunks once and
//     meets them with xh and then xl, then the al chunks with xh, the
//     products of [ah | ah | al] @ [xh; xl; xh] from 2/3 of its bytes.
//     One slot a K chunk ran faster than one 8 KB chunk a slot (a third of
//     the barrier round trips).  Multicasting each slot to the cluster (one
//     issuer a slot, every block's consumers releasing it remotely) cuts
//     the L2 reads but ran slower in pairs, quads and the whole cluster:
//     every slot then waits for the slowest block (the coupling that
//     multicasting Y met in fused_stage2).
//   * Two consumer warpgroups of 32 pulses each.  At a branch's start they
//     add the salt in f32, split to bf16 hi/lo in registers (_split_bf16's
//     rounding, to nearest even) and write six planes [M q][64 j] (hi, lo
//     of re, im, re + im) with the 128-byte swizzle; `dots` writes the hi
//     planes only and reads them where the lo planes would be.  The
//     [xh; xl; xh] stack is never built: each K chunk's descriptor points
//     at its plane.  (Three warps of the producer warpgroup splitting the
//     next half-branch into a second buffer while the consumers compute
//     ran slower: 96 threads split slower than the tensor cores consume.)
//   * `wgmma` m64n32k16 bf16 -> fp32: A (the operator, K-major) and B (a
//     plane, MN-major through the transpose-B immediate, the warpgroup's 32
//     pulses at a 64-byte offset into the swizzled rows) from shared memory.
//     The three Gauss products' chains are interleaved step by step, so the
//     tensor cores always hold three independent accumulations (one
//     product at a time ran slower).
//   * Accuracy: each Gauss product is one chain of 3M / 16 k16 steps from
//     zero (24 at M = 128); the tensor cores' truncating adds bias long
//     chains (PERF.md), so no chain runs over branches.  m1 - m2, m3 - m1 -
//     m2 and Y_s += fac[s][p] g_p are IEEE fp32 in registers: Y (4 S x 16
//     values a thread, re and im) never touches shared memory.
//   * The row reductions: each warpgroup reduces its 32 pulses of every
//     row with quad shuffles (for `full`: q = Y wd, its tile mean, the sum
//     of |q - mean|^2 and the four phasor projections of q - mean: the
//     epilogue of chain_common.cuh's parseval_row_power, mean subtracted
//     explicitly).  The tiles' stats go to shared memory (over the x
//     planes, free by then) and block r of the cluster merges rows [r per,
//     (r + 1) per) of all 2K tiles (per = ceil(256 / K), the last block's
//     range cut at 256) over distributed shared memory: sums for the
//     ablations, Chan's merge for `full` (E = sum E_T + 32 sum |mu_T -
//     mu|^2, the projections shifted by (mu_T - mu) Phi_T with Phi_T the
//     tile's phasor sums from the host).
//
// Takes: radix 8, M = m / 8 = 64 or 128, n % 64 == 0 and 64 <= n <= 512,
// 1 <= bc <= 65535, int16 x with 2 x staged units < 2^31; 16-byte aligned
// operands (ops/probes.breakdown_refusal says the same in Python).

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "hopper_async.cuh"
#include "radix_chain.cuh"

namespace cg = cooperative_groups;

namespace {

enum Mode : int { kFull = 0, kDots = 1, kSplits = 2, kCombine = 3 };

constexpr int kR = 8;
constexpr int kS = 4;
constexpr int kTile = 64;                    // pulses a block
constexpr int kHalf = 64;                    // sub-DFT rows t a block
constexpr int kWgCols = 32;                  // pulses a consumer warpgroup
constexpr int kConsumers = 256;              // two warpgroups
constexpr int kBlock = kConsumers + 128;     // + the producer warpgroup
constexpr int kProducerRegs = 40;            // setmaxnreg: 128 x 40 + 256 x 232 <= 64 K
constexpr int kConsumerRegs = 232;
constexpr int kChunk = kHalf * 128;          // 64 t x 64 k bf16: 8 KB
constexpr int kSlot = 3 * kChunk;            // a K chunk of the three Gauss products
constexpr int kStages = 4;                   // slots in the ring: a whole branch at M = 128
constexpr int kMaxCluster = 8;
constexpr int kRowsBlock = kS * kHalf;       // rows s M + t of a block: 256
constexpr int kStat = 12;                    // floats of a (tile, row) stat (probes.BD_STAT)

// The dynamic shared memory at M = m / 8, every mode alike (mirrored by
// ops/probes.fused_smem_bytes): alignment, the ring, six x planes [M][64]
// bf16, the int16 staging [2][M][64], the tile's window and phasors, the
// barriers.
struct Layout {
  int M;
  __host__ __device__ size_t plane() const { return static_cast<size_t>(M) * kTile * 2; }
  __host__ __device__ size_t planes() const { return static_cast<size_t>(kStages) * kSlot; }
  __host__ __device__ size_t staging() const { return planes() + 6 * plane(); }
  __host__ __device__ size_t consts() const { return staging() + 2 * plane(); }
  __host__ __device__ size_t barriers() const { return consts() + 5 * kTile * sizeof(float); }
  __host__ __device__ size_t bytes() const { return 1024 + barriers() + 256; }
};

// D (+)= A B for the warpgroup: m64n32k16 bf16 -> fp32, A (K-major) and B
// (MN-major: imm-trans-b 1) from shared-memory descriptors; scale_d = 0
// ignores D's old value.
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// the 256 consumer threads only (named barrier 1; 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// every thread of the cluster's blocks (barrier.cluster without .aligned:
// the producer and consumer branches each arrive from their own code)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// the sum over the quad (the 4 lanes holding one accumulator row)
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// the sum over 8 lanes (one row of the cluster merge)
__device__ __forceinline__ float oct_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  return v;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The int16 staging of one branch [2][M][64] -> the bf16 planes (hi, lo of
// re, im, re + im; only the hi planes without lo), salted in f32, in the
// 128-byte swizzle: row q's 16-byte chunk c at c ^ (q & 7).
template <bool kLo>
__device__ __forceinline__ void split_branch(const int16_t* stage, char* planes, size_t plane,
                                             int M, float salt, int tid) {
  for (int item = tid; item < M * 8; item += kConsumers) {
    const int q = item >> 3;
    const int ch = item & 7;
    const uint4 rw = *reinterpret_cast<const uint4*>(stage + q * kTile + ch * 8);
    const uint4 iw = *reinterpret_cast<const uint4*>(stage + (M + q) * kTile + ch * 8);
    const int16_t* r16 = reinterpret_cast<const int16_t*>(&rw);
    const int16_t* i16 = reinterpret_cast<const int16_t*>(&iw);
    uint32_t out[6][4];
#pragma unroll
    for (int k = 0; k < 8; k += 2) {
      float v[3][2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        v[0][e] = static_cast<float>(r16[k + e]) + salt;
        v[1][e] = static_cast<float>(i16[k + e]) + salt;
        v[2][e] = v[0][e] + v[1][e];
      }
#pragma unroll
      for (int g = 0; g < 3; ++g) {
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[g][0], v[g][1]);
        out[2 * g][k / 2] = *reinterpret_cast<const uint32_t*>(&hi);
        if constexpr (kLo) {
          const float2 hf = __bfloat1622float2(hi);
          out[2 * g + 1][k / 2] = pack_bf16(v[g][0] - hf.x, v[g][1] - hf.y);
        }
      }
    }
    const size_t at = static_cast<size_t>(q) * 128 + ((ch ^ (q & 7)) << 4);
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      if (kLo || k % 2 == 0) {
        *reinterpret_cast<uint4*>(planes + k * plane + at) =
            make_uint4(out[k][0], out[k][1], out[k][2], out[k][3]);
      }
    }
  }
}

// x [units_total, 2, m, n] int16 through map_x (4-D: j, p, q, unit x 2 +
// plane), the operator [8 x 3 x M, 3M] bf16 through map_a; fac [S, R, 2],
// wd [n], ph [4, n], phi [n / 32, 4] f32; out [bc, m/2] f32.
template <int kMode>
__global__ void __launch_bounds__(kBlock, 1)
breakdown_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_x, const float* __restrict__ fac,
                 const float* __restrict__ wd, const float* __restrict__ ph,
                 const float* __restrict__ phi, float* __restrict__ out, int m, int n,
                 int bc, int offset, float salt) {
  constexpr bool kLo = kMode != kDots;
  constexpr bool kY = kMode == kCombine || kMode == kFull;
  extern __shared__ __align__(16) char smem_raw[];
  char* smem = reinterpret_cast<char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                       ~static_cast<uintptr_t>(1023));
  const int M = m / kR;
  const Layout lay{M};
  const size_t plane = lay.plane();
  char* ring = smem;                           // the operator ring, first
  char* planes = smem + lay.planes();
  auto* stage = reinterpret_cast<int16_t*>(smem + lay.staging());
  auto* cs = reinterpret_cast<float*>(smem + lay.consts());   // wd [64], ph [4][64]
  auto* full = reinterpret_cast<uint64_t*>(smem + lay.barriers());
  uint64_t* empty = full + kStages;
  uint64_t* xfull = empty + kStages;
  uint64_t* xempty = xfull + 1;

  const int tid = static_cast<int>(threadIdx.x);
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int tile = static_cast<int>(blockIdx.x);   // the block's rank in its cluster
  // the cluster's items: (unit u, half h) = (i / halves, i % halves) for
  // i = blockIdx.y, blockIdx.y + gridDim.y, ... (a persistent grid)
  const int halves = M / kHalf;
  const int items = bc * halves;
  const int nitems = (items - static_cast<int>(blockIdx.y) + static_cast<int>(gridDim.y) - 1) /
                     static_cast<int>(gridDim.y);
  const int j0 = tile * kTile;
  const int kq = M / 64;              // 64-row chunks of a plane
  const int kslots = 2 * kq;          // operator slots of a branch: ah, then al

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      wrp::mbar_init(&full[s], 1);
      wrp::mbar_init(&empty[s], kConsumers / 32);   // one arrival per consumer warp
    }
    wrp::mbar_init(xfull, 1);
    wrp::mbar_init(xempty, kConsumers / 32);
    wrp::fence_mbar_init();
  }
  for (int k = tid; k < 5 * kTile; k += kBlock) {
    const int r = k / kTile;
    const int j = k - r * kTile;
    cs[k] = r == 0 ? wd[j0 + j] : ph[static_cast<size_t>(r - 1) * n + j0 + j];
  }
  __syncthreads();

  if (warp >= kConsumers / 32) {
    // the producer warpgroup: lane 0 of its first warp issues every copy,
    // running ahead of the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp == kConsumers / 32 && lane == 0) {
      auto load_x = [&](int i, int p) {
        wrp::mbar_expect_tx(xfull, static_cast<int>(2 * plane));
        wrp::tma_4d(wrp::smem_u32(stage), &map_x, j0, p, 0, 2 * (offset + i / halves), xfull);
      };
      load_x(static_cast<int>(blockIdx.y), 0);
      int it = 0, br = 0;   // slots and branches issued
      // slot order: item, branch p, the ah chunks of each q half, then the
      // al chunks; a slot holds the three Gauss products' chunks [3][64
      // t][64 k], one box of the operator viewed as [R x 3, M, 3M].  The
      // next item's first branch fills the ring while the consumers merge
      for (int r = 0; r < nitems; ++r) {
        const int i = static_cast<int>(blockIdx.y) + r * static_cast<int>(gridDim.y);
        const int h = i % halves;
        for (int p = 0; p < kR; ++p, ++br) {
          for (int k = 0; k < kslots; ++k, ++it) {
            const int s = it % kStages;
            const int col = k < kq ? 64 * k : 2 * M + 64 * (k - kq);   // ah, then al
            wrp::mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
            wrp::mbar_expect_tx(&full[s], kSlot);
            wrp::tma_3d(wrp::smem_u32(ring + s * kSlot), &map_a, col, h * kHalf, 3 * p,
                        &full[s]);
          }
          if (r > 0 && p == 0) {
            cluster_sync();   // the previous item's stats are written
            cluster_sync();   // and merged
          }
          if (p + 1 < kR || r + 1 < nitems) {
            wrp::mbar_wait(xempty, br & 1);   // this branch's staging is split
            if (p + 1 < kR) {
              load_x(i, p + 1);
            } else {
              load_x(i + static_cast<int>(gridDim.y), 0);
            }
          }
        }
      }
      cluster_sync();
      cluster_sync();
    } else {
      for (int r = 0; r < nitems; ++r) {
        cluster_sync();
        cluster_sync();
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    // the consumers: warpgroup wg holds pulses j0 + 32 wg .. + 31; warp wq
    // of it rows t = 16 wq .. 16 wq + 15 of the half (accumulator rows g8,
    // g8 + 8 of its m16), columns 8 i + 2 c4 + {0, 1}
    const int wg = warp >> 2;
    const int wq = warp & 3;
    const int g8 = lane >> 2;
    const int c4 = lane & 3;
    const uint32_t ring_u = wrp::smem_u32(ring);
    const uint32_t planes_u = wrp::smem_u32(planes);

    float acc[3][16];   // each chain starts from zero (scale_d = 0)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[0][e] = acc[1][e] = acc[2][e] = 0.f;
    auto release = [&](int i) {
      __syncwarp();
      if (lane == 0) wrp::mbar_arrive(&empty[i % kStages]);
    };

    int it = 0, br = 0;
#pragma unroll 1
    for (int r = 0; r < nitems; ++r) {
      const int i = static_cast<int>(blockIdx.y) + r * static_cast<int>(gridDim.y);
      const int u = i / halves;
      const int h = i % halves;
      float yr[kS][16], yi[kS][16];
      float sums[kS][2];
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        sums[s][0] = sums[s][1] = 0.f;
#pragma unroll
        for (int e = 0; e < 16; ++e) yr[s][e] = yi[s][e] = 0.f;
      }
#pragma unroll 1
      for (int p = 0; p < kR; ++p, ++br) {
        wrp::mbar_wait(xfull, br & 1);
        consumers_sync();   // both warpgroups' wgmma on branch p - 1's planes are done
        split_branch<kLo>(stage, planes, plane, M, salt, tid);
        wrp::fence_proxy_async();   // the planes' plain stores before wgmma reads them
        consumers_sync();
        if (lane == 0) wrp::mbar_arrive(xempty);

        // slot k of the three Gauss products: three independent chains of
        // k16 steps, interleaved so the tensor cores always hold work.  The
        // kcat operator [ah | ah | al] holds ah twice: an ah slot (k < kq,
        // rows q of q half k) meets xh and then xl, an al slot xh; the same
        // products as [ah | ah | al] @ [xh; xl; xh], from 2/3 of its bytes
#pragma unroll 1
        for (int k = 0; k < kslots; ++k, ++it) {
          const bool ah = k < kq;
          const uint32_t brow = (ah ? k : k - kq) * 64 * 128 + wg * 64;
          const int s = it % kStages;
          wrp::mbar_wait(&full[s], (it / kStages) & 1);
          uint32_t a0[3], bh[3], bl[3];
#pragma unroll
          for (int g = 0; g < 3; ++g) {
            a0[g] = ring_u + s * kSlot + g * kChunk;
            bh[g] = planes_u + 2 * g * static_cast<uint32_t>(plane) + brow;
            bl[g] = bh[g] + (kLo ? static_cast<uint32_t>(plane) : 0u);
          }
          wrp::wgmma_fence();
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int g = 0; g < 3; ++g) {
              wgmma_n32(acc[g], wrp::sw128_desc(a0[g] + j * 32, 16, 1024),
                        wrp::sw128_desc(bh[g] + j * 16 * 128, static_cast<uint32_t>(plane), 1024),
                        (k > 0 || j > 0) ? 1 : 0);
            }
          }
          if (ah) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
#pragma unroll
              for (int g = 0; g < 3; ++g) {
                wgmma_n32(acc[g], wrp::sw128_desc(a0[g] + j * 32, 16, 1024),
                          wrp::sw128_desc(bl[g] + j * 16 * 128, static_cast<uint32_t>(plane), 1024),
                          1);
              }
            }
          }
          wrp::wgmma_commit();
          if (k > 0) {
            wrp::wgmma_wait<1>();   // the previous K chunk's products are done with it
            release(it - 1);
          }
        }
        wrp::wgmma_wait<0>();
        wrp::fence_regs(acc[0]);
        wrp::fence_regs(acc[1]);
        wrp::fence_regs(acc[2]);
        release(it - 1);

        // g_p = (m1 - m2, m3 - m1 - m2), then the mode's use of it, in IEEE fp32
        if constexpr (kY) {
#pragma unroll
          for (int s = 0; s < kS; ++s) {
            const float fr = __ldg(fac + (s * kR + p) * 2);
            const float fi = __ldg(fac + (s * kR + p) * 2 + 1);
#pragma unroll
            for (int e = 0; e < 16; ++e) {
              const float gr = acc[0][e] - acc[1][e];
              const float gi = acc[2][e] - acc[0][e] - acc[1][e];
              yr[s][e] += fr * gr - fi * gi;
              yi[s][e] += fr * gi + fi * gr;
            }
          }
        } else {
          float r0 = 0.f, r1 = 0.f;   // rows g8, g8 + 8 of the thread's columns
#pragma unroll
          for (int e = 0; e < 16; ++e) {
            const float gr = acc[0][e] - acc[1][e];
            const float gi = acc[2][e] - acc[0][e] - acc[1][e];
            if (e & 2) {
              r1 += gr + gi;
            } else {
              r0 += gr + gi;
            }
          }
          const int sp = p & (kS - 1);
#pragma unroll
          for (int s = 0; s < kS; ++s) {
            if (s == sp) {
              sums[s][0] += r0;
              sums[s][1] += r1;
            }
          }
        }
      }

      // each warpgroup's stats of its 32 pulses, per row, over the x planes
      consumers_sync();   // every wgmma has read its planes
      float* st = reinterpret_cast<float*>(planes) + static_cast<size_t>(wg) * kRowsBlock * kStat;
#pragma unroll
      for (int s = 0; s < kS; ++s) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int row = s * kHalf + wq * 16 + g8 + 8 * rr;
          float* dst = st + row * kStat;
          if constexpr (kMode == kFull) {
            float qr[8], qi[8], sr = 0.f, si = 0.f;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
              for (int b = 0; b < 2; ++b) {
                const int e = 4 * i + 2 * rr + b;
                const float w = cs[wg * kWgCols + 8 * i + 2 * c4 + b];
                qr[2 * i + b] = yr[s][e] * w;
                qi[2 * i + b] = yi[s][e] * w;
                sr += qr[2 * i + b];
                si += qi[2 * i + b];
              }
            }
            const float mr = quad_sum(sr) / kWgCols;
            const float mi = quad_sum(si) / kWgCols;
            float e2 = 0.f, d[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
#pragma unroll
              for (int b = 0; b < 2; ++b) {
                const int col = wg * kWgCols + 8 * i + 2 * c4 + b;
                const float ar = qr[2 * i + b] - mr;
                const float ai = qi[2 * i + b] - mi;
                e2 += ar * ar + ai * ai;
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                  const float f = cs[(1 + k) * kTile + col];
                  d[k] += ar * f;
                  d[4 + k] += ai * f;
                }
              }
            }
            e2 = quad_sum(e2);
#pragma unroll
            for (int k = 0; k < 8; ++k) d[k] = quad_sum(d[k]);
            if (c4 == 0) {
              dst[0] = mr;
              dst[1] = mi;
              dst[2] = e2;
#pragma unroll
              for (int k = 0; k < 8; ++k) dst[3 + k] = d[k];
            }
          } else {
            float v = 0.f;
            if constexpr (kMode == kCombine) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
#pragma unroll
                for (int b = 0; b < 2; ++b) {
                  const int e = 4 * i + 2 * rr + b;
                  v += yr[s][e] + yi[s][e];
                }
              }
            } else {
              v = sums[s][rr];
            }
            v = quad_sum(v);
            if (c4 == 0) dst[0] = v;
          }
        }
      }

      // the cluster's merge: block r owns rows [r per, min((r + 1) per, 256))
      // of its half, per = ceil(256 / K) (K = 3, 5, 6, 7 leave the last
      // block fewer); lane `sub` of a row's 8 reads tiles 2 sub and 2 sub + 1
      // (block sub's two warpgroups).  A row past the block's end reads
      // nothing and writes nothing, but its lanes still join the shuffles.
      // Inside the consumers' branch, so it runs under their register
      // count, not the producer's
      cluster_sync();
      cg::cluster_group cluster = cg::this_cluster();
      const int K = static_cast<int>(gridDim.x);
      const int per = (kRowsBlock + K - 1) / K;
      const int row_end = min((tile + 1) * per, kRowsBlock);
      const int sub = tid & 7;
      const float* mine = sub < K ? cluster.map_shared_rank(reinterpret_cast<float*>(planes), sub)
                                  : nullptr;
      for (int base = 0; base < per; base += kConsumers / 8) {
        const int row = tile * per + base + (tid >> 3);
        const float* peer = row < row_end ? mine : nullptr;
        const float* s0 = peer ? peer + row * kStat : nullptr;
        const float* s1 = peer ? peer + (kRowsBlock + row) * kStat : nullptr;
        float pw;
        if constexpr (kMode == kFull) {
          // both tiles' stats and phasor sums first, as 16-byte loads issued
          // together (remote shared memory answers slowly: one at a time the
          // merge took longer than the whole epilogue)
          float st[2][12], f[2][4];
#pragma unroll
          for (int w = 0; w < 2; ++w) {
#pragma unroll
            for (int v = 0; v < 3; ++v) {
              const float4 q = peer ? reinterpret_cast<const float4*>(w ? s1 : s0)[v]
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
              st[w][4 * v] = q.x;
              st[w][4 * v + 1] = q.y;
              st[w][4 * v + 2] = q.z;
              st[w][4 * v + 3] = q.w;
            }
            // tile 2 sub + w's phasor sums
            const float4 q = peer ? reinterpret_cast<const float4*>(phi)[2 * sub + w]
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
            f[w][0] = q.x;
            f[w][1] = q.y;
            f[w][2] = q.z;
            f[w][3] = q.w;
          }
          const int ntiles = 2 * K;
          const float mr = oct_sum(st[0][0] + st[1][0]) / ntiles;
          const float mi = oct_sum(st[0][1] + st[1][1]) / ntiles;
          float e2 = 0.f, d[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
          if (peer) {
#pragma unroll
            for (int w = 0; w < 2; ++w) {
              const float dr = st[w][0] - mr;
              const float di = st[w][1] - mi;
              e2 += st[w][2] + static_cast<float>(kWgCols) * (dr * dr + di * di);
#pragma unroll
              for (int k = 0; k < 4; ++k) {
                d[k] += st[w][3 + k] + dr * f[w][k];
                d[4 + k] += st[w][7 + k] + di * f[w][k];
              }
            }
          }
          e2 = oct_sum(e2);
#pragma unroll
          for (int k = 0; k < 8; ++k) d[k] = oct_sum(d[k]);
          pw = static_cast<float>(n) * e2;
          // |q . f_k|^2 = (qr.cos - qi.sin)^2 + (qr.sin + qi.cos)^2, k = k1, k2
#pragma unroll
          for (int k = 0; k < 4; k += 2) {
            const float re = d[k] - d[4 + k + 1];
            const float im = d[k + 1] + d[4 + k];
            pw -= re * re + im * im;
          }
        } else {
          pw = oct_sum(peer ? s0[0] + s1[0] : 0.f);
        }
        if (sub == 0 && row < row_end) {
          const int s = row / kHalf;
          const int t = row - s * kHalf;
          out[static_cast<size_t>(u) * (m / 2) + s * M + h * kHalf + t] = pw;
        }
      }
      cluster_sync();   // peers' shared memory stays until every block has read it
    }
  }
}

template <int kMode>
cudaError_t launch_mode(const CUtensorMap& map_a, const CUtensorMap& map_x, const float* fac,
                        const float* wd, const float* ph, const float* phi, float* out, int bc,
                        int m, int n, int offset, float salt, cudaStream_t stream) {
  const size_t smem = Layout{m / kR}.bytes();
  auto kernel = breakdown_kernel<kMode>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int tiles = n / kTile;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles), 1u, 1u);
  cfg.blockDim = dim3(kBlock);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(tiles);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // a persistent grid: as many clusters as the card holds at once, never
  // more than the (unit, half) items
  static int cached_m = 0, cached_n = 0, cached_clusters = 0;
  if (cached_m != m || cached_n != n) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters <= 0) return cudaErrorInvalidConfiguration;
    cached_m = m;
    cached_n = n;
    cached_clusters = clusters;
  }
  const int items = bc * (m / kR / kHalf);
  cfg.gridDim.y = static_cast<unsigned>(items < cached_clusters ? items : cached_clusters);
  err = cudaLaunchKernelEx(&cfg, kernel, map_a, map_x, fac, wd, ph, phi, out, m, n, bc, offset,
                           salt);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int kMode>
cudaError_t blocks_mode(int m, int* blocks) {
  const size_t smem = Layout{m / kR}.bytes();
  auto kernel = breakdown_kernel<kMode>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, kBlock, smem);
}

bool takes(int m, int n) {
  return m % kR == 0 && (m / kR == 64 || m / kR == 128) && n % kTile == 0 && n >= kTile &&
         n <= kTile * kMaxCluster;
}

}  // namespace

extern "C" {

// One mode (0 full, 1 dots, 2 splits, 3 combine) on bc units from unit
// `offset` of x [units_total, 2, m, n] int16: a [8, 3, M, 3M] bf16 (the kcat
// operator), fac [4, 8, 2], wd [n], ph [4, n], phi [n / 32, 4] f32, out
// [bc, m/2] f32.  Launches on `stream` without synchronising; returns the
// launch's cudaError_t (0 on success; cudaErrorInvalidValue for shapes it
// does not take).
int wrp_breakdown(const void* x, const void* a, const void* fac, const void* wd, const void* ph,
                  const void* phi, void* out, long long units_total, int bc, int m, int n,
                  long long offset, int salt, int mode, void* stream) {
  if (!takes(m, n) || bc <= 0 || bc > 65535 || offset < 0 || offset + bc > units_total ||
      2 * units_total > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int M = m / kR;
  CUtensorMap map_a, map_x;
  // the operator viewed as [8 x 3 (branch, product)][M (t)][3M (k)] bf16
  const cuuint64_t adims[3] = {static_cast<cuuint64_t>(3 * M), static_cast<cuuint64_t>(M),
                               3 * kR};
  const cuuint64_t astrides[2] = {static_cast<cuuint64_t>(3 * M) * 2,
                                  static_cast<cuuint64_t>(3 * M) * M * 2};
  const cuuint32_t abox[3] = {64, kHalf, 3};
  cudaError_t err = wrp::tensor_map_nd(&map_a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, a, adims,
                                       astrides, abox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return static_cast<int>(err);
  // x viewed as [unit x 2 + plane][q][p][j]: row R q + p of a plane (the
  // copy moves bytes, so the int16 samples travel as uint16)
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(n), kR, static_cast<cuuint64_t>(M),
                              static_cast<cuuint64_t>(2 * units_total)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(n) * 2,
                                 static_cast<cuuint64_t>(kR) * n * 2,
                                 static_cast<cuuint64_t>(m) * n * 2};
  const cuuint32_t box[4] = {kTile, 1, static_cast<cuuint32_t>(M), 2};
  err = wrp::tensor_map_nd(&map_x, CU_TENSOR_MAP_DATA_TYPE_UINT16, 4, x, dims, strides, box,
                           CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* ff = static_cast<const float*>(fac);
  const auto* wf = static_cast<const float*>(wd);
  const auto* pf = static_cast<const float*>(ph);
  const auto* hf = static_cast<const float*>(phi);
  auto* of = static_cast<float*>(out);
  const auto off = static_cast<int>(offset);
  const auto sf = static_cast<float>(salt);
  auto st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFull: return static_cast<int>(launch_mode<kFull>(map_a, map_x, ff, wf, pf, hf, of, bc, m, n, off, sf, st));
    case kDots: return static_cast<int>(launch_mode<kDots>(map_a, map_x, ff, wf, pf, hf, of, bc, m, n, off, sf, st));
    case kSplits: return static_cast<int>(launch_mode<kSplits>(map_a, map_x, ff, wf, pf, hf, of, bc, m, n, off, sf, st));
    case kCombine: return static_cast<int>(launch_mode<kCombine>(map_a, map_x, ff, wf, pf, hf, of, bc, m, n, off, sf, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Resident blocks per SM of mode `mode` at (m, n), at its dynamic shared
// memory.
int wrp_breakdown_blocks_per_sm(int mode, int m, int n, int* blocks) {
  if (!takes(m, n)) return static_cast<int>(cudaErrorInvalidValue);
  switch (mode) {
    case kFull: return static_cast<int>(blocks_mode<kFull>(m, blocks));
    case kDots: return static_cast<int>(blocks_mode<kDots>(m, blocks));
    case kSplits: return static_cast<int>(blocks_mode<kSplits>(m, blocks));
    case kCombine: return static_cast<int>(blocks_mode<kCombine>(m, blocks));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The matrix-form A-stage on x [bc, 2, m, w] int16 -> y [bc, 2, m/2, w]
// float, with at least min_smem bytes of dynamic shared memory requested
// per block (the kernel uses only its 8 KB operator slice).
int wrp_radix_chain_astage(const void* x, const void* a, const void* fac, void* y, int bc,
                           int m, int w, int radix, int tile, long long min_smem,
                           void* stream) {
  return static_cast<int>(wrp::launch_radix_astage(
      radix, tile, wrp::PlanarSource<int16_t>{static_cast<const int16_t*>(x), m, w},
      static_cast<const float*>(a), static_cast<const float*>(fac), static_cast<float*>(y), bc,
      m, w, static_cast<cudaStream_t>(stream), static_cast<size_t>(min_smem)));
}

// Resident blocks per SM of the A-stage at (radix, tile, m), at its dynamic
// shared memory or min_smem bytes, whichever is more.
int wrp_radix_chain_astage_blocks_per_sm(int radix, int tile, int m, long long min_smem,
                                         int* blocks) {
  return static_cast<int>(wrp::radix_astage_blocks_per_sm<wrp::PlanarSource<int16_t>>(
      radix, tile, m, static_cast<size_t>(min_smem), blocks));
}

}  // extern "C"
