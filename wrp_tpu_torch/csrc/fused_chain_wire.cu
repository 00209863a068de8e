// Fused radar chain on raw wire words, stages 01-08, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel wrp_tpu/ops/pallas/fullchain.py::
// fused_chain_power_wire (body _kernel_radix_wire, decode decode_words_iq).
// Per sector it maps the wire words w [m, L] (int32, L = ch n, rows in
// NATURAL order; word ch j + c of a row is channel c, pulse j) to the
// matched-filter power pow [ch, m/2] through the radix-R kernel of
// radix_chain.cuh (its math, bound and design are described there), with
// the wire load policy: one block per (sector, channel, tile) reads its
// channel's words at stride ch and decodes each in registers,
// I = sext((b0 << 8) | b1), Q = sext((b2 << 8) | b3)
// (chain_common.cuh decode_word), so the host decoder's channel
// deinterleave never happens.  The wire IS the int16 payload: the kernel
// reads no more bytes than the planar one.  The epilogue's window and
// phasors arrive channel-tiled (wd_il [L], ph_il [4, L],
// ops/fullchain.wire_lane_consts) and are read at the channel's lanes.
//
// `offset` (sectors) starts the launch `offset` sectors into a larger
// staged array: the benchmark's unsalted offset entry, applied as pointer
// arithmetic (the TPU's scalar-prefetch index map).

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "radix_chain.cuh"

extern "C" {

// w [>= offset + bs, m, ch n] int32, a [R, M, M, 2], fac [S, R, 2],
// wd [ch n], ph [4, ch n] float, out [bs, ch, m/2] float.  Launches on
// `stream` without synchronising; returns the launch's cudaError_t (0 on
// success).  The caller validates shapes, dtypes and the offset's range.
int wrp_fused_chain_wire(const void* w, const void* a, const void* fac, const void* wd,
                         const void* ph, void* out, int bs, int m, int n, int ch, int radix,
                         int tile, long long offset, void* stream) {
  const size_t skip = static_cast<size_t>(offset) * m * ch * n;  // words
  const cudaError_t err = wrp::launch_radix_chain(
      radix, tile, wrp::WireSource{static_cast<const int32_t*>(w) + skip, m, n, ch},
      static_cast<const float*>(a), static_cast<const float*>(fac),
      static_cast<const float*>(wd), static_cast<const float*>(ph), static_cast<float*>(out),
      bs, ch, m, n, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

}  // extern "C"
