// Fused radar chain on raw wire words, stages 01-08, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel wrp_tpu/ops/pallas/fullchain.py::
// fused_chain_power_wire (body _kernel_radix_wire, decode decode_words_iq).
// Per sector it maps the wire words w [m, L] (int32, L = ch n, rows in
// NATURAL order; word ch j + c of a row is channel c, pulse j) to the
// matched-filter power pow [ch, m/2] through the FFT-form kernel of
// fft_chain.cuh (its math, bound and design are described there), with
// the wire load policy: each block owns one channel of one sector and a
// chunk of its pulses, reads its channel's words at stride ch and decodes
// each in registers, I = sext((b0 << 8) | b1), Q = sext((b2 << 8) | b3)
// (chain_common.cuh decode_word), so the host decoder's channel
// deinterleave never happens.  The wire IS the int16 payload: the kernel
// reads no more bytes than the planar one.  Grid (blocks, ch, bs): a
// sector's channels, which read the same 32-byte sectors of each row, are
// adjacent clusters and run side by side.  Every channel shares the planar
// window and phasors (wd [n], ph [4, n]).
//
// `offset` (sectors) starts the launch `offset` sectors into a larger
// staged array: the benchmark's unsalted offset entry, applied as pointer
// arithmetic (the TPU's scalar-prefetch index map).  The salted entry
// (fused_chain_wire_salted.cu) launches the same instantiation.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "fft_chain.cuh"

namespace wrp {

// The wire fused chain with `salt` added to every decoded sample (0: none).
cudaError_t fused_chain_wire(const void* w, const void* tab, const void* phi, const void* wd,
                             const void* ph, void* out, int bs, int m, int n, int ch, int cols,
                             int blocks, long long offset, float salt, void* stream) {
  const size_t skip = static_cast<size_t>(offset) * m * ch * n;  // words
  return fft::launch_fused(fft::WireIq{static_cast<const int32_t*>(w) + skip, m, n, ch},
                           static_cast<const float*>(tab), static_cast<const float*>(phi),
                           static_cast<const float*>(wd), static_cast<const float*>(ph),
                           static_cast<float*>(out), bs, ch, m, n, cols, blocks, salt,
                           static_cast<cudaStream_t>(stream));
}

}  // namespace wrp

extern "C" {

// w [>= offset + bs, m, ch n] int32, tab the plan's fft_tables, phi its
// round phasor sums, wd [n], ph [4, n] float, out [bs, ch, m/2] float.
// Launches on `stream` without synchronising; returns the launch's
// cudaError_t (0 on success).  The caller validates shapes, dtypes and the
// offset's range.
int wrp_fused_chain_wire(const void* w, const void* tab, const void* phi, const void* wd,
                         const void* ph, void* out, int bs, int m, int n, int ch, int cols,
                         int blocks, long long offset, void* stream) {
  return static_cast<int>(wrp::fused_chain_wire(w, tab, phi, wd, ph, out, bs, m, n, ch, cols,
                                                blocks, offset, 0.f, stream));
}

// Resident blocks per SM and clusters of `blocks` blocks the card holds at
// once of the wire fused kernel at (m, cols).
int wrp_fused_chain_wire_occupancy(int m, int cols, int blocks, int* blocks_per_sm,
                                   int* clusters) {
  return static_cast<int>(
      wrp::fft::occupancy<wrp::fft::WireIq, true>(wrp::fft::WireIq{nullptr, m, 0, 1}, m, cols,
                                                  blocks, blocks_per_sm, clusters));
}

}  // extern "C"
