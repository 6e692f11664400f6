// The dense-domain frontier's transforms, shared by the dense scan
// (dense_scan.cu) and the segmented scan (segment_scan.cu): a frontier
// F[2^W, S] kept in one warp's registers (warp_frontier.cuh's layout),
// each mask's S states a field of FS = 2^LF bits. Here: the caps, the
// transition row of one source state under a latched op, a closure
// sweep's slot images and the closure to fixpoint. dense_scan.cu's
// header comment sets out the design.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#include "models.cuh"
#include "warp_frontier.cuh"

namespace {

constexpr int kMaxSlots = 10;   // DENSE_MAX_SLOTS
constexpr int kMaxStates = 16;  // DENSE_MAX_STATES
constexpr int kMaxCells = 8192; // DENSE_MAX_CELLS = 2^W * S

// Bit 0 of every FS-bit field of a word.
__host__ __device__ constexpr uint32_t field_unit(int lf) {
  return lf == 0 ? 0xffffffffu
       : lf == 1 ? 0x55555555u
       : lf == 2 ? 0x11111111u
       : lf == 3 ? 0x01010101u
                 : 0x00010001u;
}

// Every field of x mapped through slot w's rows t[0..FS).
template <int LF>
__device__ __forceinline__ uint32_t apply_rows(uint32_t x,
                                               const uint32_t* t) {
  constexpr uint32_t unit = field_unit(LF);
  uint32_t y = 0;
#pragma unroll
  for (int s = 0; s < (1 << LF); ++s) y |= ((x >> s) & unit) * t[s];
  return y;
}

// Slot w's image in a closure sweep: T_w(F[m]) for every mask m without
// bit w, placed at m | bit_w and OR-ed into `add`. `on` is all ones when
// slot w is open and zero when it is closed (a closed slot adds nothing;
// its rows may be stale).
template <int W, int LF, int w>
__device__ __forceinline__ void slot_image(
    const uint32_t (&F)[Layout<W, LF>::kWords],
    uint32_t (&add)[Layout<W, LF>::kWords], const uint32_t* t, uint32_t on,
    int lane) {
  constexpr int p = LF + w;
  constexpr int kWords = Layout<W, LF>::kWords;
  if constexpr (p < 5) {
    constexpr uint32_t lo = low_half(p);
#pragma unroll
    for (int j = 0; j < kWords; ++j)
      add[j] |= (apply_rows<LF>(F[j] & lo, t) << (1 << p)) & on;
  } else if constexpr (p < 10) {
    constexpr int k = p - 5;
    const uint32_t dst = ((lane >> k) & 1) ? on : 0u;
#pragma unroll
    for (int j = 0; j < kWords; ++j)
      add[j] |= __shfl_xor_sync(kFull, apply_rows<LF>(F[j], t), 1 << k) & dst;
  } else {
    constexpr int k = p - 10;
#pragma unroll
    for (int j = 0; j < kWords; ++j)
      if (!((j >> k) & 1)) add[j | (1 << k)] |= apply_rows<LF>(F[j], t) & on;
  }
}

// The images of every slot, all from the same frontier F.
template <int W, int LF, int w = 0>
__device__ __forceinline__ void sweep_images(
    const uint32_t (&F)[Layout<W, LF>::kWords],
    uint32_t (&add)[Layout<W, LF>::kWords],
    uint32_t (*T)[Layout<W, LF>::kFS], unsigned open, int lane) {
  if constexpr (w < W) {
    slot_image<W, LF, w>(F, add, T[w], ((open >> w) & 1u) ? kFull : 0u,
                         lane);
    sweep_images<W, LF, w + 1>(F, add, T, open, lane);
  }
}

// Closure to fixpoint: each sweep adds every open slot's image of the
// frontier it starts from, until a sweep adds nothing, in at most W + 1
// sweeps (the reference's bound).
template <int W, int LF>
__device__ __forceinline__ void closure(
    uint32_t (&F)[Layout<W, LF>::kWords],
    uint32_t (*T)[Layout<W, LF>::kFS], unsigned open, int lane) {
  constexpr int kWords = Layout<W, LF>::kWords;
  for (int it = 0; it <= W; ++it) {
    uint32_t add[kWords];
#pragma unroll
    for (int j = 0; j < kWords; ++j) add[j] = 0u;
    sweep_images<W, LF>(F, add, T, open, lane);
    uint32_t fresh = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      fresh |= add[j] & ~F[j];
      F[j] |= add[j];
    }
    if (!__any_sync(kFull, fresh != 0)) break;
  }
}

// Transition row of source state s under op (f, a, b): every state id
// s' < S whose value is the step's result (duplicates in the padded
// table all light up), or nothing when illegal or s >= S.
template <int LF>
__device__ __forceinline__ uint32_t transition_row(
    const int32_t (&vals)[1 << LF], int S, int s, int32_t f, int32_t a,
    int32_t b, int model) {
  int32_t v = vals[0];
#pragma unroll
  for (int s2 = 1; s2 < (1 << LF); ++s2) v = (s == s2) ? vals[s2] : v;
  int32_t next;
  bool legal;
  model_step(model, v, f, a, b, &next, &legal);
  uint32_t bits = 0;
#pragma unroll
  for (int s2 = 0; s2 < (1 << LF); ++s2)
    bits |= (s2 < S && vals[s2] == next) ? 1u << s2 : 0u;
  return (legal && s < S) ? bits : 0u;
}

}  // namespace
