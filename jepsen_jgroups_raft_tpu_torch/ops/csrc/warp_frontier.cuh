// The warp-per-history skeleton shared by the port's scan kernels
// (dense_scan.cu, mask_scan.cu): the event-row constants, the chunk
// carry's head (also sort_scan.cu's), the per-warp ring of rows staged
// ahead with `cp.async`, the register layout of a frontier bitset and
// the FORCE over it.
//
// Frontier layout. A frontier of 2^(W+LF) bits (W window slots, a field
// of 2^LF bits per mask; the mask-mode scan has LF = 0) is spread over
// one warp's registers: bit b lives at
//     b[0..4]    bit in a 32-bit word
//     b[5..9]    lane
//     b[10..12]  word index in the lane's register array
// so mask bit w, at b[LF + w], is reached by a shift inside a word, a
// `__shfl_xor_sync` between lanes, or a move between registers. Small
// frontiers leave lanes or words empty: those lanes run the same code on
// zero words, and every transform maps zero to zero.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxOpens = 16;   // MACRO_MAX_OPENS
constexpr int kRowPitch = 3 + 4 * kMaxOpens + 1;  // ring row stride, ints
constexpr int kRingDepth = 8;   // rows staged per warp
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

constexpr int32_t kEvOpen = 1;
constexpr int32_t kEvForce = 2;

// The scalars every chunk carry row starts with, in this order
// (ops/kernel_ir.py CARRY_HEAD); each kernel's fields follow.
constexpr int kCarryOk = 0;
constexpr int kCarryOverflow = 1;
constexpr int kCarryDirty = 2;
constexpr int kCarryLeft = 3;
constexpr int kCarryHead = 4;

// Write a carry row's scalars and, when flags is not null, history h's
// four chunk flags flags[k * B + h]: decided (= !ok), exhausted (left <=
// 0), ok, overflow.
__device__ __forceinline__ void write_head(int32_t* cout, uint8_t* flags,
                                           int h, int B, bool ok,
                                           bool overflow, bool dirty,
                                           int left) {
  cout[kCarryOk] = ok ? 1 : 0;
  cout[kCarryOverflow] = overflow ? 1 : 0;
  cout[kCarryDirty] = dirty ? 1 : 0;
  cout[kCarryLeft] = left;
  if (flags != nullptr) {
    const size_t b = static_cast<size_t>(B);
    flags[h] = ok ? 0 : 1;
    flags[b + h] = left <= 0 ? 1 : 0;
    flags[2 * b + h] = ok ? 1 : 0;
    flags[3 * b + h] = overflow ? 1 : 0;
  }
}

// Bits of a word whose position has bit p clear (p < 5): the fields of
// the masks without the in-word mask bit at p.
__host__ __device__ constexpr uint32_t low_half(int p) {
  return p == 0 ? 0x55555555u
       : p == 1 ? 0x33333333u
       : p == 2 ? 0x0f0f0f0fu
       : p == 3 ? 0x00ff00ffu
                : 0x0000ffffu;
}

template <int W, int LF>
struct Layout {
  static constexpr int kBits = W + LF;  // log2 of the frontier's bits
  static constexpr int kWords = kBits > 10 ? 1 << (kBits - 10) : 1;
  static constexpr int kFS = 1 << LF;
};

// FORCE over a register-word mask bit b[10 + k]: words j without the bit
// take words j | bit, which are cleared. Returns this lane's survivors.
template <int W, int LF, int k>
__device__ __forceinline__ uint32_t force_words(
    uint32_t (&F)[Layout<W, LF>::kWords]) {
  uint32_t live = 0;
#pragma unroll
  for (int j = 0; j < Layout<W, LF>::kWords; ++j) {
    if (!((j >> k) & 1)) {
      live |= F[j | (1 << k)];
      F[j] = F[j | (1 << k)];
      F[j | (1 << k)] = 0;
    }
  }
  return live;
}

// FORCE slot w (already clipped to [0, W)): a survivor must hold bit w;
// the bit-w half moves down onto the other and is cleared. In-word and
// lane bits take the slot as a runtime shift or shuffle mask; register
// words branch (warp-uniformly) to their compile-time move. Returns
// "some survivor" (warp-wide).
template <int W, int LF>
__device__ __forceinline__ bool force(uint32_t (&F)[Layout<W, LF>::kWords],
                                      int w, int lane) {
  constexpr int kWords = Layout<W, LF>::kWords;
  const int p = LF + w;
  uint32_t live = 0;
  if (p < 5) {
    const uint32_t lo = p == 0 ? low_half(0) : p == 1 ? low_half(1)
                      : p == 2 ? low_half(2) : p == 3 ? low_half(3)
                                                      : low_half(4);
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      live |= F[j] & ~lo;
      F[j] = (F[j] >> (1 << p)) & lo;
    }
  } else if (p < 10) {
    const int x = 1 << (p - 5);
    const bool has = lane & x;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      live |= has ? F[j] : 0u;
      const uint32_t up = __shfl_xor_sync(kFull, F[j], x);
      F[j] = has ? 0u : up;
    }
  } else if constexpr (kWords > 1) {
    if (p == 10) live = force_words<W, LF, 0>(F);
    if constexpr (kWords > 2) {
      if (p == 11) live = force_words<W, LF, 1>(F);
    }
    if constexpr (kWords > 4) {
      if (p == 12) live = force_words<W, LF, 2>(F);
    }
  }
  return __any_sync(kFull, live != 0);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy row e of a history's rows `ev` (R ints each) into its slot of the
// warp's ring (nothing past the history's n_rows) and close a cp.async
// group either way, so group counts stay uniform: lane i copies int i.
__device__ __forceinline__ void stage_row(int32_t (*ring)[kRowPitch],
                                          const int32_t* ev, int e,
                                          int n_rows, int R, int lane) {
  if (e < n_rows) {
    const int32_t* src = ev + static_cast<size_t>(e) * R;
    int32_t* dst = ring[e % kRingDepth];
    for (int i = lane; i < R; i += 32) cp_async4(dst + i, src + i);
  }
  cp_async_commit();
}

}  // namespace
