// Segmented long-history scan for Hopper (sm_90a): one warp per
// (segment, seed) pair, the frontier in registers.
//
// Replaces the TPU-side program jepsen_jgroups_raft_tpu/ops/
// segment_scan.py `make_segment_kernel` (segment_scan.py:188): a long
// history is cut at quiescent boundaries into K segments
// (ops/segment_scan.py `plan_segments`), and every segment is scanned
// from each configuration (mask, state) of its seed basis. Each run is
// the dense-domain scan of dense_scan.cu with three changes:
//
// * seeded: the frontier F[2^W, S] starts as the one configuration
//   (seed_mask, seed_state) instead of (0, initial state); a padded
//   seed (seed_mask < 0, or a mask or state outside the frontier)
//   starts empty, and an empty frontier stays empty, so such a warp
//   writes zeros and exits at once;
// * the whole final frontier is the result, written bit-packed: word g
//   of a run holds frontier bits b = m * FS + s in [32 g, 32 g + 32),
//   the register layout of warp_frontier.cuh read in lane order, so
//   lane l writes its register word j as word 32 j + l;
// * legacy rows only (5 ints: type, slot, f, a, b) — the segment
//   planner reasons about single events, as the reference's does.
//
// The run stops at the segment's real length (its prologue of re-OPEN
// rows plus its slice; the rest of the row block is EV_PAD) or as soon
// as a FORCE leaves no survivor (the frontier is then all zeros, and
// stays so). Everything else is dense_scan.cu's event loop, bit for
// bit: transition rows latched per OPEN into the warp's shared memory
// (one source state per lane), closure to fixpoint only at a FORCE
// after an OPEN (`dirty`) — the prologue's OPENs set it, so the first
// FORCE of a segment closes over the crashed slots the seed holds —,
// FORCE kill and shift, slots clipped to [0, W) at FORCE, duplicate
// ids of a padded val_of all lighting up (transition_row). The
// frontier transforms are shared with dense_scan.cu
// (dense_frontier.cuh), the layout, FORCE and row ring with every scan
// kernel (warp_frontier.cuh).
//
// The warps of one segment read the same rows; each stages them into
// its own ring (sharing a segment's staged rows between its seeds'
// warps is later work). A block holds kWarpsPerBlock runs; nothing in
// it is shared between warps.

#include <cstdint>
#include <cuda_runtime.h>

#include "dense_frontier.cuh"
#include "models.cuh"
#include "warp_frontier.cuh"

namespace {

template <int W, int LF>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 1)
    segment_scan_warp(const int32_t* __restrict__ events,
                      const int32_t* __restrict__ val_of,
                      const int32_t* __restrict__ seed_mask,
                      const int32_t* __restrict__ seed_state,
                      const int32_t* __restrict__ n_events,
                      uint32_t* __restrict__ out, int K, int NB, int E,
                      int S, int model) {
  constexpr int kFS = Layout<W, LF>::kFS;
  constexpr int kWords = Layout<W, LF>::kWords;
  constexpr int kOutWords = (1 << (W + LF)) > 32 ? (1 << (W + LF)) / 32 : 1;
  __shared__ int32_t ring_all[kWarpsPerBlock][kRingDepth][kRowPitch];
  __shared__ uint32_t T_all[kWarpsPerBlock][W][kFS];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // K * NB < 2^31 (the launcher checks): 32-bit indices, so no 64-bit
  // division subroutine (and no stack frame) in the kernel
  const int run = blockIdx.x * kWarpsPerBlock + warp;
  if (run >= K * NB) return;  // warp-uniform
  const int k = run / NB;
  int32_t (*ring)[kRowPitch] = ring_all[warp];
  uint32_t (*T)[kFS] = T_all[warp];

  // the seed: one frontier bit b = m0 * FS + s0, held by one lane
  const int32_t m0 = seed_mask[run];
  const int32_t s0 = seed_state[run];
  bool alive = m0 >= 0 && m0 < (1 << W) && s0 >= 0 && s0 < S;
  const int b = alive ? (m0 << LF) | s0 : 0;
  const bool mine = alive && lane == ((b >> 5) & 31);
  uint32_t F[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j)
    F[j] = (mine && j == (b >> 10)) ? 1u << (b & 31) : 0u;

  if (alive) {
    const int32_t* ev = events + static_cast<size_t>(k) * E * 5;
    const int n_rows = min(max(n_events[k], 0), E);
#pragma unroll
    for (int e = 0; e < kRingDepth - 1; ++e)
      stage_row(ring, ev, e, n_rows, 5, lane);

    int32_t vals[kFS];
#pragma unroll
    for (int s = 0; s < kFS; ++s)
      vals[s] = s < S ? __ldg(val_of + static_cast<size_t>(k) * S + s) : 0;
    for (int i = lane; i < W * kFS; i += 32) (&T[0][0])[i] = 0u;
    __syncwarp();

    unsigned open = 0;   // slots holding a latched op
    bool dirty = false;  // an OPEN since the last FORCE: a closure is due
    for (int e = 0; e < n_rows; ++e) {
      stage_row(ring, ev, e + kRingDepth - 1, n_rows, 5, lane);
      cp_async_wait<kRingDepth - 1>();  // this lane's copies of row e
      __syncwarp();                     // ... and every other lane's
      const int32_t* row = ring[e % kRingDepth];
      const int32_t kind = row[0];
      const int32_t slot = row[1];

      // ---- latch: the OPEN's slot gets its transition rows, one
      // source state per lane
      if (kind == kEvOpen) {
        dirty = true;
        if (slot >= 0 && slot < W) {
          open |= 1u << slot;
          for (int s = lane; s < kFS; s += 32)
            T[slot][s] = transition_row<LF>(vals, S, s, row[2], row[3],
                                            row[4], model);
          __syncwarp();
        }
      }

      if (kind == kEvForce) {
        // ---- closure to fixpoint, only when an OPEN came since the
        // last FORCE (the reference's rule)
        if (dirty) {
          closure<W, LF>(F, T, open, lane);
          dirty = false;
        }
        // ---- FORCE: survivors hold the slot's bit; recycle the bit
        alive = force<W, LF>(F, min(max(slot, 0), W - 1), lane);
        if (slot >= 0 && slot < W) open &= ~(1u << slot);
      }
      __syncwarp();  // every lane is done with this ring slot
      if (!alive) break;  // F is all zeros and would stay so
    }
    cp_async_wait<0>();
  }

  uint32_t* dst = out + static_cast<size_t>(run) * kOutWords;
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    const int g = j * 32 + lane;
    if (g < kOutWords) dst[g] = F[j];
  }
}

using KernelFn = void (*)(const int32_t*, const int32_t*, const int32_t*,
                          const int32_t*, const int32_t*, uint32_t*, int,
                          int, int, int, int);

template <int W>
KernelFn pick_field(int lf) {
  switch (lf) {
    case 0: return segment_scan_warp<W, 0>;
    case 1: return segment_scan_warp<W, 1>;
    case 2: return segment_scan_warp<W, 2>;
    case 3: return segment_scan_warp<W, 3>;
    case 4:
      if constexpr (W + 4 <= 13) return segment_scan_warp<W, 4>;
      return nullptr;
    default: return nullptr;
  }
}

KernelFn pick(int W, int lf) {
  switch (W) {
    case 1: return pick_field<1>(lf);
    case 2: return pick_field<2>(lf);
    case 3: return pick_field<3>(lf);
    case 4: return pick_field<4>(lf);
    case 5: return pick_field<5>(lf);
    case 6: return pick_field<6>(lf);
    case 7: return pick_field<7>(lf);
    case 8: return pick_field<8>(lf);
    case 9: return pick_field<9>(lf);
    case 10: return pick_field<10>(lf);
    default: return nullptr;
  }
}

}  // namespace

// Launch the scan over K segments x NB seeds on `stream`, one warp per
// (segment, seed) pair and kWarpsPerBlock pairs per block, with the
// kernel instantiated for (W, field_log2) (ops/dense_scan.py
// `dense_layout`). `out` receives K * NB packed frontiers of
// max(2^(W + field_log2), 32) / 32 words each. Returns 0, a CUDA error
// code from the launch, or a negative code for refused arguments (see
// segment_scan_error_string). Does not synchronise.
extern "C" int segment_scan_launch(const int32_t* events,
                                   const int32_t* val_of,
                                   const int32_t* seed_mask,
                                   const int32_t* seed_state,
                                   const int32_t* n_events, uint32_t* out,
                                   int K, int NB, int E, int W, int S,
                                   int field_log2, int model, int device,
                                   void* stream) {
  if (K < 0 || NB < 0 || E < 0) return -1;
  if (W < 1 || W > kMaxSlots || S < 1 || S > kMaxStates ||
      (1 << W) * S > kMaxCells)
    return -2;
  if (model != kModelCasRegister && model != kModelSet) return -5;
  if (field_log2 < 0 || field_log2 > 4 || (1 << field_log2) < S ||
      (field_log2 > 0 && (1 << (field_log2 - 1)) >= S))
    return -6;
  const KernelFn kernel = pick(W, field_log2);
  if (kernel == nullptr) return -6;
  const long long runs = static_cast<long long>(K) * NB;
  if (runs > 0x7fffffffLL - kWarpsPerBlock) return -7;
  if (runs == 0) return 0;
  const int blocks = static_cast<int>((runs + kWarpsPerBlock - 1) /
                                      kWarpsPerBlock);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kWarpsPerBlock * 32, 0,
           static_cast<cudaStream_t>(stream)>>>(
      events, val_of, seed_mask, seed_state, n_events, out, K, NB, E, S,
      model);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* segment_scan_error_string(int code) {
  switch (code) {
    case -1: return "negative segment, seed or event count";
    case -2: return "(W, S) beyond the dense caps";
    case -5: return "model has no dense domain (the register and the set have)";
    case -6: return "field_log2 is not the layout's field width for S";
    case -7: return "too many (segment, seed) runs for one launch";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
