// Mask-mode linearizability scan for Hopper (sm_90a): one warp per
// history, the frontier bitset in registers, legality built only where
// the frontier reaches.
//
// Replaces the reference's mask-mode program, jepsen_jgroups_raft_tpu/
// ops/dense_scan.py `mask_step_parts` (dense_scan.py:577; an XLA program,
// no `pallas_call`), for models whose state after a SET of ops does not
// depend on their order (`mask_determined`: the counter, the ticket
// queue; and the set histories whose adds hit distinct fresh bits,
// `GSet.mask_eligible`, where the subset sums equal the OR). The frontier is a bitset F[2^W], W <= 12: bit m = "some
// linearization of exactly the ops in window mask m survives". Config
// m's state is base + sums[m], where sums[m] is the subset sum of the
// open slots' deltas and base absorbs the delta of every retired op. Per
// event row:
//
//   latch    the OPEN payloads set their slots' registers (f, a, b,
//            delta) and update sums;
//   closure  at a FORCE after an OPEN: F[m | bit w] |= F[m] & legal[w][m]
//            for every open slot w, to fixpoint, where legal[w][m] = slot
//            w's op is legal in state base + sums[m];
//   FORCE w  survivors hold bit w; the bit-w half moves down onto the
//            other; ok &= "some survivor"; slot w's delta retires into
//            base.
//
// What bounds it on this card: serial depth, as for dense_scan.cu. A
// suite history is ~1000 macro rows, each depending on the one before,
// and the bytes and operations per row are few. So the skeleton is
// dense_scan.cu's (warp_frontier.cuh): one warp per history and four per
// block, no block barrier in the event loop (every branch is
// warp-uniform), rows staged ahead by cp.async, the frontier in
// registers at field width 0 (2^W bits, at most 4 words a lane), closure
// sweeps that apply every open slot to the same frontier.
//
// The work of a row is the legality the closure reads, so the design is
// about building less of it:
//
// * sums without a 2^W table. Every update the reference makes to its
//   int32 sums[2^W] adds one scalar to one column — the masks that hold
//   bit c of the slot clipped to [0, W): at OPEN the new delta less the
//   slot's old one, at FORCE minus the retired delta. Addition mod 2^32
//   commutes, so sums[m] = Σ_{c in m} X[c], with X[c] the running total
//   added to column c. That is the reference's array exactly, also on
//   rows whose out-of-range slot adds to the clipped column while no
//   slot's delta changes. Lane c < W keeps X[c] and slot c's registers;
//   a closure shuffles them out once.
//
// * always-legal slots skip the table. A slot whose op passes
//   `Model::always_legal` (a counter add, a crashed enqueue: exactly the
//   term of the step's legality that reads no state, evaluated on the
//   same latched, possibly summed, f) is legal at every mask: its
//   legality words are all ones, at no model step and no ballot; a
//   closed slot's are zero. The sweep ANDs every slot's words in rather
//   than branching per slot: a branch around each image kept the
//   sweep's shuffles from overlapping and tripled its cycles (PERF.md).
//
// * legality built lazily, 32 masks at a time, inside the closure. The
//   masks of frontier word j in lane g form ballot group (j, g): lane i
//   evaluates mask (j << 10) | (g << 5) | i and `__ballot_sync` hands the
//   32 bits to lane g. Before each sweep the groups the frontier holds
//   and that are not built yet in this closure are built, for the open
//   slots that are not always legal, and marked in `built` (one bit per
//   group, at most 128, warp-uniform because it is made of ballots). The
//   groups it holds are named by a ballot over F[j] != 0 before the
//   first sweep and, after each, by the ballot over the sweep's fresh
//   masks that also ends the closure. A lane's state is base + lo(lane)
//   + hi(j) + mid(g), partial sums over the mask's bits, so no mask
//   re-sums W deltas.
//
//   Why this reaches the same fixpoint as the full table: a sweep reads
//   legality only through F[m] & L[w][m], F the frontier the sweep starts
//   from. Every group holding a mask of that F is built before the
//   sweep, with the ops latched now; at any other mask F[m] = 0, and the
//   term is 0 whatever L holds there. So every sweep ORs in exactly what
//   it would with the whole table, and the sweeps, their number and the
//   least fixpoint are the full table's. The groups built in a closure
//   are those of its closed frontier (the sweeps start from growing
//   frontiers, the last one from the closed one), so a closing FORCE
//   costs (closed-frontier groups) x (open slots not always legal)
//   ballots, against (open slots) x 2^W / 32 for the whole table.
//
// The chunk form (the reference's `make_dense_chunk_checker` for mask
// groups, under its chunked wavefront) is a second entry point of the
// same body: the carry holds the frontier words, base and each slot's
// registers with its column total X[c] (not the reference's sums[2^W],
// 16 KB a history at W = 12: sums[m] is the sum of X over m's bits), read
// at the start of a launch and written at its end.
//
// Same function as the reference, bit for bit: the closure reaches the
// same least fixpoint in at most W + 1 sweeps (the argument for sweeps
// of the same frontier is in dense_scan.cu); payloads that share one slot
// in one macro row SUM their f, a, b and deltas into it (the reference's
// `macro_latch_i32`); slots are clipped to [0, W) for the sums column
// and the FORCE, as the reference clips them; the scan stops at n_events
// or at the first dead FORCE. Integers: every sum is taken in uint32_t
// and cast back, so it wraps as the reference's int32 does.

#include <cstdint>
#include <cuda_runtime.h>

#include "models.cuh"
#include "verdict_counts.cuh"
#include "warp_frontier.cuh"

namespace {

constexpr int kMaskMaxSlots = 12;  // MASK_DENSE_MAX_SLOTS

template <int W>
using MaskLayout = Layout<W, 0>;

template <int W>
constexpr int kMaskWords = MaskLayout<W>::kWords;

// ---- instrumentation, compiled in only with -DMASK_SCAN_PROFILE (the
// library "mask_scan_profile", never on a main path): per history, SM
// clock cycles by phase and counts of the work done, written by lane 0.
// Columns match ops/dense_scan.py MASK_PROFILE_FIELDS, which checks their
// number against mask_scan_profile_fields().
enum : int {
  kProfRing, kProfLatch, kProfLegality, kProfSweep, kProfForce, kProfRows,
  kProfClosures, kProfSweeps, kProfGroups, kProfBallots, kProfSteps,
  kProfFields
};

struct Prof {
#ifdef MASK_SCAN_PROFILE
  unsigned c[kProfFields];
  long long t;
  __device__ __forceinline__ void start() {
#pragma unroll
    for (int k = 0; k < kProfFields; ++k) c[k] = 0u;
    t = clock64();
  }
  // charge the cycles since the last lap to phase k
  __device__ __forceinline__ void lap(int k) {
    const long long now = clock64();
    c[k] += static_cast<unsigned>(now - t);
    t = now;
  }
  __device__ __forceinline__ void add(int k, unsigned v) { c[k] += v; }
  __device__ __forceinline__ void store(long long* out, int h,
                                        int lane) const {
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kProfFields; ++k)
        out[static_cast<size_t>(h) * kProfFields + k] = c[k];
    }
  }
#else
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void lap(int) {}
  __device__ __forceinline__ void add(int, unsigned) {}
  __device__ __forceinline__ void store(long long*, int, int) const {}
#endif
};

// Slot w's image in a closure sweep: F[m] & legal[w][m] for every mask m
// without bit w, placed at m | bit w and OR-ed into `add`.
template <int W, int w>
__device__ __forceinline__ void mask_slot_image(
    const uint32_t (&F)[kMaskWords<W>], uint32_t (&add)[kMaskWords<W>],
    const uint32_t (&L)[kMaskWords<W>], int lane) {
  constexpr int kWords = kMaskWords<W>;
  if constexpr (w < 5) {
    constexpr uint32_t lo = low_half(w);
#pragma unroll
    for (int j = 0; j < kWords; ++j) add[j] |= (F[j] & L[j] & lo) << (1 << w);
  } else if constexpr (w < 10) {
    constexpr int k = w - 5;
    const uint32_t dst = ((lane >> k) & 1) ? kFull : 0u;
#pragma unroll
    for (int j = 0; j < kWords; ++j)
      add[j] |= __shfl_xor_sync(kFull, F[j] & L[j], 1 << k) & dst;
  } else {
    constexpr int k = w - 10;
#pragma unroll
    for (int j = 0; j < kWords; ++j)
      if (!((j >> k) & 1)) add[j | (1 << k)] |= F[j] & L[j];
  }
}

template <int W, int w = 0>
__device__ __forceinline__ void mask_sweep(
    const uint32_t (&F)[kMaskWords<W>], uint32_t (&add)[kMaskWords<W>],
    const uint32_t (&L)[W][kMaskWords<W>], int lane) {
  if constexpr (w < W) {
    mask_slot_image<W, w>(F, add, L[w], lane);
    mask_sweep<W, w + 1>(F, add, L, lane);
  }
}

// Build legality group (j, g) for the slots in `need`: lane i evaluates
// mask (j << 10) | (g << 5) | i in state st, and lane g keeps the ballot
// as L[w][j].
template <int W, int MODEL, int j>
__device__ __forceinline__ void build_group(
    uint32_t (&L)[W][kMaskWords<W>], uint32_t st, const int32_t (&f)[W],
    const int32_t (&a)[W], const int32_t (&b)[W], unsigned need, int g,
    int lane) {
  constexpr bool kReal = (1 << W) >= 32;  // else lanes >= 2^W hold no mask
  const bool real = kReal || lane < (1 << W);
#pragma unroll
  for (int w = 0; w < W; ++w) {
    if (!((need >> w) & 1)) continue;  // warp-uniform
    int32_t next;
    bool lg;
    Model<MODEL>::step(static_cast<int32_t>(st), f[w], a[w], b[w], &next,
                       &lg);
    const uint32_t word = __ballot_sync(kFull, lg && real);
    if (lane == g) L[w][j] = word;
  }
}

// Build the groups of register word j named by `todo` (a ballot: bit g =
// lane g's word j). `hj` is base + lo(lane) + hi(j).
template <int W, int MODEL, int j>
__device__ __forceinline__ void build_word(
    uint32_t (&L)[W][kMaskWords<W>], unsigned todo, uint32_t hj,
    const uint32_t (&X)[W], const int32_t (&f)[W], const int32_t (&a)[W],
    const int32_t (&b)[W], unsigned need, int lane) {
  while (todo) {  // warp-uniform: a ballot
    const int g = __ffs(todo) - 1;
    todo &= todo - 1;
    uint32_t st = hj;  // + mask bits 5..9 (the frontier lane g)
#pragma unroll
    for (int c = 5; c < W && c < 10; ++c)
      st += ((g >> (c - 5)) & 1) ? X[c] : 0u;
    build_group<W, MODEL, j>(L, st, f, a, b, need, g, lane);
  }
}

template <int W, int MODEL, int j = 0>
__device__ __forceinline__ void build_words(
    uint32_t (&L)[W][kMaskWords<W>], const unsigned (&todo)[kMaskWords<W>],
    const uint32_t (&hi)[kMaskWords<W>], const uint32_t (&X)[W],
    const int32_t (&f)[W], const int32_t (&a)[W], const int32_t (&b)[W],
    unsigned need, int lane) {
  if constexpr (j < kMaskWords<W>) {
    build_word<W, MODEL, j>(L, todo[j], hi[j], X, f, a, b, need, lane);
    build_words<W, MODEL, j + 1>(L, todo, hi, X, f, a, b, need, lane);
  }
}

// Closure to fixpoint at a closing FORCE, legality built lazily (see the
// top of the file). Slot c's registers (op, column total X[c]) are lane
// c's; `open` and `always` (open slots whose op is always legal) are
// warp-uniform. Each sweep adds every slot's image of the frontier it
// starts from, until a sweep adds nothing, in at most W + 1 sweeps.
// Legality words: all ones for an always-legal slot, zero for a closed
// one (an AND with them costs less than a branch per slot, which would
// keep the sweep's shuffles from overlapping), built for the others.
// `grow` holds, per register word, the lanes whose word gained masks —
// all non-empty ones before the first sweep, then the sweep's fresh ones
// — so the groups not built yet are grow & ~built, and the same ballot
// tells whether the sweep added anything.
template <int W, int MODEL>
__device__ __forceinline__ void mask_closure(
    uint32_t (&F)[kMaskWords<W>], uint32_t base, uint32_t col, int32_t sf,
    int32_t sa, int32_t sb, unsigned open, unsigned always, int lane,
    Prof& prof) {
  constexpr int kWords = kMaskWords<W>;
  constexpr unsigned kLanesPerGroup = (1 << W) < 32 ? (1u << W) : 32u;
  const unsigned need = open & ~always;
  uint32_t X[W];
  int32_t f[W], a[W], b[W];
#pragma unroll
  for (int c = 0; c < W; ++c) {
    X[c] = __shfl_sync(kFull, col, c);
    f[c] = __shfl_sync(kFull, sf, c);
    a[c] = __shfl_sync(kFull, sa, c);
    b[c] = __shfl_sync(kFull, sb, c);
  }
  uint32_t lo = base;  // + the mask's low five bits, which are the lane's
#pragma unroll
  for (int c = 0; c < W && c < 5; ++c) lo += ((lane >> c) & 1) ? X[c] : 0u;
  uint32_t hi[kWords];  // + mask bits 10.. (the register word)
  uint32_t L[W][kWords];
  unsigned built[kWords], grow[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j) {
    hi[j] = lo;
#pragma unroll
    for (int c = 10; c < W; ++c) hi[j] += ((j >> (c - 10)) & 1) ? X[c] : 0u;
#pragma unroll
    for (int w = 0; w < W; ++w) L[w][j] = ((always >> w) & 1) ? kFull : 0u;
    built[j] = 0u;
    grow[j] = __ballot_sync(kFull, F[j] != 0u);
  }
  prof.add(kProfClosures, 1u);
  prof.lap(kProfLegality);
  for (int it = 0; it <= W; ++it) {
    unsigned todo[kWords], any = 0u;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      todo[j] = need ? grow[j] & ~built[j] : 0u;
      built[j] |= todo[j];
      any |= todo[j];
    }
    if (any) {  // warp-uniform
      build_words<W, MODEL>(L, todo, hi, X, f, a, b, need, lane);
      unsigned groups = 0;
#pragma unroll
      for (int j = 0; j < kWords; ++j) groups += __popc(todo[j]);
      const unsigned ballots = groups * __popc(need);
      prof.add(kProfGroups, groups);
      prof.add(kProfBallots, ballots);
      prof.add(kProfSteps, ballots * kLanesPerGroup);
      prof.lap(kProfLegality);
    }
    uint32_t add[kWords];
#pragma unroll
    for (int j = 0; j < kWords; ++j) add[j] = 0u;
    mask_sweep<W>(F, add, L, lane);
    unsigned more = 0u;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      grow[j] = __ballot_sync(kFull, (add[j] & ~F[j]) != 0u);
      F[j] |= add[j];
      more |= grow[j];
    }
    prof.add(kProfSweeps, 1u);
    prof.lap(kProfSweep);
    if (!more) break;
  }
}

// The chunk carry of one history (ops/dense_scan.py mask_carry_layout):
// int32 fields ok, overflow, dirty, left (kCarryHead), base, then per
// slot open, f, a, b, delta and col (the column total X[c]) [W], then
// the frontier's words in lane order (word 32 j + l is lane l's register
// word j). sums[2^W] is not stored: it is Σ_{c in m} X[c].
template <int W>
struct MaskCarry {
  static constexpr int kNW = (1 << W) > 32 ? (1 << W) / 32 : 1;
  static constexpr int kBase = kCarryHead;
  static constexpr int kOpen = kBase + 1;
  static constexpr int kF = kOpen + W;
  static constexpr int kA = kF + W;
  static constexpr int kB = kA + W;
  static constexpr int kDelta = kB + W;
  static constexpr int kCol = kDelta + W;
  static constexpr int kFrontier = kCol + W;
  static constexpr int kLen = kFrontier + kNW;
};

// One kernel body, two entry points, as dense_scan.cu's: one-shot
// (carry_in, carry_out and flags null; a fresh state, n_events[h] rows,
// ok_out) and chunk (the state from carry_in, min(left, E) rows of the
// slice, carry_out with left - E and the four flags). Every field of the
// state lives in registers between rows, so the carry holds all of it;
// the lazy legality of mask_closure is built and dropped inside one
// closing FORCE and crosses no row. kCount (one-shot only) also counts
// the row's verdict into counts[2] in dense mode, real[h] (null: every
// row real) masking padding rows out (verdict_counts.cuh); the instances
// without it are the same code as before the counts existed.
template <int W, int MODEL, bool kCount>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 1)
    mask_scan_warp(const int32_t* __restrict__ events, long long row_stride,
                   const int32_t* __restrict__ n_events,
                   const int32_t* __restrict__ carry_in,
                   int32_t* __restrict__ carry_out,
                   uint8_t* __restrict__ flags,
                   uint8_t* __restrict__ ok_out,
                   long long* __restrict__ prof_out, int B, int E, int R,
                   int macro_p, int32_t init_state,
                   const uint8_t* __restrict__ real,
                   unsigned long long* __restrict__ counts) {
  using Carry = MaskCarry<W>;
  constexpr int kWords = kMaskWords<W>;
  __shared__ int32_t ring_all[kWarpsPerBlock][kRingDepth][kRowPitch];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.x * kWarpsPerBlock + warp;
  if constexpr (kCount) count_open();  // before any warp exits
  if (h >= B) return;  // warp-uniform; no other warp waits on this one
  int32_t (*ring)[kRowPitch] = ring_all[warp];
  const int32_t* cin =
      carry_in ? carry_in + static_cast<size_t>(h) * Carry::kLen : nullptr;
  const int32_t* ev = events + static_cast<size_t>(h) * row_stride;
  const int left = cin ? cin[kCarryLeft] : n_events[h];
  bool ok = cin ? cin[kCarryOk] != 0 : true;
  const int n_rows = ok ? min(max(left, 0), E) : 0;
#pragma unroll
  for (int e = 0; e < kRingDepth - 1; ++e)
    stage_row(ring, ev, e, n_rows, R, lane);

  uint32_t F[kWords];
  // Slot `lane`'s registers (lanes >= W keep zeros): its op, its delta,
  // the column total X[lane] of sums, and whether it is open.
  int32_t sf = 0, sa = 0, sb = 0;
  uint32_t sdelta = 0, col = 0;
  bool sopen = false;
  uint32_t base = static_cast<uint32_t>(init_state);  // warp-uniform
  bool dirty = false;  // an OPEN since the last FORCE: a closure is due
  if (cin) {
#pragma unroll
    for (int j = 0; j < kWords; ++j)
      F[j] = 32 * j + lane < Carry::kNW
                 ? static_cast<uint32_t>(cin[Carry::kFrontier + 32 * j + lane])
                 : 0u;
    if (lane < W) {
      sf = cin[Carry::kF + lane];
      sa = cin[Carry::kA + lane];
      sb = cin[Carry::kB + lane];
      sdelta = static_cast<uint32_t>(cin[Carry::kDelta + lane]);
      col = static_cast<uint32_t>(cin[Carry::kCol + lane]);
      sopen = cin[Carry::kOpen + lane] != 0;
    }
    base = static_cast<uint32_t>(cin[Carry::kBase]);
    dirty = cin[kCarryDirty] != 0;
  } else {
#pragma unroll
    for (int j = 0; j < kWords; ++j) F[j] = 0u;
    if (lane == 0) F[0] = 1u;  // the empty mask
  }
  const int first = macro_p ? 3 : 1;  // first payload (slot, f, a, b)
  Prof prof;
  prof.start();
  for (int e = 0; e < n_rows; ++e) {
    stage_row(ring, ev, e + kRingDepth - 1, n_rows, R, lane);
    cp_async_wait<kRingDepth - 1>();  // this lane's copies of row e landed
    __syncwarp();                     // ... and every other lane's
    prof.add(kProfRows, 1u);
    prof.lap(kProfRing);
    const int32_t* row = ring[e % kRingDepth];
    const int32_t kind = row[0];
    const int32_t fslot = row[1];
    const int n = macro_p ? min(max(row[2], 0), macro_p) : (kind == kEvOpen);

    // ---- latch: lane c < W folds in the payloads whose clipped slot is c
    if (n > 0) {
      dirty = true;
      if (lane < W) {
        const uint32_t old = sdelta;
        uint32_t dx = 0, nd = 0, nf = 0, na = 0, nb = 0;
        bool hit = false;
        for (int p = 0; p < n; ++p) {
          const int32_t* pay = row + first + 4 * p;
          const int q = pay[0];
          if (min(max(q, 0), W - 1) != lane) continue;
          const uint32_t d = Model<MODEL>::mask_delta(pay[1], pay[2], pay[3]);
          if (q == lane) {  // the slot itself: its registers take the op
            hit = true;
            dx += d - old;
            nd += d;
            nf += static_cast<uint32_t>(pay[1]);
            na += static_cast<uint32_t>(pay[2]);
            nb += static_cast<uint32_t>(pay[3]);
          } else {  // out of range: only the clipped column moves
            dx += d;
          }
        }
        col += dx;
        if (hit) {
          sf = static_cast<int32_t>(nf);
          sa = static_cast<int32_t>(na);
          sb = static_cast<int32_t>(nb);
          sdelta = nd;
          sopen = true;
        }
      }
    }
    prof.lap(kProfLatch);

    if (kind == kEvForce) {
      // ---- closure to fixpoint, only when an OPEN came since the last
      // FORCE (the reference's rule)
      if (dirty) {
        const unsigned open = __ballot_sync(kFull, sopen);
        const unsigned always =
            __ballot_sync(kFull, sopen && Model<MODEL>::always_legal(sf));
        mask_closure<W, MODEL>(F, base, col, sf, sa, sb, open, always, lane,
                               prof);
        dirty = false;
      }
      // ---- FORCE: survivors hold the slot's bit; recycle the bit and
      // retire the slot's delta into base
      const int w = min(max(fslot, 0), W - 1);
      ok = force<W, 0>(F, w, lane);
      const bool in_range = fslot >= 0 && fslot < W;
      const uint32_t d_w = __shfl_sync(kFull, sdelta, w);
      const uint32_t retired = in_range ? d_w : 0u;
      base += retired;
      if (in_range && lane == fslot) {
        col -= retired;
        sdelta = 0u;
        sopen = false;
      }
      prof.lap(kProfForce);
    }
    __syncwarp();  // every lane is done with this ring slot
    if (!ok) break;
  }
  cp_async_wait<0>();
  if (ok_out != nullptr && lane == 0) ok_out[h] = ok ? 1 : 0;
  if constexpr (kCount) {
    const uint32_t r = real == nullptr || real[h] != 0;
    count_rows(lane == 0 ? valid_bits<kCountDense>(ok, 0u, r) : 0u, 0u,
               min(kWarpsPerBlock, B - static_cast<int>(blockIdx.x) *
                                           kWarpsPerBlock),
               counts);
  }
  if (carry_out != nullptr) {
    int32_t* cout = carry_out + static_cast<size_t>(h) * Carry::kLen;
#pragma unroll
    for (int j = 0; j < kWords; ++j)
      if (32 * j + lane < Carry::kNW)
        cout[Carry::kFrontier + 32 * j + lane] = static_cast<int32_t>(F[j]);
    if (lane < W) {
      cout[Carry::kF + lane] = sf;
      cout[Carry::kA + lane] = sa;
      cout[Carry::kB + lane] = sb;
      cout[Carry::kDelta + lane] = static_cast<int32_t>(sdelta);
      cout[Carry::kCol + lane] = static_cast<int32_t>(col);
      cout[Carry::kOpen + lane] = sopen ? 1 : 0;
    }
    if (lane == 0) {
      cout[Carry::kBase] = static_cast<int32_t>(base);
      write_head(cout, flags, h, B, ok, false, dirty, left - E);
    }
  }
  prof.store(prof_out, h, lane);
}

using KernelFn = void (*)(const int32_t*, long long, const int32_t*,
                          const int32_t*, int32_t*, uint8_t*, uint8_t*,
                          long long*, int, int, int, int, int32_t,
                          const uint8_t*, unsigned long long*);

template <int MODEL, bool kCount>
KernelFn pick_window(int W) {
  switch (W) {
    case 1: return mask_scan_warp<1, MODEL, kCount>;
    case 2: return mask_scan_warp<2, MODEL, kCount>;
    case 3: return mask_scan_warp<3, MODEL, kCount>;
    case 4: return mask_scan_warp<4, MODEL, kCount>;
    case 5: return mask_scan_warp<5, MODEL, kCount>;
    case 6: return mask_scan_warp<6, MODEL, kCount>;
    case 7: return mask_scan_warp<7, MODEL, kCount>;
    case 8: return mask_scan_warp<8, MODEL, kCount>;
    case 9: return mask_scan_warp<9, MODEL, kCount>;
    case 10: return mask_scan_warp<10, MODEL, kCount>;
    case 11: return mask_scan_warp<11, MODEL, kCount>;
    case 12: return mask_scan_warp<12, MODEL, kCount>;
    default: return nullptr;
  }
}

// Which instances a build holds: the counting ones in the library built
// with -DMASK_SCAN_COUNT (mask_scan_count: the one-shot entry only), the
// others in mask_scan (with the chunk entry) and in the instrumented
// build. Two libraries keep each nvcc to the instances it had before the
// counts existed, and the two build side by side.
#ifdef MASK_SCAN_COUNT
constexpr bool kCountBuild = true;
#else
constexpr bool kCountBuild = false;
#endif

KernelFn pick(int W, int model) {
  switch (model) {
    case kModelCounter: return pick_window<kModelCounter, kCountBuild>(W);
    case kModelQueue: return pick_window<kModelQueue, kCountBuild>(W);
    case kModelSet: return pick_window<kModelSet, kCountBuild>(W);
    default: return nullptr;
  }
}

int carry_len(int W) {
  switch (W) {
    case 1: return MaskCarry<1>::kLen;
    case 2: return MaskCarry<2>::kLen;
    case 3: return MaskCarry<3>::kLen;
    case 4: return MaskCarry<4>::kLen;
    case 5: return MaskCarry<5>::kLen;
    case 6: return MaskCarry<6>::kLen;
    case 7: return MaskCarry<7>::kLen;
    case 8: return MaskCarry<8>::kLen;
    case 9: return MaskCarry<9>::kLen;
    case 10: return MaskCarry<10>::kLen;
    case 11: return MaskCarry<11>::kLen;
    default: return MaskCarry<12>::kLen;
  }
}

int launch(const int32_t* events, long long row_stride,
           const int32_t* n_events, const int32_t* carry_in,
           int32_t* carry_out, uint8_t* flags, uint8_t* ok, long long* prof,
           const uint8_t* real, long long* counts, int B, int E, int R,
           int macro_p, int W, int model, int init_state, int device,
           void* stream) {
  if (B < 0 || E < 0) return -1;
  if (W < 1 || W > kMaskMaxSlots) return -2;
  if (macro_p < 0 || macro_p > kMaxOpens) return -3;
  if (R != (macro_p ? 3 + 4 * macro_p : 5)) return -4;
  const KernelFn kernel = pick(W, model);
  if (kernel == nullptr) return -5;
  if ((counts != nullptr) != kCountBuild) return -8;
  if (B == 0 && counts == nullptr) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (counts != nullptr) {  // the blocks add into zeroed counters
    err = cudaMemsetAsync(counts, 0, 2 * sizeof(long long), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (B == 0) return 0;
  }
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  kernel<<<blocks, kWarpsPerBlock * 32, 0, s>>>(
      events, row_stride, n_events, carry_in, carry_out, flags, ok, prof, B,
      E, R, macro_p, init_state, real,
      reinterpret_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch the scan over B histories on `stream`, one warp per history and
// kWarpsPerBlock histories per block, with the kernel instantiated for
// (W, model); init_state is the model's initial state. With counts
// (int64 [2], else null; only in mask_scan_count, and there always) the
// kernel's epilogue also counts the verdicts in dense mode, real [B] (null: every row) masking rows out; counts is
// zeroed on `stream` first. Returns 0, a CUDA error code from the
// launch, or a negative code for refused arguments (see
// mask_scan_error_string). Does not synchronise.
extern "C" int mask_scan_launch(const int32_t* events, const int32_t* n_events,
                                uint8_t* ok, const uint8_t* real,
                                long long* counts, int B, int E, int R,
                                int macro_p, int W, int model, int init_state,
                                int device, void* stream) {
  return launch(events, static_cast<long long>(E) * R, n_events, nullptr,
                nullptr, nullptr, ok, nullptr, real, counts, B, E, R, macro_p,
                W, model, init_state, device, stream);
}

#ifndef MASK_SCAN_COUNT
// Launch one chunk over B histories on `stream`: the state of history h
// from row h of carry_in (carry_len ints, MaskCarry's layout), its event
// rows from events + h * row_stride (width rows of R ints; a slice of a
// longer batch), the state after them to row h of carry_out and its four
// flags to flags[k * B + h]. Returns as mask_scan_launch; -7 when
// carry_len is not the layout's length. Does not synchronise.
extern "C" int mask_scan_chunk_launch(const int32_t* events,
                                      const int32_t* carry_in,
                                      int32_t* carry_out, uint8_t* flags,
                                      long long row_stride, int B, int width,
                                      int R, int macro_p, int W, int model,
                                      int carry_len_, int device,
                                      void* stream) {
  if (W >= 1 && W <= kMaskMaxSlots && carry_len_ != carry_len(W)) return -7;
  return launch(events, row_stride, nullptr, carry_in, carry_out, flags,
                nullptr, nullptr, nullptr, nullptr, B, width, R, macro_p, W,
                model, 0, device, stream);
}
#endif

extern "C" const char* mask_scan_error_string(int code) {
  switch (code) {
    case -1: return "negative batch or event count";
    case -2: return "W beyond the mask caps (1..12)";
    case -3: return "macro_p beyond MACRO_MAX_OPENS";
    case -4: return "row width does not match macro_p";
    case -5: return "model has no mask-mode device step";
    case -7: return "carry length does not match the carry layout";
    case -8: return "counts asked of mask_scan, or not of mask_scan_count";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

#ifdef MASK_SCAN_PROFILE
// The instrumented build's launch: as mask_scan_launch, and also
// prof[B][kProfFields] int64, each history's counters (Prof).
extern "C" int mask_scan_profile_launch(const int32_t* events,
                                        const int32_t* n_events, uint8_t* ok,
                                        long long* prof, int B, int E, int R,
                                        int macro_p, int W, int model,
                                        int init_state, int device,
                                        void* stream) {
  return launch(events, static_cast<long long>(E) * R, n_events, nullptr,
                nullptr, nullptr, ok, prof, nullptr, nullptr, B, E, R, macro_p,
                W, model, init_state, device, stream);
}

extern "C" const char* mask_scan_profile_error_string(int code) {
  return mask_scan_error_string(code);
}

// The number of counters per history in prof (kProfFields), for the
// binding to check against its own list of columns.
extern "C" int mask_scan_profile_fields() { return kProfFields; }
#endif
