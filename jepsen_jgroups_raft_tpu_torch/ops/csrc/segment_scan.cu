// Segmented long-history scan for Hopper (sm_90a): one CTA per segment
// (or per group of its seeds), the segment's rows and transition rows
// prepared once in shared memory for all of its seed runs, each run's
// frontier in registers, several runs a warp.
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
//   starts empty, and an empty frontier stays empty;
// * the whole final frontier is the result, written bit-packed: word g
//   of a run holds frontier bits b = m * FS + s in [32 g, 32 g + 32),
//   the register layout of warp_frontier.cuh read in lane order;
// * legacy rows only (5 ints: type, slot, f, a, b) — the segment
//   planner reasons about single events, as the reference's does.
//
// What bounds it. The runs of a segment read the same rows, and a run's
// events form one dependency chain: once every run of the launch is
// resident (one wave at the users' size) the kernel takes as long as the
// warps of the busiest SM take to walk their ~1500 rows, and those warps
// share the SM's issue slots and integer pipe. So the design cuts the
// work a row and shares what the runs share:
//
// * Rows prepared once a CTA. A CTA holds the runs of one segment (up to
//   kMaxSegWarps warps; more seeds take more CTAs of the same segment:
//   ops/segment_scan.py `segment_shape`). Its threads read a tile of the
//   segment's rows — the whole segment up to kMaxTileRows — from global
//   memory once and write into dynamic shared memory each row's
//   descriptor (kind, clipped slot, in range) and each OPEN's transition
//   rows (one (row, source state) item a thread). After one block
//   barrier the warps walk the tile on their own: no ring, no wait per
//   row, and no barrier between two rows of a tile, so a warp whose runs
//   close more is never waited for by the others inside a tile.
// * A latch is a copy. A run's latch copies rows computed once a segment
//   (not a model step in every warp) into the warp's latched rows in
//   shared memory: one shared load and store a lane (lanes < FS). One
//   form for every (W, LF): rows kept in registers where W · FS ≤ 64
//   were 2.1 % faster on config 5, and rows read into registers once a
//   closure 2.2 %, each a second path for that (PERF.md §6).
// * Several runs a warp. A run whose frontier has fewer than 2^10 bits
//   fills only kLanes lanes of warp_frontier.cuh's layout; the warp's
//   other lanes hold other runs of the same segment (32 / kLanes of
//   them). Every transform stays inside a run's lanes (shuffles by xor
//   below kLanes), so the shared code runs unchanged, and a warp's work
//   a row serves 32 / kLanes runs.
// * Fewer integer operations a sweep. With 2 warps a scheduler the
//   sweeps are bound by the SM's 32-bit integer pipe (half its float
//   rate; a sweep of config 5's (7, 2) instantiation is ~80 SASS
//   instructions, PERF.md §6). The closure keeps dense_frontier.cuh's
//   Jacobi sweeps (every open slot's image of the same frontier, all
//   independent, so one sweep's loads and shuffles overlap), but the
//   transition rows are kept replicated into every field of a word, and
//   each frontier word is spread once a sweep into FS masks (all ones
//   where a field holds state s): a slot's image is then one AND-OR a
//   source state, where apply_rows spends four integer operations; each
//   slot's destination mask (its masks or lanes, none when it is closed)
//   is set once a closure, not once a sweep. Two other schedules reach
//   the same fixpoint and lost on the card (PERF.md §6): a semi-naive
//   one (the slots latched since the last closure, then the new bits
//   only), whose per-slot branches serialised the images, and the
//   reference's in-order sweeps, 2.48 a closure on config 5 against
//   3.31 but each a chain of W dependent images with a spread a slot
//   (23 % slower).
//
// The run stops at the segment's real length (its prologue of re-OPEN
// rows plus its slice) or as soon as a FORCE leaves no survivor in any
// run of the warp, and the CTA stops at the first tile boundary where
// none of its runs survives; a CTA whose seeds are all padded writes
// zeros at once. FORCE kill and shift, slots clipped to [0, W) at FORCE
// and duplicate ids of a padded val_of all lighting up are
// dense_scan.cu's, bit for bit (dense_frontier.cuh, warp_frontier.cuh).

#include <cstdint>
#include <cuda_runtime.h>
#include <map>
#include <mutex>
#include <utility>

#include "dense_frontier.cuh"
#include "models.cuh"
#include "warp_frontier.cuh"

namespace {

constexpr int kMaxTileRows = 2048;  // SEGMENT_MAX_TILE_ROWS: rows a tile
constexpr int kMaxSegWarps = 8;     // SEGMENT_MAX_WARPS: warps a CTA

// A row's descriptor: its clipped slot in bits 0..7, then flags.
constexpr uint32_t kDescSlot = 0xffu;
constexpr uint32_t kDescOpen = 1u << 8;
constexpr uint32_t kDescForce = 1u << 9;
constexpr uint32_t kDescInRange = 1u << 10;

template <int W, int LF>
struct SegLayout {
  static constexpr int kBits = W + LF;
  // lanes that hold one run's frontier, and runs a warp
  static constexpr int kLanes =
      kBits >= 10 ? 32 : kBits <= 5 ? 1 : 1 << (kBits - 5);
  static constexpr int kGroups = 32 / kLanes;
  static constexpr int kOutWords = (1 << kBits) > 32 ? (1 << kBits) / 32 : 1;
};

// Shared memory of a CTA with `warps` warps and tiles of `tile` rows:
// the tile's descriptors, its OPENs' transition rows (FS words a row),
// and each warp's latched rows T[W][FS].
constexpr size_t smem_bytes(int W, int LF, int warps, int tile) {
  return sizeof(uint32_t) * (static_cast<size_t>(tile) * (1 + (1 << LF)) +
                             static_cast<size_t>(warps) * W * (1 << LF));
}

// ---- instrumentation, compiled in only with -DSEGMENT_SCAN_PROFILE (the
// library "segment_scan_profile", never on a main path): per warp, SM
// clock cycles by phase and counts of the work done, written by lane 0.
// Columns match ops/segment_scan.py SEGMENT_PROFILE_FIELDS.
enum : int {
  kProfStage, kProfLatch, kProfClosure, kProfForce, kProfTail, kProfRows,
  kProfOpens, kProfClosures, kProfSweeps, kProfImages, kProfFields
};

struct Prof {
#ifdef SEGMENT_SCAN_PROFILE
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
  __device__ __forceinline__ void store(long long* out, int w,
                                        int lane) const {
    if (lane == 0 && out != nullptr) {
#pragma unroll
      for (int k = 0; k < kProfFields; ++k)
        out[static_cast<size_t>(w) * kProfFields + k] = c[k];
    }
  }
#else
  __device__ __forceinline__ void start() {}
  __device__ __forceinline__ void lap(int) {}
  __device__ __forceinline__ void add(int, unsigned) {}
  __device__ __forceinline__ void store(long long*, int, int) const {}
#endif
};

// Every field of a frontier word x mapped through a slot's rows, with
// the rows replicated into every field (Tr[s] = t[s] · field_unit):
// sp[s] is all ones in the fields of x whose bit s is set, computed once
// a word and shared by every slot, so a slot's image is one AND-OR a
// source state (dense_frontier.cuh's apply_rows spends a shift, an AND,
// a multiply and an OR a source state and slot).
template <int LF>
__device__ __forceinline__ uint32_t image_of(const uint32_t (&sp)[1 << LF],
                                             const uint32_t (&Tr)[1 << LF]) {
  uint32_t y = 0;
#pragma unroll
  for (int s = 0; s < (1 << LF); ++s) y |= sp[s] & Tr[s];
  return y;
}

// The images of every slot of the frontier words F into `add` (one
// Jacobi sweep): for each word its spread, then each slot's image placed
// at m | bit w as dense_frontier.cuh's slot_image places it, under the
// slot's destination mask keep[w] (zero for a closed slot; set once a
// closure).
template <int W, int LF, int w = 0>
__device__ __forceinline__ void place_images(
    const uint32_t (&sp)[1 << LF], int j,
    uint32_t (&add)[Layout<W, LF>::kWords], const uint32_t (*T)[1 << LF],
    const uint32_t (&keep)[W]) {
  if constexpr (w < W) {
    constexpr int p = LF + w;
    const uint32_t img = image_of<LF>(sp, T[w]);
    if constexpr (p < 5) {
      add[j] |= (img << (1 << p)) & keep[w];
    } else if constexpr (p < 10) {
      add[j] |= __shfl_xor_sync(kFull, img, 1 << (p - 5)) & keep[w];
    } else {
      constexpr int k = p - 10;
      if (!((j >> k) & 1)) add[j | (1 << k)] |= img & keep[w];
    }
    place_images<W, LF, w + 1>(sp, j, add, T, keep);
  }
}

// Slot w's destination bits in this lane's frontier words: the in-word
// masks with bit w set, every bit on the lanes whose lane bit is w's
// bit, or every bit of a register word.
template <int LF>
__device__ __forceinline__ uint32_t destinations(int w, int lane) {
  const int p = LF + w;
  if (p < 5) return low_half(p) << (1 << p);
  if (p < 10) return ((lane >> (p - 5)) & 1) ? kFull : 0u;
  return kFull;
}

// Jacobi sweeps to fixpoint (dense_frontier.cuh's `closure`, on the
// warp's replicated rows T[w][s] in shared memory): each sweep
// adds every open slot's image of the frontier it starts from, until a
// sweep adds nothing, in at most W + 1 sweeps (the reference's bound).
// Returns the sweeps run.
template <int W, int LF>
__device__ __forceinline__ int sweeps_to_fixpoint(
    uint32_t (&F)[Layout<W, LF>::kWords], const uint32_t (*T)[1 << LF],
    unsigned open, int lane) {
  constexpr int kWords = Layout<W, LF>::kWords;
  constexpr int kFS = 1 << LF;
  constexpr uint32_t unit = field_unit(LF);
  constexpr uint32_t ones = LF == 0 ? 1u : (1u << kFS) - 1u;
  uint32_t keep[W];
#pragma unroll
  for (int w = 0; w < W; ++w)
    keep[w] = ((open >> w) & 1u) ? destinations<LF>(w, lane) : 0u;
  int sweeps = 0;
  while (sweeps <= W) {
    uint32_t add[kWords];
#pragma unroll
    for (int j = 0; j < kWords; ++j) add[j] = 0u;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      uint32_t sp[kFS];
#pragma unroll
      for (int s = 0; s < kFS; ++s) sp[s] = ((F[j] >> s) & unit) * ones;
      place_images<W, LF>(sp, j, add, T, keep);
    }
    uint32_t fresh = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      fresh |= add[j] & ~F[j];
      F[j] |= add[j];
    }
    ++sweeps;
    if (!__any_sync(kFull, fresh != 0)) break;
  }
  return sweeps;
}

// Fill the descriptors and the OPENs' transition rows of rows [r0, r0 +
// n) of a segment's rows `ev` (5 ints a row), read from global memory:
// one row a thread for the descriptors, one (row, source state) item a
// thread for the transition rows, each replicated into every field of a
// frontier word (`image_of`).
template <int W, int LF>
__device__ __forceinline__ void prepare_tile(
    const int32_t* ev, int r0, int n, uint32_t* desc,
    uint32_t (*trans)[1 << LF], const int32_t (&vals)[1 << LF], int S,
    int model, int tid, int nthreads) {
  constexpr int kFS = 1 << LF;
  const int32_t* rows = ev + static_cast<size_t>(r0) * 5;
  for (int i = tid; i < n; i += nthreads) {
    const int32_t kind = __ldg(rows + i * 5);
    const int32_t slot = __ldg(rows + i * 5 + 1);
    const bool in = slot >= 0 && slot < W;
    desc[i] = static_cast<uint32_t>(min(max(slot, 0), W - 1)) |
              (in ? kDescInRange : 0u) |
              (kind == kEvOpen ? kDescOpen
               : kind == kEvForce ? kDescForce : 0u);
  }
#pragma unroll 4
  for (int x = tid; x < n * kFS; x += nthreads) {
    const int32_t* r = rows + (x >> LF) * 5;
    const int32_t slot = __ldg(r + 1);
    if (__ldg(r) == kEvOpen && slot >= 0 && slot < W)
      trans[x >> LF][x & (kFS - 1)] =
          transition_row<LF>(vals, S, x & (kFS - 1), __ldg(r + 2),
                             __ldg(r + 3), __ldg(r + 4), model) *
          field_unit(LF);
  }
}

template <int W, int LF>
__global__ void __launch_bounds__(kMaxSegWarps * 32, 1)
    segment_scan_cta(const int32_t* __restrict__ events,
                     const int32_t* __restrict__ val_of,
                     const int32_t* __restrict__ seed_mask,
                     const int32_t* __restrict__ seed_state,
                     const int32_t* __restrict__ n_events,
                     uint32_t* __restrict__ out,
                     long long* __restrict__ prof_out, int NB, int E, int S,
                     int model, int ctas_per_segment, int tile) {
  using SL = SegLayout<W, LF>;
  constexpr int kFS = Layout<W, LF>::kFS;
  constexpr int kWords = Layout<W, LF>::kWords;
  extern __shared__ uint32_t smem[];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  uint32_t* desc = smem;
  uint32_t (*trans)[kFS] = reinterpret_cast<uint32_t (*)[kFS]>(smem + tile);
  // the warp's latched rows T[w][s], replicated (one shared row a slot)
  uint32_t (*T)[kFS] = reinterpret_cast<uint32_t (*)[kFS]>(
      smem + static_cast<size_t>(tile) * (1 + kFS) + warp * W * kFS);
  const int k = blockIdx.x / ctas_per_segment;
  const int c = blockIdx.x - k * ctas_per_segment;
  // this lane's run: its group of kLanes lanes in the warp
  const int g = lane / SL::kLanes;
  const int seed =
      (c * (nthreads >> 5) + warp) * SL::kGroups + g;  // < 2^31: launcher
  const bool real = seed < NB;
  const size_t run = static_cast<size_t>(k) * NB + seed;

  // the seed: one frontier bit b = m0 * FS + s0, held by one lane of
  // the run's group
  const int32_t m0 = real ? seed_mask[run] : -1;
  const int32_t s0 = real ? seed_state[run] : 0;
  const bool seeded = m0 >= 0 && m0 < (1 << W) && s0 >= 0 && s0 < S;
  const int b = seeded ? (m0 << LF) | s0 : 0;
  const bool mine =
      seeded && (lane & (SL::kLanes - 1)) == ((b >> 5) & (SL::kLanes - 1));
  uint32_t F[kWords];
#pragma unroll
  for (int j = 0; j < kWords; ++j)
    F[j] = (mine && j == (b >> 10)) ? 1u << (b & 31) : 0u;
  bool alive = __any_sync(kFull, seeded);

  Prof prof;
  prof.start();
  const int n_rows = min(max(n_events[k], 0), E);
  // every CTA-wide decision below is uniform: all threads reach every
  // barrier
  if (__syncthreads_or(alive) && n_rows > 0) {
    const int32_t* ev = events + static_cast<size_t>(k) * E * 5;
    int32_t vals[kFS];
#pragma unroll
    for (int s = 0; s < kFS; ++s)
      vals[s] = s < S ? __ldg(val_of + static_cast<size_t>(k) * S + s) : 0;

    unsigned open = 0;   // slots holding a latched op
    bool dirty = false;  // an OPEN since the last FORCE: a closure is due
    for (int r0 = 0; r0 < n_rows; r0 += tile) {
      const int n = min(tile, n_rows - r0);
      prepare_tile<W, LF>(ev, r0, n, desc, trans, vals, S, model, tid,
                          nthreads);
      __syncthreads();
      prof.lap(kProfStage);
      if (alive) {
        uint32_t d_next = desc[0];
        for (int i = 0; i < n; ++i) {
          const uint32_t d = d_next;
          d_next = desc[min(i + 1, n - 1)];
          const int w = static_cast<int>(d & kDescSlot);
          prof.add(kProfRows, 1u);
          if (d & kDescOpen) {
            // latch: the slot takes the tile's rows
            prof.add(kProfOpens, 1u);
            dirty = true;
            if (d & kDescInRange) {
              open |= 1u << w;
              if (lane < kFS) T[w][lane] = trans[i][lane];
              __syncwarp();
            }
            prof.lap(kProfLatch);
          } else if (d & kDescForce) {
            // closure to fixpoint, only when an OPEN came since the last
            // FORCE (the reference's rule)
            if (dirty) {
              const int sweeps =
                  sweeps_to_fixpoint<W, LF>(F, T, open, lane);
              prof.add(kProfClosures, 1u);
              prof.add(kProfSweeps, sweeps);
              prof.add(kProfImages, sweeps * W);
              dirty = false;
              prof.lap(kProfClosure);
            }
            // FORCE: survivors hold the slot's bit; recycle the bit
            alive = force<W, LF>(F, w, lane);
            if (d & kDescInRange) open &= ~(1u << w);
            prof.lap(kProfForce);
            if (!alive) break;  // every run of the warp is empty
          }
        }
      }
      // every warp is done with the tile; stop when no run survives
      const bool any = __syncthreads_or(alive);
      prof.lap(kProfTail);
      if (!any) break;
    }
  }

  if (real) {
    uint32_t* dst = out + run * SL::kOutWords;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const int word = j * 32 + (lane & (SL::kLanes - 1));
      if (word < SL::kOutWords) dst[word] = F[j];
    }
  }
  prof.store(prof_out, blockIdx.x * (nthreads >> 5) + warp, lane);
}

using KernelFn = void (*)(const int32_t*, const int32_t*, const int32_t*,
                          const int32_t*, const int32_t*, uint32_t*,
                          long long*, int, int, int, int, int, int);

struct Pick {
  KernelFn fn;
  int groups;  // runs a warp
};

template <int W, int LF>
constexpr Pick pick_one() {
  return {segment_scan_cta<W, LF>, SegLayout<W, LF>::kGroups};
}

template <int W>
Pick pick_field(int lf) {
  switch (lf) {
    case 0: return pick_one<W, 0>();
    case 1: return pick_one<W, 1>();
    case 2: return pick_one<W, 2>();
    case 3: return pick_one<W, 3>();
    case 4:
      if constexpr (W + 4 <= 13) return pick_one<W, 4>();
      return {nullptr, 0};
    default: return {nullptr, 0};
  }
}

Pick pick(int W, int lf) {
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
    default: return {nullptr, 0};
  }
}

const char* error_text(int code) {
  switch (code) {
    case -1: return "negative segment, seed or event count";
    case -2: return "(W, S) beyond the dense caps";
    case -5: return "model has no dense domain (the register and the set have)";
    case -6: return "field_log2 is not the layout's field width for S";
    case -7: return "too many (segment, seed) runs for one launch";
    case -8: return "warps a CTA outside 1..8";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}

// A launch's shape: the kernel, CTAs a segment and in all, rows a tile
// and dynamic shared memory.
struct Grid {
  Pick p{nullptr, 0};
  int ctas_per_segment = 0;
  long long blocks = 0;
  int tile = 0;
  size_t smem = 0;
};

// The launch's grid, or a negative code.
int grid(int K, int NB, int E, int W, int S, int field_log2, int model,
         int warps, Grid* g) {
  if (K < 0 || NB < 0 || E < 0) return -1;
  if (W < 1 || W > kMaxSlots || S < 1 || S > kMaxStates ||
      (1 << W) * S > kMaxCells)
    return -2;
  if (model != kModelCasRegister && model != kModelSet) return -5;
  if (field_log2 < 0 || field_log2 > 4 || (1 << field_log2) < S ||
      (field_log2 > 0 && (1 << (field_log2 - 1)) >= S))
    return -6;
  g->p = pick(W, field_log2);
  if (g->p.fn == nullptr) return -6;
  if (warps < 1 || warps > kMaxSegWarps) return -8;
  const long long per_cta = static_cast<long long>(warps) * g->p.groups;
  const long long cps = (NB + per_cta - 1) / per_cta;
  g->ctas_per_segment = static_cast<int>(cps > 0 ? cps : 1);
  g->blocks = static_cast<long long>(K) * g->ctas_per_segment;
  // seed and block indices stay 32-bit in the kernel
  if (g->blocks > 0x7fffffffLL ||
      static_cast<long long>(g->ctas_per_segment) * per_cta > 0x7fffffffLL ||
      static_cast<long long>(K) * NB > 0x7fffffffLL)
    return -7;
  g->tile = max(1, min(E, kMaxTileRows));
  g->smem = smem_bytes(W, field_log2, warps, g->tile);
  return 0;
}

// Opt kernel `fn` in to `bytes` of dynamic shared memory on `device`
// when that exceeds the default 48 KB. Under a lock the limit a kernel
// holds on a device only rises, so no thread lowers it below a size
// another has just opted in to and is launching.
int opt_in(KernelFn fn, size_t bytes, int device) {
  if (bytes <= 48 * 1024) return 0;
  static std::mutex mu;
  static std::map<std::pair<KernelFn, int>, size_t> limits;
  const std::lock_guard<std::mutex> hold(mu);
  size_t& limit = limits[{fn, device}];
  if (limit >= bytes) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  limit = bytes;
  return 0;
}

// Launch the scan over K segments x NB seeds on `stream`: CTAs of
// `warps` warps (ops/segment_scan.py `segment_shape`), ⌈NB / (warps ×
// runs a warp)⌉ of them a segment, tiles of min(E, kMaxTileRows) rows,
// with the kernel instantiated for (W, field_log2) (ops/dense_scan.py
// `dense_layout`). `out` receives K * NB packed frontiers of
// max(2^(W + field_log2), 32) / 32 words each; `prof`, in the profile
// build, each warp's counters. Returns 0, a CUDA error code from the
// launch, or a negative code for refused arguments (see
// segment_scan_error_string). Does not synchronise.
int launch(const int32_t* events, const int32_t* val_of,
           const int32_t* seed_mask, const int32_t* seed_state,
           const int32_t* n_events, uint32_t* out, long long* prof, int K,
           int NB, int E, int W, int S, int field_log2, int model,
           int warps, int device, void* stream) {
  Grid g;
  const int rc = grid(K, NB, E, W, S, field_log2, model, warps, &g);
  if (rc != 0) return rc;
  if (g.blocks == 0 || NB == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int opt = opt_in(g.p.fn, g.smem, device);
  if (opt != 0) return opt;
  g.p.fn<<<static_cast<unsigned>(g.blocks), warps * 32, g.smem,
           static_cast<cudaStream_t>(stream)>>>(
      events, val_of, seed_mask, seed_state, n_events, out, prof, NB, E, S,
      model, g.ctas_per_segment, g.tile);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#ifndef SEGMENT_SCAN_PROFILE
extern "C" int segment_scan_launch(const int32_t* events,
                                   const int32_t* val_of,
                                   const int32_t* seed_mask,
                                   const int32_t* seed_state,
                                   const int32_t* n_events, uint32_t* out,
                                   int K, int NB, int E, int W, int S,
                                   int field_log2, int model, int warps,
                                   int device, void* stream) {
  return launch(events, val_of, seed_mask, seed_state, n_events, out,
                nullptr, K, NB, E, W, S, field_log2, model, warps, device,
                stream);
}

// The instantiation for (W, field_log2) and a launch over K segments x
// NB seeds of E rows in CTAs of `warps` warps: out[0] registers a
// thread, out[1] local (stack and spill) bytes, out[2] static shared
// bytes, out[3] threads a block, out[4] blocks resident on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at the launch's dynamic
// shared memory), out[5] the launch's blocks, out[6] runs a warp, out[7]
// dynamic shared bytes a block. Returns 0, a negative code for refused
// arguments, or a CUDA error code.
extern "C" int segment_scan_attributes(int W, int field_log2, int K, int NB,
                                       int E, int warps, long long* out) {
  Grid g;
  const int rc = grid(K, NB, E, W, 1 << field_log2, field_log2,
                      kModelCasRegister, warps, &g);
  if (rc != 0) return rc;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int opt = opt_in(g.p.fn, g.smem, device);
  if (opt != 0) return opt;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, g.p.fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int resident = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, g.p.fn,
                                                      warps * 32, g.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<long long>(a.localSizeBytes);
  out[2] = static_cast<long long>(a.sharedSizeBytes);
  out[3] = warps * 32;
  out[4] = resident;
  out[5] = g.blocks;
  out[6] = g.p.groups;
  out[7] = static_cast<long long>(g.smem);
  return 0;
}

extern "C" const char* segment_scan_error_string(int code) {
  return error_text(code);
}
#else
// As segment_scan_launch, with prof[warps of the launch][kProfFields]
// int64 (each warp's counters, Prof).
extern "C" int segment_scan_profile_launch(
    const int32_t* events, const int32_t* val_of, const int32_t* seed_mask,
    const int32_t* seed_state, const int32_t* n_events, uint32_t* out,
    long long* prof, int K, int NB, int E, int W, int S, int field_log2,
    int model, int warps, int device, void* stream) {
  return launch(events, val_of, seed_mask, seed_state, n_events, out, prof,
                K, NB, E, W, S, field_log2, model, warps, device, stream);
}

extern "C" int segment_scan_profile_fields() { return kProfFields; }

extern "C" const char* segment_scan_profile_error_string(int code) {
  return error_text(code);
}
#endif
