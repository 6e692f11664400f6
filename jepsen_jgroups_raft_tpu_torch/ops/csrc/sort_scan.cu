// Sort-frontier linearizability scan for Hopper (sm_90a): one block per
// history, the frontier, a hash table and one round's candidates in
// shared memory.
//
// Replaces the reference's sort kernel, jepsen_jgroups_raft_tpu/ops/
// linear_scan.py `sort_step_parts` (linear_scan.py:138) with its
// `_dedup_compact` (linear_scan.py:97), an XLA program (no
// `pallas_call`), and computes the same (ok, overflow) per history,
// bit for bit. A configuration is a K-word uint32 mask over the W window
// slots (K = W / 32 + 1, the last word's top bit spare) and an int32
// model state; the frontier holds at most C of them. Per event row:
//
//   latch    the OPEN payloads set their slots' (f, a, b); payloads that
//            share a slot in one macro row SUM into it (the reference's
//            `macro_latch_i32`);
//   closure  at a FORCE after an OPEN: rounds that expand every live
//            configuration by every open slot not in its mask whose step
//            is legal, then keep the C smallest distinct entries of
//            parents and candidates; `overflow` when there were more than
//            C; again while a round found a candidate distinct from every
//            parent, at most W + 1 rounds;
//   FORCE w  configurations without bit w die, the survivors clear it;
//            ok &= "some survivor". A slot outside [0, W) kills all.
//
// Which C entries survive a round that overflows decides the flags, so
// the order is the reference's exactly: its two stable sorts leave the
// distinct live entries ordered by the last mask word, then words 0 ..
// K-2, then the state (words unsigned, state signed). Here an entry is
// that key itself, K + 1 fields of 32 bits (the state with its sign bit
// flipped) packed high-first into (K + 2) / 2 uint64 words, so the order
// is a plain lexicographic compare. An empty entry is all ones: a live
// entry's first field (the last mask word) never has its top bit set, so
// no live key equals it, and it sorts after every one.
//
// What bounds it on this card: the serial depth of a history (a suite set
// history is ~1000 macro rows, ~390 closures of ~2.7 dependent rounds)
// and the block barriers each step of it takes; the bytes (the event
// rows) and the model steps are few. The design keeps the barriers of a
// round to one, and orders nothing it does not have to:
//
// * The frontier is a set, in no order: ent[0, n) in shared memory. A
//   round forms every (parent, open slot) candidate at once, n x |open|
//   of them (at most C x W), candidate j from parent j % n and open slot
//   j / n, `threads` at a time; a round whose candidates exceed the tile
//   (`tile` entries, sized to fit shared memory) runs tile after tile,
//   with the parents copied aside.
// * Dedup by hashing: an open-addressing table in shared memory (linear
//   probing, a power of two of at least twice the entries it can hold,
//   so a probe always ends) holds the frontier's keys from the start of
//   a closure on. A candidate that finds its key is a parent or a
//   duplicate; one that claims an empty slot is novel and appends itself
//   to ent (warp-aggregated atomic position). K = 1 stores the key
//   itself and inserts with a 64-bit atomicCAS; K >= 2 stores an entry
//   index and compares whole keys (the candidates staged in shared
//   memory, indices rewritten to their ent position after the tile).
//   `grew` is "some candidate was novel", the distinct count is parents
//   plus novel entries. The parents are in the table before any
//   candidate, so a candidate equal to a parent is never novel.
// * Order only on overflow: while a round's distinct entries fit C, the
//   new frontier is ent[0, r) as appended. Past C (after a tile), one
//   radix select over the packed key (8-bit digits, the varying bits
//   only, histograms in shared memory) finds the C-th smallest entry
//   exactly; the entries at or below it are kept and the table is built
//   again from them. The C smallest of A u B are the C smallest of (the
//   C smallest of A) u B, so the kept set is the reference's whatever
//   the tiling; once a round has overflowed, `grew` is already true, so
//   the dropped parents need no lookup.
// * A FORCE keeps the survivors distinct, in any order; the table is
//   built again at the next closure.
// * Counts taken with atomics use a ring of three counters, so a count
//   needs one barrier: a round without overflow costs one block barrier
//   (K = 1; three for K >= 2) after the closure's two.
// * The block shape follows the work: `threads` (a multiple of 32; one
//   warp takes __syncwarp for its barriers) and `tile` come from the
//   launcher (sort_shape below); shared memory above 48 KB is opted into.
// * Rows are copied into a second row buffer by cp.async while the row
//   before is processed; the scan stops at n_events or at the first dead
//   FORCE (a dead frontier stays dead and its overflow flag is final).
//
// * The chunk form (the reference's `make_sort_chunk_checker`,
//   linear_scan.py:351, under its chunked wavefront) is a second entry
//   point of the same body: the block reads the carry's live entries,
//   slot registers and scalars at the start, and at the end sorts its
//   frontier once (a bitonic sort of at most C entries) and writes it
//   back canonical: the live entries in key order, then empty ones.
//
// The model is a runtime switch (models.cuh `model_step`), so the kernel
// is instantiated only for K = 1..4.

#include <cstdint>
#include <cuda_runtime.h>

#include "models.cuh"
#include "verdict_counts.cuh"
#include "warp_frontier.cuh"

namespace {

constexpr int kSortMaxSlots = 127;    // SORT_MAX_SLOTS
constexpr int kSortMaxConfigs = 512;  // linear_scan.MAX_CONFIGS
constexpr int kSlotWords = (kSortMaxSlots + 31) / 32;
constexpr uint64_t kEmpty = ~0ull;
constexpr int kMaxThreads = 1024;
// K >= 2 table slots: an empty slot, and the tag of a staged candidate.
constexpr int32_t kNoEntry = -1;
constexpr int32_t kCandTag = 1 << 30;
// Shared memory a block may take (H100: 227 KB), static and dynamic.
constexpr size_t kSmemMax = 232448;

// A configuration as its sort key (see the header).
template <int K>
struct Key {
  static constexpr int kU64 = (K + 2) / 2;
  uint64_t v[kU64];
};

// The key field that holds mask word j: the last word first, then 0..K-2.
template <int K>
__device__ __forceinline__ int field_of_word(int j) {
  return j == K - 1 ? 0 : j + 1;
}

// (uint64 index, bit) of slot w's mask bit in a key.
template <int K>
__device__ __forceinline__ void slot_pos(int w, int* q, uint64_t* bit) {
  const int fi = field_of_word<K>(w >> 5);
  *q = fi >> 1;
  *bit = 1ull << ((fi & 1 ? 0 : 32) + (w & 31));
}

template <int K>
__device__ __forceinline__ bool has_slot(const Key<K>& x, int q,
                                         uint64_t bit) {
  uint64_t hit = 0;
#pragma unroll
  for (int i = 0; i < Key<K>::kU64; ++i) hit |= (i == q) ? (x.v[i] & bit) : 0;
  return hit != 0;
}

template <int K>
__device__ __forceinline__ void flip_slot(Key<K>& x, int q, uint64_t bit) {
#pragma unroll
  for (int i = 0; i < Key<K>::kU64; ++i) x.v[i] ^= (i == q) ? bit : 0ull;
}

// The state is field K: its uint64 word and shift are compile-time.
template <int K>
struct StatePos {
  static constexpr int kQ = K >> 1;
  static constexpr int kShift = K & 1 ? 0 : 32;
};

template <int K>
__device__ __forceinline__ int32_t get_state(const Key<K>& x) {
  const uint32_t f =
      static_cast<uint32_t>(x.v[StatePos<K>::kQ] >> StatePos<K>::kShift);
  return static_cast<int32_t>(f ^ 0x80000000u);
}

template <int K>
__device__ __forceinline__ void set_state(Key<K>& x, int32_t s) {
  constexpr int kQ = StatePos<K>::kQ, kS = StatePos<K>::kShift;
  const uint64_t f = static_cast<uint32_t>(s) ^ 0x80000000u;
  x.v[kQ] = (x.v[kQ] & ~(0xffffffffull << kS)) | (f << kS);
}

template <int K>
__device__ __forceinline__ Key<K> empty_key() {
  Key<K> x;
#pragma unroll
  for (int i = 0; i < Key<K>::kU64; ++i) x.v[i] = kEmpty;
  return x;
}

template <int K>
__device__ __forceinline__ bool key_less(const Key<K>& a, const Key<K>& b) {
  bool less = false, eq = true;
#pragma unroll
  for (int i = 0; i < Key<K>::kU64; ++i) {
    less = less || (eq && a.v[i] < b.v[i]);
    eq = eq && a.v[i] == b.v[i];
  }
  return less;
}

template <int K>
__device__ __forceinline__ bool key_eq(const Key<K>& a, const Key<K>& b) {
  bool eq = true;
#pragma unroll
  for (int i = 0; i < Key<K>::kU64; ++i) eq = eq && a.v[i] == b.v[i];
  return eq;
}

template <int K>
__device__ __forceinline__ void cmp_swap(Key<K>* a, Key<K>* b, bool up) {
  const Key<K> x = *a, y = *b;
  if (up ? key_less(y, x) : key_less(x, y)) {
    *a = y;
    *b = x;
  }
}

// A configuration's key from its K mask words and state, and back.
template <int K>
__device__ __forceinline__ Key<K> key_of(const int32_t* m, int32_t state) {
  Key<K> x;
#pragma unroll
  for (int i = 0; i < Key<K>::kU64; ++i) x.v[i] = 0ull;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int fi = field_of_word<K>(j);
    x.v[fi >> 1] |= static_cast<uint64_t>(static_cast<uint32_t>(m[j]))
                    << (fi & 1 ? 0 : 32);
  }
  set_state(x, state);
  return x;
}

template <int K>
__device__ __forceinline__ void key_words(const Key<K>& x, int32_t* m,
                                          int32_t* state) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int fi = field_of_word<K>(j);
    m[j] = static_cast<int32_t>(
        static_cast<uint32_t>(x.v[fi >> 1] >> (fi & 1 ? 0 : 32)));
  }
  *state = get_state(x);
}

__host__ __device__ __forceinline__ int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// The block barrier; a block of one warp takes the warp's.
__device__ __forceinline__ void block_sync() {
  if (blockDim.x == 32)
    __syncwarp();
  else
    __syncthreads();
}

// Uniform loop over [lo, hi) in steps of the block: every thread runs the
// same number of iterations (i past hi is idle), so warp intrinsics in
// the body see the whole warp.
#define FOR_BLOCK(i, lo, hi)                                          \
  for (int i##_base = (lo); i##_base < (hi); i##_base += blockDim.x) \
    if (const int i = i##_base + static_cast<int>(threadIdx.x); true)

// Counts taken with atomics, one per step of the block: a ring of three
// shared counters, so that reading a step's count needs one barrier (the
// counter two steps ahead is zeroed by thread 0 once the step's barrier
// has passed; the step that used it last was read before that barrier,
// the step that uses it next starts after the following one).
struct Tally {
  int* c;  // 3 shared counters, zeroed before the first barrier
  int t;
  __device__ int* cur() const { return c + t % 3; }
  // Every thread calls it once per step, after the step's barrier.
  __device__ int close() {
    const int v = c[t % 3];
    if (threadIdx.x == 0) c[(t + 2) % 3] = 0;
    ++t;
    return v;
  }
};

// Positions for the lanes of a warp with `take` set, from counter *ctr:
// every lane of the warp calls it (FOR_BLOCK bodies).
__device__ __forceinline__ int claim(bool take, int* ctr) {
  const unsigned b = __ballot_sync(kFull, take);
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (b != 0u) {
    if (lane == 0) base = atomicAdd(ctr, __popc(b));
    base = __shfl_sync(kFull, base, 0);
  }
  return base + __popc(b & ((1u << lane) - 1u));
}

// ---------------------------------------------------------- hash table

template <int K>
__device__ __forceinline__ uint32_t key_hash(const Key<K>& x, int tlog) {
  uint64_t h = 0;
#pragma unroll
  for (int i = 0; i < Key<K>::kU64; ++i)
    h = (h ^ x.v[i]) * 0x9E3779B97F4A7C15ull;
  return static_cast<uint32_t>(h >> (64 - tlog));
}

// A broken invariant (a probe that finds no free slot in a table sized to
// twice what it can hold, or equal keys in a select): the launch fails,
// so the next synchronisation raises, rather than drop an entry.
__device__ __forceinline__ void fault() { __trap(); }

// Insert x; returns whether it was absent (then it is in the table, at
// *slot). K = 1: slots hold keys (all ones empty). K >= 2: slots hold an
// ent index, or kCandTag + a staged candidate's index in cbuf; `val` is
// what x's slot takes.
template <int K>
__device__ __forceinline__ bool table_insert(void* table, int tlog,
                                             const Key<K>& x, int32_t val,
                                             const Key<K>* ent,
                                             const Key<K>* cbuf, int* slot) {
  const uint32_t mask = (1u << tlog) - 1u;
  uint32_t s = key_hash(x, tlog);
  for (uint32_t i = 0; i <= mask; ++i, s = (s + 1) & mask) {
    if constexpr (K == 1) {
      unsigned long long* t = static_cast<unsigned long long*>(table);
      unsigned long long cur = static_cast<volatile unsigned long long*>(t)[s];
      if (cur == kEmpty) cur = atomicCAS(t + s, kEmpty, x.v[0]);
      if (cur == kEmpty) {
        *slot = static_cast<int>(s);
        return true;
      }
      if (cur == x.v[0]) return false;
    } else {
      int32_t* t = static_cast<int32_t*>(table);
      int32_t cur = static_cast<volatile int32_t*>(t)[s];
      if (cur == kNoEntry) cur = atomicCAS(t + s, kNoEntry, val);
      if (cur == kNoEntry) {
        *slot = static_cast<int>(s);
        return true;
      }
      const Key<K>& o = cur >= kCandTag ? cbuf[cur - kCandTag] : ent[cur];
      if (key_eq(o, x)) return false;
    }
  }
  fault();
  return false;
}

// Empty the table and insert ent[0, n) (distinct). Ends with a barrier.
template <int K>
__device__ void table_build(void* table, int tlog, const Key<K>* ent, int n) {
  const int size = 1 << tlog;
  if constexpr (K == 1) {
    unsigned long long* t = static_cast<unsigned long long*>(table);
    for (int i = threadIdx.x; i < size; i += blockDim.x) t[i] = kEmpty;
  } else {
    int32_t* t = static_cast<int32_t*>(table);
    for (int i = threadIdx.x; i < size; i += blockDim.x) t[i] = kNoEntry;
  }
  block_sync();
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    int slot;
    table_insert<K>(table, tlog, ent[i], i, ent, nullptr, &slot);
  }
  block_sync();
}

// ------------------------------------------------------- radix select

// Shared scratch of the select.
template <int K>
struct SelectScratch {
  unsigned long long vor[Key<K>::kU64], vand[Key<K>::kU64];
  uint64_t pre[Key<K>::kU64];
  int hist[256];
  int rank, left;  // rank of the C-th in the candidates, their number
  Key<K> kth;
};

// Whether x agrees with the prefix found so far: words before q, and the
// bits of word q above `low` (its lowest bit still open).
template <int K>
__device__ __forceinline__ bool on_prefix(const Key<K>& x, const uint64_t* pre,
                                          int q, int low) {
  bool eq = true;
#pragma unroll
  for (int i = 0; i < Key<K>::kU64; ++i) {
    const uint64_t hm = i < q ? ~0ull : i > q ? 0ull
                       : low >= 64 ? 0ull : ~0ull << low;
    eq = eq && ((x.v[i] ^ pre[i]) & hm) == 0;
  }
  return eq;
}

// ent[0, r) holds r > C distinct live keys: leave the C smallest in
// ent[0, C), in any order (tmp: C keys of scratch). Starts and ends with
// a barrier passed.
template <int K>
__device__ void select_smallest(Key<K>* ent, int r, int C, Key<K>* tmp,
                                SelectScratch<K>* ss, Tally& tally) {
  constexpr int kU = Key<K>::kU64;
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kU; ++i) {
      ss->vor[i] = 0ull;
      ss->vand[i] = ~0ull;
    }
    ss->rank = C;  // the C-th smallest, counted from 1
    ss->left = r;
  }
  for (int i = tid; i < 256; i += blockDim.x) ss->hist[i] = 0;
  block_sync();
  // the bits that vary over the entries
  {
    unsigned long long o[kU], a[kU];
#pragma unroll
    for (int i = 0; i < kU; ++i) {
      o[i] = 0ull;
      a[i] = ~0ull;
    }
    for (int e = tid; e < r; e += blockDim.x) {
#pragma unroll
      for (int i = 0; i < kU; ++i) {
        o[i] |= ent[e].v[i];
        a[i] &= ent[e].v[i];
      }
    }
#pragma unroll
    for (int i = 0; i < kU; ++i) {
      atomicOr(&ss->vor[i], o[i]);
      atomicAnd(&ss->vand[i], a[i]);
    }
  }
  block_sync();
  uint64_t var[kU];
#pragma unroll
  for (int i = 0; i < kU; ++i) {
    var[i] = ss->vor[i] ^ ss->vand[i];
    if (tid == 0) ss->pre[i] = ss->vand[i];  // the common bits
  }
  block_sync();
  // MSB first: an 8-bit window at the highest open varying bit, until
  // one candidate is left (the keys are distinct); (stop_q, stop_low)
  // the prefix resolved when it is
  int stop_q = kU - 1, stop_low = 0;
  for (int q = 0; q < kU; ++q) {
    uint64_t todo = var[q];
    int done = 64;  // word q's bits from `done` up are resolved
    while (todo != 0ull) {
      const int hb = 63 - __clzll(static_cast<long long>(todo));
      // the window [low, low + 8) may overlap resolved bits: the
      // candidates agree on those
      const int low = hb >= 7 ? hb - 7 : 0;
      for (int e = tid; e < r; e += blockDim.x) {
        const Key<K> x = ent[e];
        if (on_prefix(x, ss->pre, q, done))
          atomicAdd(&ss->hist[(x.v[q] >> low) & 0xffu], 1);
      }
      block_sync();
      if (tid < 32) {
        // lane l holds bins 8l .. 8l + 7: the bin where the rank falls
        int sum = 0;
#pragma unroll
        for (int d = 0; d < 8; ++d) sum += ss->hist[8 * lane + d];
        int incl = sum;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int y = __shfl_up_sync(kFull, incl, d);
          if (lane >= d) incl += y;
        }
        const int rank = ss->rank;
        const unsigned hit = __ballot_sync(kFull, incl >= rank);
        const int src = __ffs(hit) - 1;
        if (lane == src) {
          int below = incl - sum, bin = 8 * lane;
          while (below + ss->hist[bin] < rank) below += ss->hist[bin++];
          ss->rank = rank - below;
          ss->left = ss->hist[bin];
          ss->pre[q] = (ss->pre[q] & ~(0xffull << low)) |
                       (static_cast<uint64_t>(bin) << low);
        }
        __syncwarp();
#pragma unroll
        for (int d = 0; d < 8; ++d) ss->hist[8 * lane + d] = 0;
      }
      block_sync();
      todo &= low > 0 ? ((1ull << low) - 1ull) : 0ull;
      done = low;
      stop_q = q;
      stop_low = low;
      if (ss->left == 1) break;
    }
    if (ss->left == 1) break;
  }
  // the one entry on the prefix is the C-th smallest
  for (int e = tid; e < r; e += blockDim.x) {
    const Key<K> x = ent[e];
    if (on_prefix(x, ss->pre, stop_q, stop_low)) ss->kth = x;
  }
  if (ss->left != 1 && tid == 0) fault();  // equal keys
  block_sync();
  const Key<K> kth = ss->kth;
  FOR_BLOCK(e, 0, r) {
    const bool keep = e < r && !key_less(kth, ent[e]);
    const int pos = claim(keep, tally.cur());
    if (keep) tmp[pos] = ent[e];
  }
  block_sync();
  tally.close();  // the C kept
  for (int e = tid; e < C; e += blockDim.x) ent[e] = tmp[e];
  block_sync();
}

// The chunk carry of one history (ops/linear_scan.py sort_carry_layout):
// int32 fields ok, overflow, dirty, left (kCarryHead), per slot open, f,
// a, b [W], states [C], masks [C][K]. The frontier is canonical: the
// live configurations first, in key order (the reference's), then empty
// entries (every word all ones, state 0).
struct SortCarry {
  int W, C, K;
  __host__ __device__ int open() const { return kCarryHead; }
  __host__ __device__ int f() const { return kCarryHead + W; }
  __host__ __device__ int a() const { return kCarryHead + 2 * W; }
  __host__ __device__ int b() const { return kCarryHead + 3 * W; }
  __host__ __device__ int states() const { return kCarryHead + 4 * W; }
  __host__ __device__ int masks() const { return states() + C; }
  __host__ __device__ int len() const { return masks() + C * K; }
};

// The block's shared memory (dynamic), in entries: ent (the frontier and
// a round's appended entries), tmp (C), par (the parents of a tiled
// round), cbuf (K >= 2: a tile's staged candidates), the table, and
// wslot (K >= 2: a tile's claimed slots and the ent positions of their
// entries, two ints a candidate).
struct SortSmem {
  int ent, tmp, par, cbuf, wslot;
  size_t table_bytes, bytes;
};

__host__ __device__ inline SortSmem sort_smem(int W, int C, int K, int tile,
                                              int tlog) {
  const size_t kb = sizeof(uint64_t) * ((K + 2) / 2);
  SortSmem s;
  s.ent = C + tile > pow2_at_least(C) ? C + tile : pow2_at_least(C);
  s.tmp = C;
  s.par = C * W > tile ? C : 0;
  s.cbuf = K >= 2 ? tile : 0;
  s.wslot = K >= 2 ? 2 * tile : 0;
  s.table_bytes = (static_cast<size_t>(1) << tlog) * (K == 1 ? 8 : 4);
  s.bytes = (s.ent + s.tmp + s.par + s.cbuf) * kb + s.table_bytes +
            s.wslot * sizeof(int32_t);
  return s;
}

// One kernel body, two entry points. One-shot (sort_scan_launch):
// carry_in, carry_out and flags null; one configuration (the empty
// mask, the initial state), n_events[h] rows, ok_out and overflow_out.
// Chunk (sort_scan_chunk_launch): the frontier, slot registers and
// scalars from carry_in, min(left, E) rows of the slice, then carry_out
// (its frontier sorted) with left - E and the four flags. kCount
// (one-shot only) also counts the row's flags into counts[2] in sort
// mode, real[h] (null: every row real) masking padding rows out
// (verdict_counts.cuh: thread 0 holds both flags, warp 0 counts); the
// instances without it are the same code as before the counts existed.
template <int K, bool kCount>
__global__ void __launch_bounds__(K == 1 ? kMaxThreads : kMaxThreads / 2)
    sort_scan_block(const int32_t* __restrict__ events, long long row_stride,
                    const int32_t* __restrict__ n_events,
                    const int32_t* __restrict__ carry_in,
                    int32_t* __restrict__ carry_out,
                    uint8_t* __restrict__ flags,
                    uint8_t* __restrict__ ok_out,
                    uint8_t* __restrict__ overflow_out, int B, int E, int R,
                    int macro_p, int W, int C, int tile, int tlog, int model,
                    int32_t init_state, const uint8_t* __restrict__ real,
                    unsigned long long* __restrict__ counts) {
  extern __shared__ uint64_t smem[];
  const SortSmem lay_s = sort_smem(W, C, K, tile, tlog);
  Key<K>* ent = reinterpret_cast<Key<K>*>(smem);
  Key<K>* tmp = ent + lay_s.ent;
  Key<K>* par = tmp + lay_s.tmp;
  Key<K>* cbuf = par + lay_s.par;
  void* table = cbuf + lay_s.cbuf;
  int32_t* wslot = reinterpret_cast<int32_t*>(
      reinterpret_cast<char*>(table) + lay_s.table_bytes);
  __shared__ int32_t sf[kSortMaxSlots], sa[kSortMaxSlots], sb[kSortMaxSlots];
  __shared__ uint32_t open[kSlotWords];
  __shared__ int32_t olist[kSortMaxSlots];
  __shared__ int32_t rows[2][kRowPitch];
  __shared__ int counters[3];
  __shared__ int n_open_slots;
  __shared__ SelectScratch<K> ss;

  const int tid = threadIdx.x;
  const int h = blockIdx.x;
  const SortCarry lay{W, C, K};
  const int32_t* cin =
      carry_in ? carry_in + static_cast<size_t>(h) * lay.len() : nullptr;
  const int32_t* ev = events + static_cast<size_t>(h) * row_stride;
  const int left = cin ? cin[kCarryLeft] : n_events[h];
  bool ok = cin ? cin[kCarryOk] != 0 : true;
  bool overflow = cin ? cin[kCarryOverflow] != 0 : false;
  bool dirty = cin ? cin[kCarryDirty] != 0 : false;
  const int n_rows = ok ? min(max(left, 0), E) : 0;
  Tally tally{counters, 0};

  for (int s = tid; s < W; s += blockDim.x) {
    sf[s] = cin ? cin[lay.f() + s] : 0;
    sa[s] = cin ? cin[lay.a() + s] : 0;
    sb[s] = cin ? cin[lay.b() + s] : 0;
  }
  if (tid < kSlotWords) open[tid] = 0u;
  if (tid < 3) counters[tid] = 0;
  block_sync();
  int n = 1;  // live configurations, ent[0, n), distinct, in no order
  if (cin) {
    for (int s = tid; s < W; s += blockDim.x)
      if (cin[lay.open() + s] != 0) atomicOr(&open[s >> 5], 1u << (s & 31));
    FOR_BLOCK(i, 0, C) {
      bool live = false;
      Key<K> x = empty_key<K>();
      if (i < C) {
        const int32_t* m = cin + lay.masks() + static_cast<size_t>(i) * K;
        live = m[K - 1] != -1;
        if (live) x = key_of<K>(m, cin[lay.states() + i]);
      }
      const int pos = claim(live, tally.cur());
      if (live) ent[pos] = x;
    }
  } else if (tid == 0) {
    Key<K> x;
#pragma unroll
    for (int i = 0; i < Key<K>::kU64; ++i) x.v[i] = 0ull;
    set_state(x, init_state);  // the empty mask, the initial state
    ent[0] = x;
  }
  if (n_rows > 0)
    for (int i = tid; i < R; i += blockDim.x) rows[0][i] = ev[i];
  block_sync();
  if (cin) n = tally.close();

  const int first = macro_p ? 3 : 1;  // first payload (slot, f, a, b)
  for (int e = 0; e < n_rows; ++e) {
    // the next row lands in the other buffer while this one runs
    if (e + 1 < n_rows) {
      const int32_t* src = ev + static_cast<size_t>(e + 1) * R;
      for (int i = tid; i < R; i += blockDim.x)
        cp_async4(&rows[(e + 1) & 1][i], src + i);
    }
    cp_async_commit();
    const int32_t* row = rows[e & 1];
    const int32_t kind = row[0];
    const int32_t fslot = row[1];
    const int n_open =
        macro_p ? min(max(row[2], 0), macro_p) : (kind == kEvOpen);

    // ---- latch: thread s folds in the payloads of slot s
    if (n_open > 0) {
      dirty = true;
      for (int s = tid; s < W; s += blockDim.x) {
        uint32_t nf = 0, na = 0, nb = 0;
        bool hit = false;
        for (int p = 0; p < n_open; ++p) {
          const int32_t* pay = row + first + 4 * p;
          if (pay[0] != s) continue;
          hit = true;
          nf += static_cast<uint32_t>(pay[1]);
          na += static_cast<uint32_t>(pay[2]);
          nb += static_cast<uint32_t>(pay[3]);
        }
        if (hit) {
          sf[s] = static_cast<int32_t>(nf);
          sa[s] = static_cast<int32_t>(na);
          sb[s] = static_cast<int32_t>(nb);
          atomicOr(&open[s >> 5], 1u << (s & 31));
        }
      }
      block_sync();
    }

    if (kind == kEvForce) {
      // ---- closure, only when an OPEN came since the last FORCE
      if (dirty) {
        if (tid == 0) {  // the open slots, in order
          int k = 0;
          for (int i = 0; i < kSlotWords; ++i) {
            uint32_t bits = open[i];
            while (bits != 0u) {
              olist[k++] = 32 * i + __ffs(bits) - 1;
              bits &= bits - 1u;
            }
          }
          n_open_slots = k;
        }
        block_sync();
        const int nopen = n_open_slots;
        table_build<K>(table, tlog, ent, n);
        for (int it = 0; it <= W; ++it) {
          const int total = n * nopen;
          const Key<K>* src = ent;
          if (total > tile) {  // tiled: the parents aside
            for (int i = tid; i < n; i += blockDim.x) par[i] = ent[i];
            block_sync();
            src = par;
          }
          int r = n;
          bool grew = false;
          for (int t0 = 0; t0 < total; t0 += tile) {
            const int t1 = min(total, t0 + tile);
            if constexpr (K == 1) {
              FOR_BLOCK(j, t0, t1) {
                Key<K> c = empty_key<K>();
                bool novel = false;
                if (j < t1) {
                  const int w = olist[j / n];
                  const Key<K> p = src[j % n];
                  int q;
                  uint64_t bit;
                  slot_pos<K>(w, &q, &bit);
                  if (!has_slot(p, q, bit)) {
                    int32_t next;
                    bool legal;
                    model_step(model, get_state(p), sf[w], sa[w], sb[w],
                               &next, &legal);
                    if (legal) {
                      c = p;
                      flip_slot(c, q, bit);
                      set_state(c, next);
                      int slot;
                      novel = table_insert<K>(table, tlog, c, 0, nullptr,
                                              nullptr, &slot);
                    }
                  }
                }
                const int pos = claim(novel, tally.cur());
                if (novel) ent[r + pos] = c;
              }
              block_sync();
            } else {
              FOR_BLOCK(j, t0, t1) {
                if (j < t1) {
                  Key<K> c = empty_key<K>();
                  const int w = olist[j / n];
                  const Key<K> p = src[j % n];
                  int q;
                  uint64_t bit;
                  slot_pos<K>(w, &q, &bit);
                  if (!has_slot(p, q, bit)) {
                    int32_t next;
                    bool legal;
                    model_step(model, get_state(p), sf[w], sa[w], sb[w],
                               &next, &legal);
                    if (legal) {
                      c = p;
                      flip_slot(c, q, bit);
                      set_state(c, next);
                    }
                  }
                  cbuf[j - t0] = c;
                }
              }
              block_sync();
              FOR_BLOCK(j, t0, t1) {
                bool novel = false;
                int slot = -1;
                Key<K> c = empty_key<K>();
                if (j < t1) {
                  c = cbuf[j - t0];
                  if (c.v[0] != kEmpty)
                    novel = table_insert<K>(table, tlog, c,
                                            kCandTag + (j - t0), ent, cbuf,
                                            &slot);
                }
                const int pos = claim(novel, tally.cur());
                if (novel) {
                  ent[r + pos] = c;
                  wslot[2 * (j - t0)] = slot;
                  wslot[2 * (j - t0) + 1] = r + pos;
                } else if (j < t1) {
                  wslot[2 * (j - t0)] = -1;
                }
              }
              block_sync();
            }
            const int won = tally.close();
            if constexpr (K >= 2) {
              // the staged candidates' slots now name their ent entries
              for (int j = tid; j < t1 - t0; j += blockDim.x)
                if (wslot[2 * j] >= 0)
                  static_cast<int32_t*>(table)[wslot[2 * j]] =
                      wslot[2 * j + 1];
              block_sync();
            }
            r += won;
            grew = grew || won > 0;
            if (r > C) {
              select_smallest<K>(ent, r, C, tmp, &ss, tally);
              r = C;
              overflow = true;
              table_build<K>(table, tlog, ent, C);
            }
          }
          n = r;
          if (!grew) break;
        }
        dirty = false;
      }
      // ---- FORCE: survivors hold the slot's bit, which is cleared
      const bool in_range = fslot >= 0 && fslot < W;
      int q = 0;
      uint64_t bit = 0;
      if (in_range) slot_pos<K>(fslot, &q, &bit);
      FOR_BLOCK(i, 0, n) {
        bool keep = false;
        Key<K> x;
        if (in_range && i < n) {
          x = ent[i];
          if (has_slot(x, q, bit)) {
            keep = true;
            flip_slot(x, q, bit);
          }
        }
        const int pos = claim(keep, tally.cur());
        if (keep) tmp[pos] = x;
      }
      block_sync();
      n = tally.close();
      for (int i = tid; i < n; i += blockDim.x) ent[i] = tmp[i];
      if (tid == 0 && in_range) atomicAnd(&open[fslot >> 5],
                                          ~(1u << (fslot & 31)));
      ok = n > 0;
    }
    cp_async_wait<0>();
    block_sync();
    if (!ok) break;
  }
  cp_async_wait<0>();
  if (ok_out != nullptr && tid == 0) {
    ok_out[h] = ok ? 1 : 0;
    overflow_out[h] = overflow ? 1 : 0;
  }
  if constexpr (kCount) {
    if (tid < 32) {
      const uint32_t r = tid == 0 && (real == nullptr || real[h] != 0);
      count_rows(valid_bits<kCountSort>(ok, overflow, r), overflow & r, 1,
                 counts);
    }
  }
  if (carry_out != nullptr) {
    // the frontier canonical: one bitonic sort, ascending; empty last
    const int L = pow2_at_least(max(n, 1));
    for (int i = n + tid; i < L; i += blockDim.x) ent[i] = empty_key<K>();
    block_sync();
    for (int k = 2; k <= L; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        for (int p = tid; p < (L >> 1); p += blockDim.x) {
          const int i = 2 * j * (p / j) + (p % j);
          cmp_swap(&ent[i], &ent[i + j], (i & k) == 0);
        }
        block_sync();
      }
    }
    int32_t* cout = carry_out + static_cast<size_t>(h) * lay.len();
    for (int s = tid; s < W; s += blockDim.x) {
      cout[lay.f() + s] = sf[s];
      cout[lay.a() + s] = sa[s];
      cout[lay.b() + s] = sb[s];
      cout[lay.open() + s] = (open[s >> 5] >> (s & 31)) & 1u;
    }
    for (int i = tid; i < C; i += blockDim.x) {
      int32_t* m = cout + lay.masks() + static_cast<size_t>(i) * K;
      if (i < n) {
        key_words<K>(ent[i], m, cout + lay.states() + i);
      } else {
#pragma unroll
        for (int j = 0; j < K; ++j) m[j] = -1;
        cout[lay.states() + i] = 0;
      }
    }
    if (tid == 0) write_head(cout, flags, h, B, ok, overflow, dirty, left - E);
  }
}

using KernelFn = void (*)(const int32_t*, long long, const int32_t*,
                          const int32_t*, int32_t*, uint8_t*, uint8_t*,
                          uint8_t*, int, int, int, int, int, int, int, int,
                          int, int32_t, const uint8_t*, unsigned long long*);

template <bool kCount>
KernelFn pick_words(int K) {
  switch (K) {
    case 1: return sort_scan_block<1, kCount>;
    case 2: return sort_scan_block<2, kCount>;
    case 3: return sort_scan_block<3, kCount>;
    case 4: return sort_scan_block<4, kCount>;
    default: return nullptr;
  }
}

KernelFn pick(int K, bool count) {
  return count ? pick_words<true>(K) : pick_words<false>(K);
}

int max_threads(int K) { return K == 1 ? kMaxThreads : kMaxThreads / 2; }

// The launch shape of (W, C): threads, tile, table size, shared memory.
// threads <= 0 takes the default, a quarter of a round's most candidates
// (C x W, rounded up to a power of two); either is cut to whole warps
// within [32, the kernel's bound];
// smem_cap <= 0 the default cap on the dynamic shared memory. The tile
// starts at a round's most candidates, at most 8 a thread, and halves
// (not below the block) until the table (twice the entries it can hold:
// C and a tile), the buffers and the static part fit the cap.
struct Shape {
  int threads, tile, tlog;
  size_t smem;
};

constexpr size_t kSmemCapDefault = 96 * 1024;

Shape sort_shape(int W, int C, int threads, int smem_cap) {
  const int K = W / 32 + 1;
  const int want = pow2_at_least(C * W);
  Shape s;
  s.threads = max(32, min(max_threads(K), threads > 0 ? threads / 32 * 32
                                                      : want / 4));
  s.tile = min(want, 8 * s.threads);
  const size_t cap = smem_cap > 0 ? static_cast<size_t>(smem_cap)
                                  : kSmemCapDefault;
  for (;;) {
    int tlog = 0;
    while ((1 << tlog) < 2 * (C + s.tile)) ++tlog;
    s.tlog = tlog;
    s.smem = sort_smem(W, C, K, s.tile, tlog).bytes;
    if (s.smem <= cap || s.tile <= s.threads) break;
    s.tile /= 2;
  }
  return s;
}

int launch(const int32_t* events, long long row_stride,
           const int32_t* n_events, const int32_t* carry_in,
           int32_t* carry_out, uint8_t* flags, uint8_t* ok,
           uint8_t* overflow, const uint8_t* real, long long* counts, int B,
           int E, int R, int macro_p, int W, int C, int model, int init_state,
           int threads, int tile, int tlog, int device, void* stream) {
  if (B < 0 || E < 0) return -1;
  if (W < 1 || W > kSortMaxSlots) return -2;
  if (macro_p < 0 || macro_p > kMaxOpens) return -3;
  if (R != (macro_p ? 3 + 4 * macro_p : 5)) return -4;
  if (model < kModelCasRegister || model > kModelListAppend) return -5;
  if (C < 1 || C > kSortMaxConfigs) return -6;
  const int K = W / 32 + 1;
  const KernelFn kernel = pick(K, counts != nullptr);
  if (kernel == nullptr) return -2;
  if (threads < 32 || threads % 32 != 0 || threads > max_threads(K))
    return -8;
  if (tile < 1 || tile > 8 * threads) return -9;
  if (tlog < 1 || tlog > 20 || (1 << tlog) < 2 * (C + tile)) return -10;
  const size_t smem = sort_smem(W, C, K, tile, tlog).bytes;
  cudaFuncAttributes attr;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (smem + attr.sharedSizeBytes > kSmemMax) return -11;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (counts != nullptr) {  // the blocks add into zeroed counters
    err = cudaMemsetAsync(counts, 0, 2 * sizeof(long long), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (B == 0) return 0;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B, threads, smem, s>>>(
      events, row_stride, n_events, carry_in, carry_out, flags, ok, overflow,
      B, E, R, macro_p, W, C, tile, tlog, model, init_state, real,
      reinterpret_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The launch shape the kernel takes for (W, C) (threads and smem_cap <=
// 0: the defaults): out[0..4] = threads, tile, log2 of the table's
// slots, dynamic shared memory bytes. Returns 0, or -2 / -6 for W or C
// beyond the caps.
extern "C" int sort_scan_shape(int W, int C, int threads, int smem_cap,
                               long long* out) {
  if (W < 1 || W > kSortMaxSlots) return -2;
  if (C < 1 || C > kSortMaxConfigs) return -6;
  const Shape s = sort_shape(W, C, threads, smem_cap);
  out[0] = s.threads;
  out[1] = s.tile;
  out[2] = s.tlog;
  out[3] = static_cast<long long>(s.smem);
  return 0;
}

// Launch the scan over B histories on `stream`, one block per history of
// `threads` threads with a round's candidates taken `tile` at a time and
// a table of 2^tlog slots (sort_scan_shape gives them), the kernel
// instantiated for K = W / 32 + 1 mask words; `model` is the model's
// KERNEL_MODEL and init_state its initial state. Writes ok and overflow
// per history; with counts (int64 [2], else null) the epilogue also
// counts them in sort mode, real [B] (null: every row) masking rows out;
// counts is zeroed on `stream` first. Returns 0, a CUDA error code from
// the launch, or a negative code for refused arguments (see
// sort_scan_error_string). Does not synchronise.
extern "C" int sort_scan_launch(const int32_t* events, const int32_t* n_events,
                                uint8_t* ok, uint8_t* overflow,
                                const uint8_t* real, long long* counts, int B,
                                int E, int R, int macro_p, int W, int C,
                                int model, int init_state, int threads,
                                int tile, int tlog, int device, void* stream) {
  return launch(events, static_cast<long long>(E) * R, n_events, nullptr,
                nullptr, nullptr, ok, overflow, real, counts, B, E, R, macro_p,
                W, C, model, init_state, threads, tile, tlog, device, stream);
}

// Launch one chunk over B histories on `stream`: history h's frontier,
// slot registers and scalars from row h of carry_in (carry_len ints,
// SortCarry's layout), its event rows from events + h * row_stride
// (width rows of R ints; a slice of a longer batch), the state after
// them to row h of carry_out and its four flags to flags[k * B + h].
// The shape as sort_scan_launch's. Returns as sort_scan_launch; -7 when
// carry_len is not the layout's length. Does not synchronise.
extern "C" int sort_scan_chunk_launch(const int32_t* events,
                                      const int32_t* carry_in,
                                      int32_t* carry_out, uint8_t* flags,
                                      long long row_stride, int B, int width,
                                      int R, int macro_p, int W, int C,
                                      int model, int carry_len, int threads,
                                      int tile, int tlog, int device,
                                      void* stream) {
  if (W >= 1 && W <= kSortMaxSlots && C >= 1 &&
      carry_len != SortCarry{W, C, W / 32 + 1}.len())
    return -7;
  return launch(events, row_stride, nullptr, carry_in, carry_out, flags,
                nullptr, nullptr, nullptr, nullptr, B, width, R, macro_p, W, C,
                model, 0, threads, tile, tlog, device, stream);
}

extern "C" const char* sort_scan_error_string(int code) {
  switch (code) {
    case -1: return "negative batch or event count";
    case -2: return "W beyond the sort caps (1..127)";
    case -3: return "macro_p beyond MACRO_MAX_OPENS";
    case -4: return "row width does not match macro_p";
    case -5: return "unknown model id";
    case -6: return "n_configs beyond the kernel's caps (1..512)";
    case -7: return "carry length does not match the carry layout";
    case -8: return "threads not a multiple of 32 within the kernel's bound";
    case -9: return "tile beyond 1 .. 8 x threads";
    case -10: return "hash table smaller than twice the entries it must hold";
    case -11: return "shared memory beyond the block's 227 KB";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
