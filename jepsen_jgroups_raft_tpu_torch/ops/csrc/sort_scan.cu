// Sort-frontier linearizability scan for Hopper (sm_90a): one block per
// history, one thread per configuration, the frontier in shared memory.
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
// Which C entries survive a round decides the flags of a row that
// overflowed, so the order is the reference's exactly: its two stable
// sorts leave the distinct live entries ordered by the last mask word,
// then words 0 .. K-2, then the state (words unsigned, state signed).
// Here an entry is that key itself, K + 1 fields of 32 bits (the state
// with its sign bit flipped) packed high-first into (K + 2) / 2 uint64
// words, so the order is a plain lexicographic compare. An empty entry is
// all ones: a live entry's first field (the last mask word) never has its
// top bit set, so no live key equals it, and it sorts after every one.
//
// What bounds it on this card: serial depth and block barriers. A suite
// set history is ~1000 macro rows, each FORCE a closure of a few rounds
// that depend on one another, and each round a sort in shared memory; the
// bytes (the event rows) and the model steps are few. This first version
// is simple and exact, and leaves speed to later work:
//
// * One block per history, T = max(Cp, 32) threads, Cp = C rounded up to
//   a power of two, so each thread holds one parent. The parents live in
//   shared memory, sorted ascending and distinct; both survive a FORCE
//   (clearing one bit in every survivor keeps their order and keeps them
//   distinct), so a round never sorts its parents.
// * A round merges one open slot at a time into a running set R (sorted,
//   distinct, at most C entries), starting from the parents: thread t
//   forms parent t's candidate for the slot; the candidates (at most n,
//   the number of parents) are sorted descending by a bitonic sort and
//   bitonic-merged with R; a block scan over "differs from its left
//   neighbour" deduplicates and compacts the first C. The C smallest of
//   A ∪ B are the C smallest of (the C smallest of A) ∪ B, so the kept
//   set is the reference's whatever the order of slots; "more than C
//   distinct" first shows at a merge that leaves more than C, because
//   until then R holds every entry seen. Buffers take 3 Cp entries, so a
//   round's memory does not grow with W. Candidates are always formed
//   from the round's parents, and a slot none of whose candidates is
//   legal is skipped.
// * `grew` is "some candidate equals no parent", even one that a merge
//   drops: each candidate is looked up in the sorted parents by binary
//   search.
// * Sizes follow the frontier: a merge sorts max(|R|, n) rounded up to a
//   power of two, not Cp.
// * Rows are copied into a second row buffer by cp.async while the row
//   before is processed; the scan stops at n_events or at the first dead
//   FORCE (a dead frontier stays dead and its overflow flag is final).
//
// * The chunk form (the reference's `make_sort_chunk_checker`,
//   linear_scan.py:351, under its chunked wavefront) is a second
//   entry point of the same body: the block reads the carry's frontier
//   (compacting its live entries with a block scan), slot registers and
//   scalars at the start, and writes them back canonical at the end:
//   the live entries in key order, then empty ones (~5 KB a history at
//   C = 256, K = 4). Shared memory does not grow.
//
// The model is a runtime switch (models.cuh `model_step`), so the kernel
// is instantiated only for K = 1..4.

#include <cstdint>
#include <cuda_runtime.h>

#include "models.cuh"
#include "warp_frontier.cuh"

namespace {

constexpr int kSortMaxSlots = 127;    // SORT_MAX_SLOTS
constexpr int kSortMaxConfigs = 512;  // linear_scan.MAX_CONFIGS
constexpr int kSlotWords = (kSortMaxSlots + 31) / 32;
constexpr uint64_t kEmpty = ~0ull;

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
__device__ __forceinline__ bool is_live(const Key<K>& x) {
  return x.v[0] != kEmpty;
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

// Whether c is one of the n sorted entries of p (binary search).
template <int K>
__device__ __forceinline__ bool contains(const Key<K>* p, int n,
                                         const Key<K>& c) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key_less(p[mid], c))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < n && key_eq(p[lo], c);
}

// Exclusive prefix sum of v over the block; *total gets the sum. Every
// thread must call it; it ends with a barrier.
__device__ __forceinline__ int block_scan(int v, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int t = lane < n_warps ? warp_tot[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, t, d);
      if (lane >= d) t += y;
    }
    if (lane < n_warps) warp_tot[lane] = t;
  }
  __syncthreads();
  const int before = warp > 0 ? warp_tot[warp - 1] : 0;
  *total = warp_tot[n_warps - 1];
  __syncthreads();  // warp_tot is reused by the next scan
  return before + x - v;
}

__host__ __device__ __forceinline__ int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

// Merge open slot w's candidates into the running set buf[0, *r) (sorted,
// distinct). Parents par[0, n) sorted and distinct. Sets *grew when a
// candidate equals no parent and *over when the merge holds more than C
// distinct entries; keeps the C smallest. Block-uniform; returns without
// a merge when no candidate is legal.
template <int K>
__device__ __forceinline__ void merge_slot(
    const Key<K>* par, int n, Key<K>* buf, int* r, int w, int C,
    const int32_t* sf, const int32_t* sa, const int32_t* sb, int model,
    int* warp_tot, bool* grew, bool* over) {
  const int tid = threadIdx.x;
  int q;
  uint64_t bit;
  slot_pos<K>(w, &q, &bit);
  Key<K> c = empty_key<K>();
  bool good = false, fresh = false;
  if (tid < n) {
    const Key<K> p = par[tid];
    if (!has_slot(p, q, bit)) {
      int32_t next;
      bool legal;
      model_step(model, get_state(p), sf[w], sa[w], sb[w], &next, &legal);
      if (legal) {
        c = p;
        flip_slot(c, q, bit);
        set_state(c, next);
        good = true;
        fresh = !contains(par, n, c);
      }
    }
  }
  if (!__syncthreads_or(good)) return;
  if (__syncthreads_or(fresh)) *grew = true;

  // R in buf[0, L) (empty past *r), the candidates in buf[L, 2L)
  const int L = pow2_at_least(max(*r, n));
  if (tid < L) {
    buf[L + tid] = c;  // empty for tid >= n or an illegal step
    if (tid >= *r) buf[tid] = empty_key<K>();
  }
  __syncthreads();
  // bitonic sort of the candidates, descending
  for (int k = 2; k <= L; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = tid; p < (L >> 1); p += blockDim.x) {
        const int i = 2 * j * (p / j) + (p % j);
        cmp_swap(&buf[L + i], &buf[L + i + j], (i & k) != 0);
      }
      __syncthreads();
    }
  }
  // R ascending then the candidates descending: one bitonic merge
  for (int j = L; j > 0; j >>= 1) {
    for (int p = tid; p < L; p += blockDim.x) {
      const int i = 2 * j * (p / j) + (p % j);
      cmp_swap(&buf[i], &buf[i + j], true);
    }
    __syncthreads();
  }
  // dedup and compact: thread t holds entries 2t and 2t + 1
  Key<K> a = empty_key<K>(), b = empty_key<K>();
  int ka = 0, kb = 0;
  if (tid < L) {
    a = buf[2 * tid];
    b = buf[2 * tid + 1];
    const Key<K> prev = tid > 0 ? buf[2 * tid - 1] : empty_key<K>();
    ka = is_live(a) && !key_eq(a, prev);
    kb = is_live(b) && !key_eq(b, a);
  }
  int total;
  const int pos = block_scan(ka + kb, warp_tot, &total);
  if (ka && pos < C) buf[pos] = a;
  if (kb && pos + ka < C) buf[pos + ka] = b;
  __syncthreads();
  if (total > C) *over = true;
  *r = min(total, C);
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

// One kernel body, two entry points. One-shot (sort_scan_launch):
// carry_in, carry_out and flags null; one configuration (the empty
// mask, the initial state), n_events[h] rows, ok_out and overflow_out.
// Chunk (sort_scan_chunk_launch): the frontier, slot registers and
// scalars from carry_in (its live entries are sorted and distinct, as
// this kernel and the plain version write them), min(left, E) rows of
// the slice, then carry_out with left - E and the four flags.
template <int K>
__global__ void __launch_bounds__(kSortMaxConfigs)
    sort_scan_block(const int32_t* __restrict__ events, long long row_stride,
                    const int32_t* __restrict__ n_events,
                    const int32_t* __restrict__ carry_in,
                    int32_t* __restrict__ carry_out,
                    uint8_t* __restrict__ flags,
                    uint8_t* __restrict__ ok_out,
                    uint8_t* __restrict__ overflow_out, int B, int E, int R,
                    int macro_p, int W, int C, int Cp, int model,
                    int32_t init_state) {
  extern __shared__ uint64_t smem[];
  Key<K>* par = reinterpret_cast<Key<K>*>(smem);  // Cp parents
  Key<K>* buf = par + Cp;                         // 2 Cp: R, candidates
  int* warp_tot = reinterpret_cast<int*>(buf + 2 * Cp);
  __shared__ int32_t sf[kSortMaxSlots], sa[kSortMaxSlots], sb[kSortMaxSlots];
  __shared__ uint32_t open[kSlotWords];
  __shared__ int32_t rows[2][kRowPitch];

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

  for (int s = tid; s < W; s += blockDim.x) {
    sf[s] = cin ? cin[lay.f() + s] : 0;
    sa[s] = cin ? cin[lay.a() + s] : 0;
    sb[s] = cin ? cin[lay.b() + s] : 0;
  }
  if (tid < kSlotWords) open[tid] = 0u;
  __syncthreads();
  int n = 1;  // live parents, par[0, n) sorted and distinct
  if (cin) {
    for (int s = tid; s < W; s += blockDim.x)
      if (cin[lay.open() + s] != 0) atomicOr(&open[s >> 5], 1u << (s & 31));
    // the carry's live entries, squeezed to the front in their order
    bool live = false;
    Key<K> x = empty_key<K>();
    if (tid < C) {
      const int32_t* m = cin + lay.masks() + static_cast<size_t>(tid) * K;
      live = m[K - 1] != -1;
      if (live) x = key_of<K>(m, cin[lay.states() + tid]);
    }
    const int pos = block_scan(live ? 1 : 0, warp_tot, &n);
    if (live) par[pos] = x;
  } else if (tid == 0) {
    Key<K> x;
#pragma unroll
    for (int i = 0; i < Key<K>::kU64; ++i) x.v[i] = 0ull;
    set_state(x, init_state);  // the empty mask, the initial state
    par[0] = x;
  }
  if (n_rows > 0)
    for (int i = tid; i < R; i += blockDim.x) rows[0][i] = ev[i];
  __syncthreads();

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
      __syncthreads();
    }

    if (kind == kEvForce) {
      // ---- closure, only when an OPEN came since the last FORCE
      if (dirty) {
        for (int it = 0; it <= W; ++it) {
          int r = n;
          for (int i = tid; i < n; i += blockDim.x) buf[i] = par[i];
          bool grew = false, over = false;
          for (int w = 0; w < W; ++w) {
            if (!((open[w >> 5] >> (w & 31)) & 1u)) continue;
            merge_slot<K>(par, n, buf, &r, w, C, sf, sa, sb, model, warp_tot,
                          &grew, &over);
          }
          __syncthreads();
          for (int i = tid; i < r; i += blockDim.x) par[i] = buf[i];
          n = r;
          overflow = overflow || over;
          __syncthreads();
          if (!grew) break;
        }
        dirty = false;
      }
      // ---- FORCE: survivors hold the slot's bit, which is cleared
      const bool in_range = fslot >= 0 && fslot < W;
      int keep = 0;
      Key<K> x = empty_key<K>();
      if (in_range && tid < n) {
        int q;
        uint64_t bit;
        slot_pos<K>(fslot, &q, &bit);
        x = par[tid];
        if (has_slot(x, q, bit)) {
          keep = 1;
          flip_slot(x, q, bit);
        }
      }
      int total;
      const int pos = block_scan(keep, warp_tot, &total);
      if (keep) par[pos] = x;
      if (tid == 0 && in_range) atomicAnd(&open[fslot >> 5],
                                          ~(1u << (fslot & 31)));
      n = total;
      ok = total > 0;
    }
    cp_async_wait<0>();
    __syncthreads();
    if (!ok) break;
  }
  cp_async_wait<0>();
  if (ok_out != nullptr && tid == 0) {
    ok_out[h] = ok ? 1 : 0;
    overflow_out[h] = overflow ? 1 : 0;
  }
  if (carry_out != nullptr) {
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
        key_words<K>(par[i], m, cout + lay.states() + i);
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
                          int32_t);

KernelFn pick(int K) {
  switch (K) {
    case 1: return sort_scan_block<1>;
    case 2: return sort_scan_block<2>;
    case 3: return sort_scan_block<3>;
    case 4: return sort_scan_block<4>;
    default: return nullptr;
  }
}

size_t key_bytes(int K) { return sizeof(uint64_t) * ((K + 2) / 2); }

int launch(const int32_t* events, long long row_stride,
           const int32_t* n_events, const int32_t* carry_in,
           int32_t* carry_out, uint8_t* flags, uint8_t* ok,
           uint8_t* overflow, int B, int E, int R, int macro_p, int W, int C,
           int model, int init_state, int device, void* stream) {
  if (B < 0 || E < 0) return -1;
  if (W < 1 || W > kSortMaxSlots) return -2;
  if (macro_p < 0 || macro_p > kMaxOpens) return -3;
  if (R != (macro_p ? 3 + 4 * macro_p : 5)) return -4;
  if (model < kModelCasRegister || model > kModelListAppend) return -5;
  if (C < 1 || C > kSortMaxConfigs) return -6;
  const int K = W / 32 + 1;
  const KernelFn kernel = pick(K);
  if (kernel == nullptr) return -2;
  if (B == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Cp = pow2_at_least(C);
  const int threads = max(Cp, 32);
  const size_t smem = 3 * static_cast<size_t>(Cp) * key_bytes(K) +
                      32 * sizeof(int);
  kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      events, row_stride, n_events, carry_in, carry_out, flags, ok, overflow,
      B, E, R, macro_p, W, C, Cp, model, init_state);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch the scan over B histories on `stream`, one block per history of
// max(Cp, 32) threads (Cp: C rounded up to a power of two), with the
// kernel instantiated for K = W / 32 + 1 mask words; `model` is the
// model's KERNEL_MODEL and init_state its initial state. Writes ok and
// overflow per history. Returns 0, a CUDA error code from the launch, or
// a negative code for refused arguments (see sort_scan_error_string).
// Does not synchronise.
extern "C" int sort_scan_launch(const int32_t* events, const int32_t* n_events,
                                uint8_t* ok, uint8_t* overflow, int B, int E,
                                int R, int macro_p, int W, int C, int model,
                                int init_state, int device, void* stream) {
  return launch(events, static_cast<long long>(E) * R, n_events, nullptr,
                nullptr, nullptr, ok, overflow, B, E, R, macro_p, W, C, model,
                init_state, device, stream);
}

// Launch one chunk over B histories on `stream`: history h's frontier,
// slot registers and scalars from row h of carry_in (carry_len ints,
// SortCarry's layout), its event rows from events + h * row_stride
// (width rows of R ints; a slice of a longer batch), the state after
// them to row h of carry_out and its four flags to flags[k * B + h].
// Returns as sort_scan_launch; -7 when carry_len is not the layout's
// length. Does not synchronise.
extern "C" int sort_scan_chunk_launch(const int32_t* events,
                                      const int32_t* carry_in,
                                      int32_t* carry_out, uint8_t* flags,
                                      long long row_stride, int B, int width,
                                      int R, int macro_p, int W, int C,
                                      int model, int carry_len, int device,
                                      void* stream) {
  if (W >= 1 && W <= kSortMaxSlots && C >= 1 &&
      carry_len != SortCarry{W, C, W / 32 + 1}.len())
    return -7;
  return launch(events, row_stride, nullptr, carry_in, carry_out, flags,
                nullptr, nullptr, B, width, R, macro_p, W, C, model, 0, device,
                stream);
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
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
