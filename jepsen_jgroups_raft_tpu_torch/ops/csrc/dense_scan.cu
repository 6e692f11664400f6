// Dense-domain linearizability scan for Hopper (sm_90a): one warp per
// history, the frontier in registers.
//
// Replaces the TPU kernel jepsen_jgroups_raft_tpu/ops/pallas_scan.py
// `_build_kernel` (pallas_scan.py:102, the one `pl.pallas_call` at
// pallas_scan.py:291) and computes the same function as its XLA twin
// ops/dense_scan.py `dense_step_parts`: for each history, scan the
// packed event stream over a dense frontier F[2^W, S] (bit s of F[m] =
// "some linearization of exactly the ops in window mask m ends in state
// id s") and report whether every FORCE left a survivor.
//
// What bounds it on this card: serial depth. A north-star history is
// ~775 macro rows, ~1275 closure sweeps and ~7100 slot passes in the
// reference's schedule, each step depending on the one before; the data
// it moves (a few hundred KB per history) and the bit operations it does
// take a small fraction of the time the chain takes. So the design
// shortens every link of the chain and runs as many chains side by side
// as the batch holds:
//
// * One warp per history, four histories per block. The event loop has
//   no block barrier: every branch in it is warp-uniform (all 32 lanes
//   read the same row), the closure's change flag and the FORCE's
//   `alive` come from `__any_sync`, and a warp whose history ended or
//   whose frontier died exits on its own. Nothing in a block is shared
//   between warps, so no warp waits on, or reads memory of, another. A
//   1000-history batch is ~250 blocks: resident on the 132 SMs at once.
//
// * The frontier lives in registers. S is padded to a field of FS = 2^LF
//   bits (FS >= S; states >= S are never set), so frontier bit
//   b = m * FS + s spans 2^(W+LF) <= 8192 bits, at most 8 words a lane:
//     b[0..4]    bit in a 32-bit word  (a field of FS bits per mask)
//     b[5..9]    lane
//     b[10..12]  word index in the lane's register array
//   Mask bit w sits at b[LF + w]. A closure pass or FORCE over slot w is
//   therefore, fixed at compile time for each (W, LF, w): a shift and
//   mask inside each word (in-word field bits), a `__shfl_xor_sync`
//   between lanes (lane bits), or a move between registers (word bits).
//   The kernel is a template on (W, LF), dispatched once at launch, so
//   every register array is indexed by constants (ptxas -v: no stack
//   frame, no spills). Small frontiers leave lanes or words empty: below
//   1024 bits only lanes [0, 2^(W+LF-5)) hold bits (one word each), below
//   32 bits only the low 2^(W+LF) bits of lane 0's word. The empty lanes
//   run the same code on zero words; every lane pass pairs lanes inside
//   the occupied range, and every transform maps a zero field to zero,
//   so they stay zero and all 32 lanes stay converged for the shuffles.
//
// * A transition is applied without a per-bit loop. The rows T[w][s]
//   (the S-bit set of next states of state s under slot w's op) are
//   rebuilt at OPEN, one (payload, state) pair per lane, and kept per
//   warp in shared memory, read as broadcasts (a copy in registers
//   measured no faster). The lookup from a source field to the OR of its
//   rows is bit-plane arithmetic on a whole word: ((x >> s) & unit) *
//   T[w][s] puts T[w][s] into every field whose bit s is set (fields are
//   FS bits apart and T < 2^FS, so the products never overlap), and the
//   OR over the FS planes maps all 32 / FS fields of the word at once:
//   4 * FS integer operations per word, no table, no branch on the data.
//
// * A closure sweep has no dependent chain across slots. Each sweep ORs
//   in every open slot's image of the frontier it starts from, all W
//   images computed from the same words, so their instructions are
//   independent and issue back to back; a closed slot's image is masked
//   to zero rather than branched around. One `__any_sync` per sweep
//   decides whether another is needed.
//
// * Rows are staged ahead. Each warp owns a ring of kRingDepth rows in
//   shared memory, filled with `cp.async` (lane i copies int i of a
//   row): the copy of row e + kRingDepth - 1 is in flight while row e is
//   processed, so a row's first read waits on device memory only at the
//   start of the stream.
//
// * Window groups overlap: checker/schedule.run_dense_groups launches
//   each group on its own stream, so the check's kernel span approaches
//   the slowest group rather than the sum.
//
// * The chunk form (the reference's `make_dense_chunk_checker`,
//   ops/dense_scan.py:755, under its chunked wavefront) is a second
//   entry point of the same kernel body: the warp reads its carry
//   (frontier words, transition rows, open slots, dirty, ok, left) at
//   the start, scans at most `left` rows of a column slice of the batch,
//   and writes the carry and four flags at the end. What it adds is the
//   carry's bytes, read and written once a launch (F <= 1 KB, T <= 640 B
//   a history), against the rows the launch scans.
//
// Same function as the reference, bit for bit. The reference sweeps the
// slots in order, each pass seeing the passes before it; here a sweep
// applies every slot to the same frontier. Both stop at the least
// fixpoint, within the reference's bound of W + 1 sweeps
// (ops/kernel_ir.py:169-187): every productive sweep, in either order,
// extends every pending chain of transitions by at least one op, and a
// chain holds at most W ops (each sets a distinct mask bit), so W sweeps
// reach the fixpoint and the next only confirms it; the verdict depends
// only on the fixpoint. A closure runs where the reference's does, at a
// FORCE after any OPEN since the last one. Slots are clipped to [0, W)
// at FORCE; padding rows are no-ops; duplicate ids in a padded val_of
// all light up; payloads that land in one slot in one macro row OR their
// rows (the plain version's `any` over payloads); the scan stops at
// n_events or at the first dead FORCE (a dead frontier stays dead).
//
// Integers: NIL = -2^31 only ever meets `==`; nothing negates or
// subtracts a value.
//
// The frontier layout, the FORCE and the row ring are shared with the
// mask-mode scan (warp_frontier.cuh); the transition rows, slot images
// and closure with the segmented scan (dense_frontier.cuh); the model
// steps live in models.cuh. The register and the set (a set history with at most 4
// distinct adds, `GSet.dense_domain`) have dense domains; the launcher
// refuses every other model. The model is a runtime switch
// (`model_step`), so the set adds no instance.

#include <cstdint>
#include <cuda_runtime.h>

#include "dense_frontier.cuh"
#include "models.cuh"
#include "verdict_counts.cuh"
#include "warp_frontier.cuh"

namespace {

// The chunk carry of one history (ops/dense_scan.py dense_carry_layout):
// int32 fields ok, overflow, dirty, left (kCarryHead), open[W] (0/1),
// val_of[S], T[W][FS] (the transition rows as the kernel keeps them in
// shared memory) and the frontier's words F[kWords of the layout, lane
// order] (word 32 j + l is lane l's register word j: bits [32 g, 32 g +
// 32) of b = m * FS + s, as segment_scan.cu writes its frontiers).
template <int W, int LF>
struct DenseCarry {
  static constexpr int kFS = Layout<W, LF>::kFS;
  static constexpr int kNW = (1 << (W + LF)) > 32 ? (1 << (W + LF)) / 32 : 1;
  static constexpr int kOpen = kCarryHead;
  static constexpr int kVal = kOpen + W;
  __host__ __device__ static constexpr int t(int S) { return kVal + S; }
  __host__ __device__ static constexpr int f(int S) { return t(S) + W * kFS; }
  __host__ __device__ static constexpr int len(int S) { return f(S) + kNW; }
};

// One kernel body, two entry points. One-shot (dense_scan_launch):
// carry_in, carry_out and flags are null; the scan starts fresh, reads
// n_events[h] rows of each history's E and writes ok_out. Chunk
// (dense_scan_chunk_launch): the state starts from carry_in, the scan
// reads min(left, E) rows of the slice (E is the slice's width, `left`
// the history's real rows not yet scanned), then writes carry_out with
// left - E and flags [4][B]: decided (= !ok), exhausted (left - E <= 0),
// ok, overflow (always 0 here). A row whose frontier died stops there;
// its carry keeps ok = 0 and the empty frontier (the slot state it
// holds is then not the reference's, and nothing reads it again).
// kCount (one-shot only) also counts the row's verdict into counts[2]
// in dense mode, real[h] (null: every row real) masking padding rows
// out (verdict_counts.cuh); the instances without it are the same code
// as before the counts existed.
template <int W, int LF, bool kCount>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 1)
    dense_scan_warp(const int32_t* __restrict__ events, long long row_stride,
                    const int32_t* __restrict__ val_of,
                    const int32_t* __restrict__ n_events,
                    const int32_t* __restrict__ carry_in,
                    int32_t* __restrict__ carry_out,
                    uint8_t* __restrict__ flags,
                    uint8_t* __restrict__ ok_out, int B, int E, int R,
                    int macro_p, int S, int model,
                    const uint8_t* __restrict__ real,
                    unsigned long long* __restrict__ counts) {
  using Carry = DenseCarry<W, LF>;
  constexpr int kFS = Layout<W, LF>::kFS;
  constexpr int kWords = Layout<W, LF>::kWords;
  __shared__ int32_t ring_all[kWarpsPerBlock][kRingDepth][kRowPitch];
  __shared__ uint32_t T_all[kWarpsPerBlock][W][kFS];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int h = blockIdx.x * kWarpsPerBlock + warp;
  if constexpr (kCount) count_open();  // before any warp exits
  if (h >= B) return;  // warp-uniform; no other warp waits on this one
  int32_t (*ring)[kRowPitch] = ring_all[warp];
  uint32_t (*T)[kFS] = T_all[warp];
  const int32_t* cin =
      carry_in ? carry_in + static_cast<size_t>(h) * Carry::len(S) : nullptr;
  const int32_t* ev = events + static_cast<size_t>(h) * row_stride;
  const int left = cin ? cin[kCarryLeft] : n_events[h];
  bool ok = cin ? cin[kCarryOk] != 0 : true;
  const int n_rows = ok ? min(max(left, 0), E) : 0;
#pragma unroll
  for (int e = 0; e < kRingDepth - 1; ++e)
    stage_row(ring, ev, e, n_rows, R, lane);

  const int32_t* vsrc = cin ? cin + Carry::kVal
                            : val_of + static_cast<size_t>(h) * S;
  int32_t vals[kFS];
#pragma unroll
  for (int s = 0; s < kFS; ++s) vals[s] = s < S ? __ldg(vsrc + s) : 0;
  uint32_t F[kWords];
  unsigned open = 0;   // slots holding a latched op
  bool dirty = false;  // an OPEN since the last FORCE: a closure is due
  if (cin) {
    for (int i = lane; i < W * kFS; i += 32)
      (&T[0][0])[i] = static_cast<uint32_t>(cin[Carry::t(S) + i]);
#pragma unroll
    for (int j = 0; j < kWords; ++j)
      F[j] = 32 * j + lane < Carry::kNW
                 ? static_cast<uint32_t>(cin[Carry::f(S) + 32 * j + lane])
                 : 0u;
    open = __ballot_sync(kFull, lane < W && cin[Carry::kOpen + lane] != 0);
    dirty = cin[kCarryDirty] != 0;
  } else {
    for (int i = lane; i < W * kFS; i += 32) (&T[0][0])[i] = 0u;
#pragma unroll
    for (int j = 0; j < kWords; ++j) F[j] = 0u;
    if (lane == 0) F[0] = 1u;  // mask 0, state id 0
  }
  __syncwarp();

  const int base = macro_p ? 3 : 1;  // first payload (slot, f, a, b)
  for (int e = 0; e < n_rows; ++e) {
    stage_row(ring, ev, e + kRingDepth - 1, n_rows, R, lane);
    cp_async_wait<kRingDepth - 1>();  // this lane's copies of row e landed
    __syncwarp();                     // ... and every other lane's
    const int32_t* row = ring[e % kRingDepth];
    const int32_t kind = row[0];
    const int32_t fslot = row[1];
    const int n = macro_p ? min(max(row[2], 0), macro_p) : (kind == kEvOpen);

    // ---- latch: lane j reads payload j's slot. One (payload, state)
    // per lane writes the updated slots' T rows; payloads that share a
    // slot (never from the packer, but legal input) OR theirs into it.
    if (n > 0) {
      dirty = true;
      const int ps = lane < n ? row[base + 4 * lane] : -1;
      const bool valid = ps >= 0 && ps < W;
      const unsigned upd = __reduce_or_sync(kFull, valid ? 1u << ps : 0u);
      if (upd) {
        open |= upd;
        const bool overlap =
            __popc(upd) != __popc(__ballot_sync(kFull, valid));
        const int tasks = n << LF;
        if (overlap) {
          for (int i = lane; i < tasks; i += 32) {
            const int q = row[base + 4 * (i >> LF)];
            if (q >= 0 && q < W) T[q][i & (kFS - 1)] = 0u;
          }
          __syncwarp();
        }
        for (int i = lane; i < tasks; i += 32) {
          const int32_t* pay = row + base + 4 * (i >> LF);
          const int q = pay[0];
          if (q < 0 || q >= W) continue;
          const uint32_t bits = transition_row<LF>(
              vals, S, i & (kFS - 1), pay[1], pay[2], pay[3], model);
          if (overlap)
            atomicOr(&T[q][i & (kFS - 1)], bits);
          else
            T[q][i & (kFS - 1)] = bits;
        }
        __syncwarp();
      }
    }

    if (kind == kEvForce) {
      // ---- closure to fixpoint, only when an OPEN came since the last
      // FORCE (the reference's rule)
      if (dirty) {
        closure<W, LF>(F, T, open, lane);
        dirty = false;
      }
      // ---- FORCE: survivors hold the slot's bit; recycle the bit
      ok = force<W, LF>(F, min(max(fslot, 0), W - 1), lane);
      if (fslot >= 0 && fslot < W) open &= ~(1u << fslot);
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
    int32_t* cout = carry_out + static_cast<size_t>(h) * Carry::len(S);
    for (int i = lane; i < W * kFS; i += 32)
      cout[Carry::t(S) + i] = static_cast<int32_t>((&T[0][0])[i]);
    for (int i = lane; i < S; i += 32) cout[Carry::kVal + i] = vsrc[i];
#pragma unroll
    for (int j = 0; j < kWords; ++j)
      if (32 * j + lane < Carry::kNW)
        cout[Carry::f(S) + 32 * j + lane] = static_cast<int32_t>(F[j]);
    if (lane < W) cout[Carry::kOpen + lane] = (open >> lane) & 1u;
    if (lane == 0)
      write_head(cout, flags, h, B, ok, false, dirty, left - E);
  }
}

using KernelFn = void (*)(const int32_t*, long long, const int32_t*,
                          const int32_t*, const int32_t*, int32_t*, uint8_t*,
                          uint8_t*, int, int, int, int, int, int,
                          const uint8_t*, unsigned long long*);

template <int W, bool kCount>
KernelFn pick_field(int lf) {
  switch (lf) {
    case 0: return dense_scan_warp<W, 0, kCount>;
    case 1: return dense_scan_warp<W, 1, kCount>;
    case 2: return dense_scan_warp<W, 2, kCount>;
    case 3: return dense_scan_warp<W, 3, kCount>;
    case 4:
      if constexpr (W + 4 <= 13) return dense_scan_warp<W, 4, kCount>;
      return nullptr;
    default: return nullptr;
  }
}

template <bool kCount>
KernelFn pick_window(int W, int lf) {
  switch (W) {
    case 1: return pick_field<1, kCount>(lf);
    case 2: return pick_field<2, kCount>(lf);
    case 3: return pick_field<3, kCount>(lf);
    case 4: return pick_field<4, kCount>(lf);
    case 5: return pick_field<5, kCount>(lf);
    case 6: return pick_field<6, kCount>(lf);
    case 7: return pick_field<7, kCount>(lf);
    case 8: return pick_field<8, kCount>(lf);
    case 9: return pick_field<9, kCount>(lf);
    case 10: return pick_field<10, kCount>(lf);
    default: return nullptr;
  }
}

// Which instances a build holds: the counting ones in the library built
// with -DDENSE_SCAN_COUNT (dense_scan_count: the one-shot entry only),
// the others in dense_scan (with the chunk entry). Two libraries keep
// each nvcc to the instances it had before the counts existed, and the
// two build side by side.
#ifdef DENSE_SCAN_COUNT
constexpr bool kCountBuild = true;
#else
constexpr bool kCountBuild = false;
#endif

KernelFn pick(int W, int lf) { return pick_window<kCountBuild>(W, lf); }

template <int W>
int carry_len_field(int lf, int S) {
  switch (lf) {
    case 0: return DenseCarry<W, 0>::len(S);
    case 1: return DenseCarry<W, 1>::len(S);
    case 2: return DenseCarry<W, 2>::len(S);
    case 3: return DenseCarry<W, 3>::len(S);
    default: return DenseCarry<W, 4>::len(S);
  }
}

int carry_len(int W, int lf, int S) {
  switch (W) {
    case 1: return carry_len_field<1>(lf, S);
    case 2: return carry_len_field<2>(lf, S);
    case 3: return carry_len_field<3>(lf, S);
    case 4: return carry_len_field<4>(lf, S);
    case 5: return carry_len_field<5>(lf, S);
    case 6: return carry_len_field<6>(lf, S);
    case 7: return carry_len_field<7>(lf, S);
    case 8: return carry_len_field<8>(lf, S);
    case 9: return carry_len_field<9>(lf, S);
    default: return carry_len_field<10>(lf, S);
  }
}

// The argument checks both entry points share: 0, or a negative code.
int check_args(int B, int E, int R, int macro_p, int W, int S,
               int field_log2, int model) {
  if (B < 0 || E < 0) return -1;
  if (W < 1 || W > kMaxSlots || S < 1 || S > kMaxStates ||
      (1 << W) * S > kMaxCells)
    return -2;
  if (macro_p < 0 || macro_p > kMaxOpens) return -3;
  if (R != (macro_p ? 3 + 4 * macro_p : 5)) return -4;
  if (model != kModelCasRegister && model != kModelSet) return -5;
  if (field_log2 < 0 || field_log2 > 4 || (1 << field_log2) < S ||
      (field_log2 > 0 && (1 << (field_log2 - 1)) >= S))
    return -6;
  if (pick(W, field_log2) == nullptr) return -6;
  return 0;
}

int launch(const int32_t* events, long long row_stride,
           const int32_t* val_of, const int32_t* n_events,
           const int32_t* carry_in, int32_t* carry_out, uint8_t* flags,
           uint8_t* ok, const uint8_t* real, long long* counts, int B, int E,
           int R, int macro_p, int W, int S, int field_log2, int model,
           int device, void* stream) {
  if ((counts != nullptr) != kCountBuild) return -8;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (counts != nullptr) {  // the blocks add into zeroed counters
    err = cudaMemsetAsync(counts, 0, 2 * sizeof(long long), s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (B == 0) return 0;
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const KernelFn kernel = pick(W, field_log2);
  kernel<<<blocks, kWarpsPerBlock * 32, 0, s>>>(
      events, row_stride, val_of, n_events, carry_in, carry_out, flags, ok,
      B, E, R, macro_p, S, model, real,
      reinterpret_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch the scan over B histories on `stream`, one warp per history and
// kWarpsPerBlock histories per block, with the kernel instantiated for
// (W, field_log2); field_log2 is the layout's LF (ops/dense_scan.py
// `dense_layout`). With counts (int64 [2], else null; only in
// dense_scan_count, and there always) the kernel's epilogue also counts
// the verdicts in dense mode, real [B] (null: every row) masking rows
// out; counts is zeroed on `stream` first. Returns 0,
// a CUDA error code from the launch, or a negative code for refused
// arguments (see dense_scan_error_string). Does not synchronise.
extern "C" int dense_scan_launch(const int32_t* events, const int32_t* val_of,
                                 const int32_t* n_events, uint8_t* ok,
                                 const uint8_t* real, long long* counts,
                                 int B, int E, int R, int macro_p, int W,
                                 int S, int field_log2, int model, int device,
                                 void* stream) {
  const int rc = check_args(B, E, R, macro_p, W, S, field_log2, model);
  if (rc != 0) return rc;
  return launch(events, static_cast<long long>(E) * R, val_of, n_events,
                nullptr, nullptr, nullptr, ok, real, counts, B, E, R, macro_p,
                W, S, field_log2, model, device, stream);
}

#ifndef DENSE_SCAN_COUNT
// Launch one chunk over B histories on `stream`: the state of history h
// from row h of carry_in (carry_len ints, DenseCarry's layout), its
// event rows from events + h * row_stride (width rows of R ints; a slice
// of a longer batch), the state after them to row h of carry_out and
// its four flags to flags[k * B + h]. Returns as dense_scan_launch; -7
// when carry_len is not the layout's length. Does not synchronise.
extern "C" int dense_scan_chunk_launch(const int32_t* events,
                                       const int32_t* carry_in,
                                       int32_t* carry_out, uint8_t* flags,
                                       long long row_stride, int B, int width,
                                       int R, int macro_p, int W, int S,
                                       int field_log2, int model,
                                       int carry_len_, int device,
                                       void* stream) {
  const int rc = check_args(B, width, R, macro_p, W, S, field_log2, model);
  if (rc != 0) return rc;
  if (carry_len_ != carry_len(W, field_log2, S)) return -7;
  if (B == 0) return 0;
  return launch(events, row_stride, nullptr, nullptr, carry_in, carry_out,
                flags, nullptr, nullptr, nullptr, B, width, R, macro_p, W, S,
                field_log2, model, device, stream);
}
#endif

extern "C" const char* dense_scan_error_string(int code) {
  switch (code) {
    case -1: return "negative batch or event count";
    case -2: return "(W, S) beyond the dense caps";
    case -3: return "macro_p beyond MACRO_MAX_OPENS";
    case -4: return "row width does not match macro_p";
    case -5: return "model has no dense domain (the register and the set have)";
    case -6: return "field_log2 is not the layout's field width for S";
    case -7: return "carry length does not match the carry layout";
    case -8: return "counts asked of dense_scan, or not of dense_scan_count";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
