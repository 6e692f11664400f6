// Dense-domain linearizability scan for Hopper (sm_90a).
//
// Replaces the TPU kernel jepsen_jgroups_raft_tpu/ops/pallas_scan.py
// `_build_kernel` (the one `pl.pallas_call`, pallas_scan.py:291) and
// computes the same function as its XLA twin ops/dense_scan.py
// `dense_step_parts`: for each history, scan the packed event stream
// over a dense frontier F[2^W, S] (bit s of F[m] = "some linearization
// of exactly the ops in window mask m ends in state id s") and report
// whether every FORCE left a survivor.
//
// Design. One thread block per history; the TPU's sequential grid
// becomes a loop over the history's event rows inside the block. The
// block keeps its whole state in shared memory:
//   F[1 << W]  uint16  the frontier, one S-bit word per mask (2 KiB at
//                      the W = 10 cap; S <= 16 states fit a word)
//   T[W][S]    uint16  per slot, per source state: the S-bit set of
//                      next states, rebuilt when the slot latches an op
//   vals[S]    int32   the history's id -> value table
// Per row: OPEN payloads rebuild T rows (one thread per (payload,
// state)); a FORCE after an OPEN runs the closure to fixpoint, each
// pass over an open slot w handing the threads the 2^(W-1) masks m
// without bit w (F[m | bit] |= OR of T[w][s] over s in F[m]: reads and
// writes touch disjoint halves, so no atomics), `__syncthreads_or`
// carrying the change flag; then the FORCE kills configurations
// without bit w and shifts the bit-w half down. The block stops at the
// history's real length or as soon as `ok` is false (a dead frontier
// stays dead). None of the TPU layout workarounds carry over: no lane
// rows, no identity-mask column moves, no block-diagonal matmuls.
//
// What bounds it on this card: serial depth, not bytes or operations.
// A north-star history is ~1000 macro rows, each FORCE with up to
// W + 1 closure sweeps of W barrier-separated passes, so a block walks
// thousands of dependent, barrier-bound steps while moving a few
// hundred KB. The design answers with parallelism across histories
// (one small block each, hundreds resident per GPU at 32-256 threads
// and ~2.4 KB of shared memory) and by keeping every step in shared
// memory and registers; the frontier never leaves the SM. Bits, not
// matmuls: at S <= 16 a tensor-core product has nothing to chew on.
//
// Integers: NIL = -2^31 only ever meets `==`; nothing negates or
// subtracts a value.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxSlots = 10;   // DENSE_MAX_SLOTS
constexpr int kMaxStates = 16;  // DENSE_MAX_STATES
constexpr int kMaxCells = 8192; // DENSE_MAX_CELLS = 2^W * S
constexpr int kMaxOpens = 16;   // MACRO_MAX_OPENS

constexpr int32_t kEvOpen = 1;
constexpr int32_t kEvForce = 2;

// Model switch: one case per model family with a device step. Ids match
// the Python models' KERNEL_MODEL.
constexpr int kModelCasRegister = 0;

// CAS register opcodes (models/register.py).
constexpr int32_t kWrite = 1;
constexpr int32_t kCas = 2;

// Device twin of the models' torch_step: (state, op) -> (state', legal).
__device__ __forceinline__ void model_step(int model, int32_t state,
                                           int32_t f, int32_t a, int32_t b,
                                           int32_t* next, bool* legal) {
  switch (model) {
    case kModelCasRegister:
    default: {
      const bool is_write = f == kWrite;
      const bool match = state == a;
      *legal = is_write || match;  // read/cas legal iff observed matches
      *next = is_write ? a : ((f == kCas && match) ? b : state);
    }
  }
}

// Mask number i of the 2^(W-1) masks without bit w: insert a 0 at w.
__device__ __forceinline__ int mask_without(int i, int w) {
  const int low = i & ((1 << w) - 1);
  return ((i >> w) << (w + 1)) | low;
}

__global__ void dense_scan_kernel(const int32_t* __restrict__ events,
                                  const int32_t* __restrict__ val_of,
                                  const int32_t* __restrict__ n_events,
                                  uint8_t* __restrict__ ok_out, int E, int R,
                                  int macro_p, int W, int S, int model) {
  __shared__ uint16_t F[1 << kMaxSlots];
  __shared__ uint16_t T[kMaxSlots][kMaxStates];
  __shared__ int32_t vals[kMaxStates];

  const int h = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int M = 1 << W;
  const int half = M >> 1;
  const int32_t* ev = events + static_cast<size_t>(h) * E * R;
  const int n_rows = min(max(n_events[h], 0), E);

  for (int m = tid; m < M; m += nt) F[m] = (m == 0) ? 1 : 0;
  if (tid < S) vals[tid] = val_of[static_cast<size_t>(h) * S + tid];
  __syncthreads();

  // Transition row of slot w for source state s under op (f, a, b):
  // every state id s' whose value is the step's result (duplicates in
  // the padded table all light up), or nothing when illegal.
  auto build_row = [&](int w, int s, int32_t f, int32_t a, int32_t b) {
    int32_t next;
    bool legal;
    model_step(model, vals[s], f, a, b, &next, &legal);
    unsigned bits = 0;
    if (legal) {
      for (int s2 = 0; s2 < S; ++s2) bits |= (vals[s2] == next) ? 1u << s2 : 0u;
    }
    T[w][s] = static_cast<uint16_t>(bits);
  };

  // Every thread keeps the same copies of the per-history scalars: they
  // follow from the row data and from barrier results alone.
  unsigned slot_open = 0;
  bool dirty = false;
  bool ok = true;

  for (int e = 0; e < n_rows && ok; ++e) {
    const int32_t* row = ev + static_cast<size_t>(e) * R;
    const int32_t kind = __ldg(row);
    const int32_t fslot = __ldg(row + 1);

    // ---- latch
    bool latched = false;
    if (macro_p == 0) {
      if (kind == kEvOpen) {
        dirty = true;
        if (fslot >= 0 && fslot < W) {
          if (tid < S) build_row(fslot, tid, __ldg(row + 2), __ldg(row + 3),
                                 __ldg(row + 4));
          slot_open |= 1u << fslot;
          latched = true;
        }
      }
    } else {
      const int n = min(max(__ldg(row + 2), 0), macro_p);
      dirty = dirty || n > 0;
      for (int j = 0; j < n; ++j) {
        const int32_t ps = __ldg(row + 3 + 4 * j);
        if (ps >= 0 && ps < W) slot_open |= 1u << ps;
      }
      for (int i = tid; i < n * S; i += nt) {
        const int j = i / S;
        const int32_t* pay = row + 3 + 4 * j;
        const int32_t ps = __ldg(pay);
        if (ps >= 0 && ps < W)
          build_row(ps, i - j * S, __ldg(pay + 1), __ldg(pay + 2),
                    __ldg(pay + 3));
      }
      latched = n > 0;
    }
    if (latched) __syncthreads();
    if (kind != kEvForce) continue;

    // ---- closure to fixpoint (only when an OPEN came since the last
    // FORCE: a closed frontier stays closed under FORCE). At most W + 1
    // sweeps, the reference's loop bound; the fixpoint needs <= W.
    if (dirty) {
      for (int it = 0;; ++it) {
        int changed = 0;
        for (int w = 0; w < W; ++w) {
          if (!((slot_open >> w) & 1u)) continue;  // closed: contributes 0
          const int bit = 1 << w;
          for (int i = tid; i < half; i += nt) {
            const int m = mask_without(i, w);
            unsigned src = F[m];
            unsigned acc = 0;
            while (src) {
              const int s = __ffs(src) - 1;
              src &= src - 1;
              acc |= T[w][s];
            }
            const unsigned dst = F[m | bit];
            if (acc & ~dst) {
              F[m | bit] = static_cast<uint16_t>(dst | acc);
              changed = 1;
            }
          }
          __syncthreads();
        }
        if (!__syncthreads_or(changed) || it >= W) break;
      }
      dirty = false;
    }

    // ---- FORCE slot w: a survivor must hold bit w; recycle the bit.
    const int w = min(max(fslot, 0), W - 1);
    const int bit = 1 << w;
    int local = 0;
    for (int i = tid; i < half; i += nt) local |= F[mask_without(i, w) | bit];
    const bool alive = __syncthreads_or(local) != 0;
    for (int i = tid; i < half; i += nt) {
      const int m = mask_without(i, w);
      F[m] = F[m | bit];
      F[m | bit] = 0;
    }
    __syncthreads();
    ok = ok && alive;
    if (fslot >= 0 && fslot < W) slot_open &= ~(1u << fslot);
  }
  if (tid == 0) ok_out[h] = ok ? 1 : 0;
}

}  // namespace

// Launch the scan over B histories on `stream`; returns 0, a CUDA error
// code from the launch, or a negative code for refused arguments (see
// dense_scan_error_string). Does not synchronise.
extern "C" int dense_scan_launch(const int32_t* events, const int32_t* val_of,
                                 const int32_t* n_events, uint8_t* ok, int B,
                                 int E, int R, int macro_p, int W, int S,
                                 int model, int threads, int device,
                                 void* stream) {
  if (B < 0 || E < 0) return -1;
  if (W < 1 || W > kMaxSlots || S < 1 || S > kMaxStates ||
      (1 << W) * S > kMaxCells)
    return -2;
  if (macro_p < 0 || macro_p > kMaxOpens) return -3;
  if (R != (macro_p ? 3 + 4 * macro_p : 5)) return -4;
  if (model != kModelCasRegister) return -5;
  if (threads < 32 || threads > 1024 || threads % 32 != 0) return -6;
  if (B == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  dense_scan_kernel<<<B, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      events, val_of, n_events, ok, E, R, macro_p, W, S, model);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dense_scan_error_string(int code) {
  switch (code) {
    case -1: return "negative batch or event count";
    case -2: return "(W, S) beyond the dense caps";
    case -3: return "macro_p beyond MACRO_MAX_OPENS";
    case -4: return "row width does not match macro_p";
    case -5: return "model has no device step";
    case -6: return "threads per block not a multiple of 32 in [32, 1024]";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
