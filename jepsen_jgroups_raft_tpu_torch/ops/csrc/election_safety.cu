// Election safety over batches of (term, leader) observations on Hopper
// (sm_90a): a row is unsafe iff two of its observations have the same
// term >= 0 and different leaders.
//
// Replaces the reference's jepsen_jgroups_raft_tpu/models/leader.py
// `check_election_safety_jax` (B9's last kernel, an XLA program: sort by
// (term, leader), then an adjacent compare with `real = ts[1:] >= 0`).
// The verdict is theirs row for row: observations with a negative term
// (the padding (-1, -1) among them) are ignored, and rows at or past a
// row's valid length too.
//
// Design: no sort. Each row gets an open-addressing table of `cap` 64-bit
// slots (cap = the power of two >= 2N, so the load is at most 1/2), all
// EMPTY (all ones: term -1, which is never inserted) at the start. Each
// observation packs key = term << 32 | leader, hashes the term
// (Fibonacci hashing, linear probing) and walks the probe sequence:
//   - a slot holding another term: go on;
//   - a slot holding this term: a different key there means two leaders
//     in one term, and the row is unsafe;
//   - an EMPTY slot: atomicCAS(EMPTY -> key); on failure the slot now
//     holds another thread's key, which is judged as above.
// Exact under any interleaving: slots only ever go from EMPTY to a key,
// and every insert of one term walks the same probe sequence, so all of
// them stop at the first slot of that sequence that no other term holds
// (whoever fills it first), and each one that loses sees the winner's
// leader. A plain load first saves the atomic on slots already filled; a
// stale EMPTY only sends the thread to the CAS.
//
// Two forms, chosen by N alone (ops/election_safety.py `election_form`):
//   - shared (cap <= 2^kMaxSharedLog2, N <= 8192): one CTA per row, the
//     table in dynamic shared memory (64 KB at N = 4096), set to EMPTY by
//     the CTA itself; inserts are shared-memory 64-bit CAS, the verdict a
//     block-wide OR, one byte written per row. No global table, no
//     memset: the kernel moves what the bound counts.
//   - global (larger rows, up to 2^26 observations): the table of each
//     row in global scratch (1 MB at N = 65536), set to EMPTY by a
//     cudaMemsetAsync before the launch, one thread per observation with
//     L2 atomics — a row's table outgrows an SM's shared memory.
//
// Bound: the observations read once (8 B N per row) and one byte written
// per row, at 3.35 TB/s. No PyTorch headers; a plain C entry point bound
// with ctypes (ops/_build.py).

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>
#include <mutex>

namespace {

constexpr unsigned long long kEmpty = ~0ull;
constexpr int kThreads = 256;       // the global form's block
constexpr int kSharedThreads = 512; // SHARED_MAX_THREADS, the largest block
// cap = 2^log2cap slots a row; 2N <= cap <= 2^27
constexpr int kMaxLog2Cap = 27;
// the shared form's largest table: 2^14 slots, 128 KB
constexpr int kMaxSharedLog2 = 14;  // SHARED_MAX_LOG2
constexpr int kMaxDevices = 64;

enum : int { kFormShared = 0, kFormGlobal = 1 };

// Insert one observation into a row's table `t` (mask = cap - 1); false
// when the row is unsafe (its term holds another leader).
__device__ __forceinline__ bool insert(unsigned long long* t, uint32_t mask,
                                       int log2cap, int2 o) {
  const uint32_t term = static_cast<uint32_t>(o.x);
  const unsigned long long key =
      (static_cast<unsigned long long>(term) << 32) |
      static_cast<uint32_t>(o.y);
  uint32_t h = (term * 2654435769u) >> (32 - log2cap);
  for (;;) {
    unsigned long long cur = *reinterpret_cast<volatile unsigned long long*>(
        t + h);
    if (cur == kEmpty) {
      cur = atomicCAS(t + h, kEmpty, key);
      if (cur == kEmpty) return true;  // this term's first slot: ours
    }
    if (static_cast<uint32_t>(cur >> 32) == term) return cur == key;
    h = (h + 1u) & mask;
  }
}

__global__ void __launch_bounds__(kSharedThreads)
election_shared(const int2* __restrict__ obs,
                const int32_t* __restrict__ valid_len,
                uint8_t* __restrict__ safe, int N, int log2cap) {
  extern __shared__ ulonglong2 table2[];
  unsigned long long* t = reinterpret_cast<unsigned long long*>(table2);
  const int b = blockIdx.x;
  const int cap = 1 << log2cap;
  for (int i = threadIdx.x; i < cap / 2; i += blockDim.x)
    table2[i] = make_ulonglong2(kEmpty, kEmpty);
  const int n = valid_len != nullptr ? min(max(valid_len[b], 0), N) : N;
  const int2* row = obs + static_cast<size_t>(b) * N;
  __syncthreads();
  bool ok = true;
  for (int i = threadIdx.x; ok && i < n; i += blockDim.x) {
    const int2 o = __ldg(row + i);
    if (o.x >= 0)  // negative terms (and padding) are ignored
      ok = insert(t, static_cast<uint32_t>(cap - 1), log2cap, o);
  }
  const bool unsafe = __syncthreads_or(!ok);
  if (threadIdx.x == 0) safe[b] = unsafe ? 0 : 1;
}

__global__ void __launch_bounds__(kThreads)
election_global(const int2* __restrict__ obs,
                const int32_t* __restrict__ valid_len,
                unsigned long long* __restrict__ table,
                uint8_t* __restrict__ safe, long long total, int N,
                int log2cap) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= total) return;
  const long long b = idx / N;
  const int i = static_cast<int>(idx - b * N);
  if (valid_len != nullptr && i >= valid_len[b]) return;
  const int2 o = obs[idx];
  if (o.x < 0) return;  // negative terms (and padding) are ignored
  if (!insert(table + (b << log2cap), (1u << log2cap) - 1u, log2cap, o))
    safe[b] = 0;  // one term, two leaders
}

// The shared form's threads for rows of N: a warp at least, one thread
// an observation up to kSharedThreads.
int shared_threads(int N) {
  int t = 32;
  while (t < N && t < kSharedThreads) t *= 2;
  return t;
}

}  // namespace

// Check B rows of N observations: obs [B, N, 2] int32 (term, leader),
// valid_len [B] int32 or null, safe [B] bytes out (1 safe, 0 not), in
// `form` 0 (shared: one CTA a row, the table in shared memory, 2N <=
// 2^log2cap <= 2^14, `table` unused) or 1 (global: `table` scratch of B
// << log2cap 64-bit slots, set to EMPTY here). Returns 0, a CUDA error
// code, or a negative code for refused arguments (see
// election_safety_error_string). Does not synchronise.
extern "C" int election_safety_launch(const int32_t* obs,
                                      const int32_t* valid_len,
                                      void* table, uint8_t* safe, int B,
                                      int N, int log2cap, int form,
                                      int device, void* stream) {
  if (B < 0) return -1;
  if (N < 1) return -2;
  if (log2cap < 1 || log2cap > kMaxLog2Cap ||
      (2ll * N) > (1ll << log2cap))
    return -3;
  if (form == kFormShared && log2cap > kMaxSharedLog2) return -5;
  if (form != kFormShared && form != kFormGlobal) return -6;
  if (form == kFormGlobal && table == nullptr) return -7;
  if (B == 0) return 0;
  if (device < 0 || device >= kMaxDevices) return -8;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (form == kFormShared) {
    // above 48 KB a block's dynamic shared memory must be opted in; under
    // a lock the device's limit only rises, so no thread lowers it below
    // a size another has just opted in to and is launching
    const int bytes = static_cast<int>(sizeof(unsigned long long)) << log2cap;
    {
      static std::mutex mu;
      static int opted[kMaxDevices] = {};
      const std::lock_guard<std::mutex> hold(mu);
      if (bytes > opted[device]) {
        err = cudaFuncSetAttribute(
            election_shared, cudaFuncAttributeMaxDynamicSharedMemorySize,
            bytes);
        if (err != cudaSuccess) return static_cast<int>(err);
        opted[device] = bytes;
      }
    }
    election_shared<<<B, shared_threads(N), bytes, s>>>(
        reinterpret_cast<const int2*>(obs), valid_len, safe, N, log2cap);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t slots = static_cast<size_t>(B) << log2cap;
  err = cudaMemsetAsync(table, 0xFF, slots * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(safe, 1, static_cast<size_t>(B), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(B) * N;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFll) return -4;
  election_global<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      reinterpret_cast<const int2*>(obs), valid_len,
      static_cast<unsigned long long*>(table), safe, total, N, log2cap);
  return static_cast<int>(cudaGetLastError());
}

// The shared form's threads a block for rows of N observations (the
// launcher's `shared_threads`); -2 for N < 1.
extern "C" int election_safety_shared_threads(int N) {
  return N < 1 ? -2 : shared_threads(N);
}

extern "C" const char* election_safety_error_string(int code) {
  switch (code) {
    case -1: return "negative batch";
    case -2: return "N must be at least 1";
    case -3: return "table of 2^log2cap slots must hold 2N, log2cap <= 27";
    case -4: return "more observations than one launch's grid";
    case -5: return "the shared form's table holds at most 2^14 slots";
    case -6: return "form must be 0 (shared) or 1 (global)";
    case -7: return "the global form needs its table scratch";
    case -8: return "device index beyond 64";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
