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
// Design: no sort. Each row owns an open-addressing table of `cap` 64-bit
// slots in global memory (cap = the power of two >= 2N, so the load is at
// most 1/2), set to EMPTY (all ones: term -1, which is never inserted) by
// one cudaMemsetAsync before the launch. One thread per observation
// packs key = term << 32 | leader, hashes the term (Fibonacci hashing,
// linear probing) and walks the probe sequence:
//   - a slot holding another term: go on;
//   - a slot holding this term: a different key there means two leaders
//     in one term, and the thread clears the row's `safe` byte;
//   - an EMPTY slot: atomicCAS(EMPTY -> key); on failure the slot now
//     holds another thread's key, which is judged as above.
// Exact under any interleaving: slots only ever go from EMPTY to a key,
// and every insert of one term walks the same probe sequence, so all of
// them stop at the first slot of that sequence that no other term holds
// (whoever fills it first), and each one that loses sees the winner's
// leader. A plain (L1-bypassing) load first saves the atomic on slots
// already filled; a stale EMPTY only sends the thread to the CAS.
//
// Bound: the observations read once (8 B N per row) and one byte written
// per row, at 3.35 TB/s. The kernel also writes the tables (8 cap bytes
// per row, by the memset) and touches each observation's slot in L2; at
// the users' size (512 rows of 4096, 32 MB of tables) the tables are
// within the 50 MB L2. One launch per check. No PyTorch headers; a plain
// C entry point bound with ctypes (ops/_build.py).

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kEmpty = ~0ull;
constexpr int kThreads = 256;
// cap = 2^log2cap slots a row; 2N <= cap <= 2^27
constexpr int kMaxLog2Cap = 27;

__global__ void __launch_bounds__(kThreads)
election_insert(const int2* __restrict__ obs,
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
  const uint32_t term = static_cast<uint32_t>(o.x);
  const unsigned long long key =
      (static_cast<unsigned long long>(term) << 32) |
      static_cast<uint32_t>(o.y);
  unsigned long long* t = table + (b << log2cap);
  const uint32_t mask = (1u << log2cap) - 1u;
  uint32_t h = (term * 2654435769u) >> (32 - log2cap);
  for (;;) {
    unsigned long long cur = __ldcg(t + h);
    if (cur == kEmpty) {
      cur = atomicCAS(t + h, kEmpty, key);
      if (cur == kEmpty) return;  // this term's first slot: ours
    }
    if (static_cast<uint32_t>(cur >> 32) == term) {
      if (cur != key) safe[b] = 0;  // one term, two leaders
      return;
    }
    h = (h + 1u) & mask;
  }
}

}  // namespace

// Check B rows of N observations: obs [B, N, 2] int32 (term, leader),
// valid_len [B] int32 or null, table scratch of B << log2cap 64-bit slots
// with 2N <= 2^log2cap, safe [B] bytes out (1 safe, 0 not). Returns 0, a
// CUDA error code, or a negative code for refused arguments (see
// election_safety_error_string). Does not synchronise.
extern "C" int election_safety_launch(const int32_t* obs,
                                      const int32_t* valid_len,
                                      void* table, uint8_t* safe, int B,
                                      int N, int log2cap, int device,
                                      void* stream) {
  if (B < 0) return -1;
  if (N < 1) return -2;
  if (log2cap < 1 || log2cap > kMaxLog2Cap ||
      (2ll * N) > (1ll << log2cap))
    return -3;
  if (B == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t slots = static_cast<size_t>(B) << log2cap;
  err = cudaMemsetAsync(table, 0xFF, slots * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(safe, 1, static_cast<size_t>(B), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(B) * N;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFll) return -4;
  election_insert<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      reinterpret_cast<const int2*>(obs), valid_len,
      static_cast<unsigned long long*>(table), safe, total, N, log2cap);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* election_safety_error_string(int code) {
  switch (code) {
    case -1: return "negative batch";
    case -2: return "N must be at least 1";
    case -3: return "table of 2^log2cap slots must hold 2N, log2cap <= 27";
    case -4: return "more observations than one launch's grid";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
