// B10's verdict counts as one device routine, shared by the standalone
// kernel (verdict_counts.cu) and the epilogues of the one-shot scan
// kernels (dense_scan.cu, mask_scan.cu, sort_scan.cu), which count the
// verdicts they hold in registers with no extra pass.
//
// The counts are the reference's (jepsen_jgroups_raft_tpu/parallel/
// mesh.py:171-172 in sort mode, :211-212 in dense mode):
//
//   dense mode: n_valid += ok & real,             n_unknown += overflow & real
//   sort mode:  n_valid += ok & ~overflow & real, n_unknown += overflow & real
//
// How a block counts: every lane of each counting warp hands its rows'
// counts to `count_rows` (a scan kernel's warp: its row's verdict in
// lane 0; the standalone kernel: each lane's partial sums). The warp
// sums with __reduce_add_sync. A block of several counting warps sums
// in shared memory (`count_open` zeroes it first): each warp's lane 0
// adds its sum with a shared atomic and takes a ticket, and the last to
// arrive flushes the block's sums. No warp waits on another, so a scan
// warp whose history ended early exits as before. The flush: a grid of
// one block stores out[0..1] (the launch needs no zeroing); a larger
// grid makes at most one 64-bit atomicAdd (RED) a counter a block, none
// when the sum is zero, into counters its launch zeroed on the same
// stream. Integer atomics are exact in any order, so the counts equal
// the plain version's bit for bit.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum : int { kCountDense = 0, kCountSort = 1 };

// The valid rows of ok, overflow and real (words of 0/1 bytes, or bits).
template <int kMode>
__device__ __forceinline__ uint32_t valid_bits(uint32_t ok, uint32_t ov,
                                               uint32_t real) {
  return kMode == kCountSort ? (ok & ~ov & real) : (ok & real);
}

// A block's running sums and arrivals, in static shared memory: only a
// kernel that counts references it, so the others keep their footprint.
// 16 bytes at 16-byte alignment, so that wherever it is placed the
// kernel's own shared arrays keep the alignment of their 128-bit loads
// (at 12 bytes it cost B1's transition rows their LDS.128).
struct __align__(16) CountTally {
  unsigned int valid, unknown, arrived, unused;
};

__device__ __forceinline__ CountTally* count_tally() {
  __shared__ CountTally tally;
  return &tally;
}

// Zero the block's tally. Every thread of the block calls it before any
// thread exits or counts: it ends in a block barrier.
__device__ __forceinline__ void count_open() {
  if (threadIdx.x == 0) {
    CountTally* t = count_tally();
    t->valid = 0u;
    t->unknown = 0u;
    t->arrived = 0u;
  }
  __syncthreads();
}

// Count: called once by every lane of each of the `warps` counting warps
// of this block (with `warps` > 1 only after count_open), with the
// counts of the rows the lane holds. A block's sums stay below 2^32.
__device__ __forceinline__ void count_rows(uint32_t valid, uint32_t unknown,
                                           int warps,
                                           unsigned long long* out) {
  valid = __reduce_add_sync(0xffffffffu, valid);
  unknown = __reduce_add_sync(0xffffffffu, unknown);
  if ((threadIdx.x & 31) != 0) return;
  if (warps > 1) {
    CountTally* t = count_tally();
    if (valid) atomicAdd(&t->valid, valid);
    if (unknown) atomicAdd(&t->unknown, unknown);
    __threadfence_block();
    if (atomicAdd(&t->arrived, 1u) != static_cast<unsigned>(warps - 1))
      return;
    __threadfence_block();  // every other warp's sums are in
    valid = atomicAdd(&t->valid, 0u);
    unknown = atomicAdd(&t->unknown, 0u);
  }
  if (gridDim.x == 1) {
    out[0] = valid;
    out[1] = unknown;
    return;
  }
  if (valid) atomicAdd(out, static_cast<unsigned long long>(valid));
  if (unknown) atomicAdd(out + 1, static_cast<unsigned long long>(unknown));
}

}  // namespace
