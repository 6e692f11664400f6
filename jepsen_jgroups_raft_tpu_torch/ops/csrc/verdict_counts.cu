// B10's verdict counts on Hopper (sm_90a): the per-shard reduction of a
// batch's (ok, overflow) flags into the two counts a batch check reports.
//
// Replaces the `jnp.sum` + `jax.lax.psum` pair inside the reference's
// jepsen_jgroups_raft_tpu/parallel/mesh.py `sharded_batch_checker`
// (:171-172) and `sharded_dense_checker` (:211-212). On one card the
// mesh is one launch of the scan kernel over the whole batch, which
// counts its own verdicts in its epilogue (the same routine); this
// kernel counts flags that are already in memory. Across processes the
// two counts are summed by torch.distributed (parallel/distributed.py
// `check_batch_global`).
//
//   dense mode (0): n_valid = sum(ok & real),
//                   n_unknown = sum(overflow & real)
//   sort mode (1):  n_valid = sum(ok & ~overflow & real),
//                   n_unknown = sum(overflow & real)
//
// Inputs: ok, overflow and real are [B] bool tensors (one byte a row, 0
// or 1), each possibly a slice of a larger tensor at any byte offset.
// Output: out [2] int64 (n_valid, n_unknown).
//
// Redesigned on the shared routine (verdict_counts.cuh). The work is
// nothing at the sizes a batch check has (3 kB read at B = 1000), so the
// design is about what surrounds it:
//
// * Up to kOneCtaRows rows (four passes of kThreads 16-byte chunks) the
//   launch is ONE block, which stores out[0..1] itself: one launch, no
//   memset, no atomics; B = 0 launches it too and stores zeros. Above
//   that, a grid of up to kBlocksPerSm blocks an SM after a 16-byte
//   memset on the same stream, each block one RED a nonzero counter.
// * The loop: 16-byte chunks, one uint4 load of each flag array a chunk,
//   when the three arrays share their offset modulo 16 (a scalar head
//   runs up to the first aligned byte and a scalar tail after the last
//   whole chunk); otherwise the whole batch takes the scalar loop. Bytes
//   are 0 or 1, so the count of a 32-bit word of combined flags is one
//   __popc.
//
// Bound: 3·B bytes read and 16 written, at 3.35 TB/s; at the north
// star's B = 1000 that is ~1 ns, so the kernel is launch-bound. No
// PyTorch headers; a plain C entry point bound with ctypes
// (ops/_build.py).

#include <cstdint>
#include <cuda_runtime.h>

#include "verdict_counts.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;
constexpr int kMaxDevices = 64;
constexpr long long kOneCtaRows = 4ll * kThreads * 16;

template <int kMode>
__global__ void __launch_bounds__(kThreads)
verdict_counts_kernel(const uint8_t* __restrict__ ok,
                      const uint8_t* __restrict__ ov,
                      const uint8_t* __restrict__ real,
                      unsigned long long* __restrict__ out, long long B) {
  count_open();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const uintptr_t a = reinterpret_cast<uintptr_t>(ok);
  const bool vec = ((a ^ reinterpret_cast<uintptr_t>(ov)) & 15u) == 0 &&
                   ((a ^ reinterpret_cast<uintptr_t>(real)) & 15u) == 0;
  // the scalar head: up to ok's first 16-byte boundary, or every row
  // when the three arrays do not share their offset modulo 16
  const long long to_aligned = static_cast<long long>((16u - (a & 15u)) & 15u);
  const long long head = vec ? (B < to_aligned ? B : to_aligned) : B;
  const long long n_vec = vec ? (B - head) / 16 : 0;
  const long long tail = head + n_vec * 16;
  uint32_t n_valid = 0, n_unknown = 0;
  for (long long i = tid; i < head; i += stride) {
    const uint32_t o = ok[i], v = ov[i], r = real[i];
    n_valid += valid_bits<kMode>(o, v, r) & 1u;
    n_unknown += v & r;
  }
  const uint4* ok4 = reinterpret_cast<const uint4*>(ok + head);
  const uint4* ov4 = reinterpret_cast<const uint4*>(ov + head);
  const uint4* re4 = reinterpret_cast<const uint4*>(real + head);
#pragma unroll 4
  for (long long c = tid; c < n_vec; c += stride) {
    const uint4 o = __ldg(ok4 + c), v = __ldg(ov4 + c), r = __ldg(re4 + c);
    n_valid += __popc(valid_bits<kMode>(o.x, v.x, r.x)) +
               __popc(valid_bits<kMode>(o.y, v.y, r.y)) +
               __popc(valid_bits<kMode>(o.z, v.z, r.z)) +
               __popc(valid_bits<kMode>(o.w, v.w, r.w));
    n_unknown += __popc(v.x & r.x) + __popc(v.y & r.y) +
                 __popc(v.z & r.z) + __popc(v.w & r.w);
  }
  for (long long i = tail + tid; i < B; i += stride) {
    const uint32_t o = ok[i], v = ov[i], r = real[i];
    n_valid += valid_bits<kMode>(o, v, r) & 1u;
    n_unknown += v & r;
  }
  count_rows(n_valid, n_unknown, kWarps, out);
}

int sm_count(int device) {
  static int cached[kMaxDevices] = {};
  if (cached[device] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess || n < 1)
      n = 1;
    cached[device] = n;  // a benign race: every thread writes the same
  }
  return cached[device];
}

}  // namespace

// Count the verdicts of B rows: ok, overflow, real [B] bytes (0 or 1,
// any alignment), out [2] int64 (n_valid, n_unknown), in `mode` 0
// (dense) or 1 (sort): one block up to kOneCtaRows rows, a grid after
// a memset of `out` above. Returns 0, a CUDA error code, or a negative
// code for refused arguments (see verdict_counts_error_string). Does not
// synchronise.
extern "C" int verdict_counts_launch(const uint8_t* ok,
                                     const uint8_t* overflow,
                                     const uint8_t* real, long long* out,
                                     long long B, int mode, int device,
                                     void* stream) {
  if (B < 0) return -1;
  if (B >= (1ll << 32)) return -5;  // the per-thread and block sums are 32-bit
  if (mode != kCountDense && mode != kCountSort) return -2;
  if (device < 0 || device >= kMaxDevices) return -3;
  if (out == nullptr) return -4;
  if (B > 0 && (ok == nullptr || overflow == nullptr || real == nullptr))
    return -4;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long blocks = 1;
  if (B > kOneCtaRows) {
    err = cudaMemsetAsync(out, 0, 2 * sizeof(long long), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long chunks = (B + 15) / 16;
    blocks = (chunks + kThreads - 1) / kThreads;
    const long long cap =
        static_cast<long long>(sm_count(device)) * kBlocksPerSm;
    if (blocks > cap) blocks = cap;
  }
  auto* o = reinterpret_cast<unsigned long long*>(out);
  if (mode == kCountSort)
    verdict_counts_kernel<kCountSort><<<static_cast<unsigned>(blocks),
                                        kThreads, 0, s>>>(ok, overflow, real,
                                                          o, B);
  else
    verdict_counts_kernel<kCountDense><<<static_cast<unsigned>(blocks),
                                         kThreads, 0, s>>>(ok, overflow,
                                                           real, o, B);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* verdict_counts_error_string(int code) {
  switch (code) {
    case -1: return "negative batch";
    case -2: return "mode must be 0 (dense) or 1 (sort)";
    case -3: return "device index beyond 64";
    case -4: return "a null flag or output pointer";
    case -5: return "B beyond 2^32 - 1 rows";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
