// B10's verdict counts on Hopper (sm_90a): the per-shard reduction of a
// batch's (ok, overflow) flags into the two counts a batch check reports.
//
// Replaces the `jnp.sum` + `jax.lax.psum` pair inside the reference's
// jepsen_jgroups_raft_tpu/parallel/mesh.py `sharded_batch_checker`
// (:171-172) and `sharded_dense_checker` (:211-212): on one card the
// mesh is one launch of the scan kernel over the whole batch, then this
// kernel; across processes the two counts are summed by
// torch.distributed (parallel/distributed.py `check_batch_global`).
//
//   dense mode (0): n_valid = sum(ok & real),
//                   n_unknown = sum(overflow & real)
//   sort mode (1):  n_valid = sum(ok & ~overflow & real),
//                   n_unknown = sum(overflow & real)
//
// Inputs: ok, overflow and real are [B] bool tensors (one byte a row, 0
// or 1), each possibly a slice of a larger tensor at any byte offset.
// Output: out [2] int64 (n_valid, n_unknown), zeroed by the entry point
// on the same stream before the launch, so B = 0 writes zeros.
//
// Design: a grid-stride loop over 16-byte chunks, one uint4 load of each
// flag array a chunk, when the three arrays share their offset modulo 16
// (then a scalar head runs up to the first aligned byte and a scalar
// tail after the last whole chunk); otherwise the whole batch takes the
// scalar loop. Bytes are 0 or 1, so the count of a 32-bit word of
// combined flags is one __popc. A warp sums with __reduce_add_sync, the
// block in shared memory, and one thread makes one 64-bit atomicAdd a
// counter.
//
// Bound: 3·B bytes read and 16 written, at 3.35 TB/s; at the north
// star's B = 1000 that is ~1 ns, so the kernel is launch-bound. No
// PyTorch headers; a plain C entry point bound with ctypes
// (ops/_build.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;
constexpr int kMaxDevices = 64;

enum : int { kModeDense = 0, kModeSort = 1 };

template <int kMode>
__device__ __forceinline__ uint32_t valid_word(uint32_t ok, uint32_t ov,
                                               uint32_t real) {
  return kMode == kModeSort ? (ok & ~ov & real) : (ok & real);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads)
verdict_counts_kernel(const uint8_t* __restrict__ ok,
                      const uint8_t* __restrict__ ov,
                      const uint8_t* __restrict__ real,
                      unsigned long long* __restrict__ out, long long B) {
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
    n_valid += valid_word<kMode>(o, v, r) & 1u;
    n_unknown += v & r;
  }
  const uint4* ok4 = reinterpret_cast<const uint4*>(ok + head);
  const uint4* ov4 = reinterpret_cast<const uint4*>(ov + head);
  const uint4* re4 = reinterpret_cast<const uint4*>(real + head);
  for (long long c = tid; c < n_vec; c += stride) {
    const uint4 o = __ldg(ok4 + c), v = __ldg(ov4 + c), r = __ldg(re4 + c);
    n_valid += __popc(valid_word<kMode>(o.x, v.x, r.x)) +
               __popc(valid_word<kMode>(o.y, v.y, r.y)) +
               __popc(valid_word<kMode>(o.z, v.z, r.z)) +
               __popc(valid_word<kMode>(o.w, v.w, r.w));
    n_unknown += __popc(v.x & r.x) + __popc(v.y & r.y) +
                 __popc(v.z & r.z) + __popc(v.w & r.w);
  }
  for (long long i = tail + tid; i < B; i += stride) {
    const uint32_t o = ok[i], v = ov[i], r = real[i];
    n_valid += valid_word<kMode>(o, v, r) & 1u;
    n_unknown += v & r;
  }
  n_valid = __reduce_add_sync(0xFFFFFFFFu, n_valid);
  n_unknown = __reduce_add_sync(0xFFFFFFFFu, n_unknown);
  __shared__ uint32_t warp_valid[kWarps], warp_unknown[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    warp_valid[warp] = n_valid;
    warp_unknown[warp] = n_unknown;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sv = 0, su = 0;
    for (int w = 0; w < kWarps; ++w) {
      sv += warp_valid[w];
      su += warp_unknown[w];
    }
    if (sv) atomicAdd(out, sv);
    if (su) atomicAdd(out + 1, su);
  }
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
// (dense) or 1 (sort). Zeroes out on `stream`, then launches when B > 0.
// Returns 0, a CUDA error code, or a negative code for refused
// arguments (see verdict_counts_error_string). Does not synchronise.
extern "C" int verdict_counts_launch(const uint8_t* ok,
                                     const uint8_t* overflow,
                                     const uint8_t* real, long long* out,
                                     long long B, int mode, int device,
                                     void* stream) {
  if (B < 0) return -1;
  if (B >= (1ll << 32)) return -5;  // the per-thread and warp sums are 32-bit
  if (mode != kModeDense && mode != kModeSort) return -2;
  if (device < 0 || device >= kMaxDevices) return -3;
  if (out == nullptr) return -4;
  if (B > 0 && (ok == nullptr || overflow == nullptr || real == nullptr))
    return -4;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(out, 0, 2 * sizeof(long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0) return 0;
  const long long chunks = (B + 15) / 16;
  long long blocks = (chunks + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count(device)) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  auto* o = reinterpret_cast<unsigned long long*>(out);
  if (mode == kModeSort)
    verdict_counts_kernel<kModeSort><<<static_cast<unsigned>(blocks),
                                       kThreads, 0, s>>>(ok, overflow, real,
                                                         o, B);
  else
    verdict_counts_kernel<kModeDense><<<static_cast<unsigned>(blocks),
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
