// Batched boolean transitive closure over bit-packed adjacency matrices:
// the exact cycle tier's kernels on Hopper (sm_90a).
//
// Replaces the reference's two XLA closure programs,
// jepsen_jgroups_raft_tpu/ops/kernel_ir.py `make_cycle_closure` (B7,
// repeated int32 matrix squaring R <- R | R.R, N <= 512) and
// `make_cycle_closure_tiled` (B8, blocked Floyd-Warshall over T x T int32
// tiles, N <= 4096). The contract is theirs: per graph the closure
// (every path of length >= 1) and has_cycle = any diagonal bit. The
// closure is unique, so these kernels give the reference's matrix bit for
// bit although they compute it another way.
//
// Layout: a graph of N nodes (zero-padded to its bucket) is N rows of
// NW = ceil(N / 32) 32-bit words; bit j of word w of row i is the edge
// i -> 32w + j. Padding bits and rows are zero and stay zero: a zero row
// is never ORed into anything, and no row gains a bit its ORed rows lack.
//
// B7 (`cycle_closure_launch`, N <= 512): one CTA per graph holds the whole
// bit matrix in shared memory (N x NW words, 32 KB at N = 512; the row
// stride is padded to an odd word count so the threads' rows fall in
// distinct banks) and runs bit-Warshall: for k = 0..N-1, every row i with
// bit k set ORs in row k. One thread per row, one __syncthreads per k.
// Row k does not change during step k (OR with itself), so the update is
// in place; its owner skips it. N^2 NW / 2 word operations in the worst
// case per graph, against ceil(log2 N) times that for squaring.
//
// B8 (`cycle_closure_tiled_launch`, 512 < N <= 4096): the matrix stays in
// global memory (2 MB at N = 4096, L2-resident) and is closed in place by
// blocked Floyd-Warshall over T x T bit tiles (T = 32 TW, one thread per
// tile row). For each pivot block kb (rows and columns o..o+T-1):
//   1. `pivot_rows` (grid N/T x B): each CTA loads the diagonal tile D and
//      the pivot rows' tile P of its column block jb into shared memory,
//      closes D with B7's routine (paths inside the block), and writes
//      P | D*.P (the pivot rows now hold every path whose intermediate
//      nodes lie in blocks <= kb). For jb = kb that is D* itself.
//   2. `fold_rest` (grid N/T x (N/T - 1) x B): every tile (ib, jb) with
//      ib != kb ORs in C.R, C = A[ib, kb] and R = A[kb, jb] (new), rows of
//      R staged in shared memory. The column panel (jb = kb) is one of
//      these tiles.
// Both phases read tiles that another CTA of the same launch may be
// writing, and both are exact under any interleaving of whole words:
// in (1) the D read lies between D and D*, whose closure is D*; in (2)
// the C read lies between C and C | C.D*, and (C | C.D*).R = C.R because
// D*.R is contained in R. A last kernel reads the diagonal.
// The merge of the column-panel fold into step 2 is the only departure
// from the reference's schedule (diagonal closure, row panel, column
// panel, fold); every intermediate matrix is a subset of the closure.
//
// Bound: the graphs' bit matrices read and written once (N^2 / 8 bytes
// each) at 3.35 TB/s, and N^3 / 32 word operations per graph (one
// Warshall pass) at 67 TOP/s; the second dominates at every bucket. The
// kernels skip rows without the pivot bit (B7) and pivot tiles whose
// column panel is empty (B8), so sparse dependency graphs cost less.
// Registers: a thread keeps at most 2 TW <= 16 words of a tile row; a
// 4096-bit row (128 words) is never held whole. No PyTorch headers; plain
// C entry points bound with ctypes (ops/_build.py).

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxNodesMono = 512;
constexpr int kMaxNodesTiled = 4096;

__host__ __device__ __forceinline__ int odd_stride(int nw) { return nw | 1; }

// Close the n x n bit matrix M in shared memory (nw words per row, row
// stride `stride` words): bit-Warshall, one __syncthreads per pivot.
__device__ __forceinline__ void warshall_smem(uint32_t* M, int n, int nw,
                                              int stride) {
  for (int k = 0; k < n; ++k) {
    __syncthreads();
    const uint32_t* rk = M + k * stride;
    const int kw = k >> 5;
    const uint32_t kbit = 1u << (k & 31);
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      uint32_t* ri = M + i * stride;
      if (i != k && (ri[kw] & kbit)) {
        for (int w = 0; w < nw; ++w) ri[w] |= rk[w];
      }
    }
  }
  __syncthreads();
}

// B7: one CTA per graph, the whole matrix in shared memory.
__global__ void closure_mono(const uint32_t* __restrict__ in,
                             uint32_t* __restrict__ out,
                             uint8_t* __restrict__ has, int N) {
  extern __shared__ uint32_t M[];
  const int nw = (N + 31) >> 5;
  const int stride = odd_stride(nw);
  const int cells = N * nw;
  const size_t base = static_cast<size_t>(blockIdx.x) * cells;
  for (int idx = threadIdx.x; idx < cells; idx += blockDim.x) {
    const int i = idx / nw;
    M[i * stride + (idx - i * nw)] = in[base + idx];
  }
  warshall_smem(M, N, nw, stride);
  for (int idx = threadIdx.x; idx < cells; idx += blockDim.x) {
    const int i = idx / nw;
    out[base + idx] = M[i * stride + (idx - i * nw)];
  }
  int cyc = 0;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    cyc |= (M[i * stride + (i >> 5)] >> (i & 31)) & 1;
  }
  cyc = __syncthreads_or(cyc);
  if (threadIdx.x == 0) has[blockIdx.x] = cyc ? 1 : 0;
}

// B8 step 1: the pivot rows' tile of column block blockIdx.x.
template <int TW>
__global__ void pivot_rows(uint32_t* __restrict__ A, int N, int kb) {
  constexpr int T = 32 * TW;
  constexpr int S = TW | 1;
  __shared__ uint32_t D[T * S];
  __shared__ uint32_t P[T * S];
  const int nw = N >> 5;
  const int jb = blockIdx.x;
  const int i = threadIdx.x;  // blockDim.x == T
  uint32_t* a = A + static_cast<size_t>(blockIdx.y) * N * nw;
  const uint32_t* row = a + static_cast<size_t>(kb * T + i) * nw;
#pragma unroll
  for (int w = 0; w < TW; ++w) {
    D[i * S + w] = row[kb * TW + w];
    P[i * S + w] = row[jb * TW + w];
  }
  warshall_smem(D, T, TW, S);
  uint32_t acc[TW];
#pragma unroll
  for (int w = 0; w < TW; ++w) acc[w] = P[i * S + w];
#pragma unroll
  for (int wk = 0; wk < TW; ++wk) {
    uint32_t bits = D[i * S + wk];
    while (bits) {
      const int k = wk * 32 + __ffs(bits) - 1;
      bits &= bits - 1;
#pragma unroll
      for (int w = 0; w < TW; ++w) acc[w] |= P[k * S + w];
    }
  }
  uint32_t* dst = a + static_cast<size_t>(kb * T + i) * nw + jb * TW;
#pragma unroll
  for (int w = 0; w < TW; ++w) dst[w] = acc[w];
}

// B8 step 2: tile (ib, jb), ib != kb, ORs in A[ib, kb] . A[kb, jb].
template <int TW>
__global__ void fold_rest(uint32_t* __restrict__ A, int N, int kb) {
  constexpr int T = 32 * TW;
  constexpr int S = TW | 1;
  __shared__ uint32_t R[T * S];
  const int nw = N >> 5;
  const int jb = blockIdx.x;
  const int ib = blockIdx.y < kb ? blockIdx.y : blockIdx.y + 1;
  const int i = threadIdx.x;  // blockDim.x == T
  uint32_t* a = A + static_cast<size_t>(blockIdx.z) * N * nw;
  uint32_t* row = a + static_cast<size_t>(ib * T + i) * nw;
  uint32_t c[TW];
  uint32_t any = 0;
#pragma unroll
  for (int w = 0; w < TW; ++w) {
    c[w] = row[kb * TW + w];
    any |= c[w];
  }
  if (!__syncthreads_or(any != 0)) return;  // uniform: no path via kb
  const uint32_t* pivot = a + static_cast<size_t>(kb * T + i) * nw;
#pragma unroll
  for (int w = 0; w < TW; ++w) R[i * S + w] = pivot[jb * TW + w];
  __syncthreads();
  if (!any) return;
  uint32_t acc[TW];
#pragma unroll
  for (int w = 0; w < TW; ++w) acc[w] = row[jb * TW + w];
#pragma unroll
  for (int wk = 0; wk < TW; ++wk) {
    uint32_t bits = c[wk];
    while (bits) {
      const int k = wk * 32 + __ffs(bits) - 1;
      bits &= bits - 1;
#pragma unroll
      for (int w = 0; w < TW; ++w) acc[w] |= R[k * S + w];
    }
  }
#pragma unroll
  for (int w = 0; w < TW; ++w) row[jb * TW + w] = acc[w];
}

// has_cycle of each graph: any diagonal bit.
__global__ void diagonal_any(const uint32_t* __restrict__ A,
                             uint8_t* __restrict__ has, int N) {
  const int nw = N >> 5;
  const uint32_t* a = A + static_cast<size_t>(blockIdx.x) * N * nw;
  int cyc = 0;
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    cyc |= (a[static_cast<size_t>(i) * nw + (i >> 5)] >> (i & 31)) & 1;
  }
  cyc = __syncthreads_or(cyc);
  if (threadIdx.x == 0) has[blockIdx.x] = cyc ? 1 : 0;
}

template <int TW>
cudaError_t run_tiled(uint32_t* A, uint8_t* has, int B, int N,
                      cudaStream_t stream) {
  constexpr int T = 32 * TW;
  const int nt = N / T;
  for (int kb = 0; kb < nt; ++kb) {
    pivot_rows<TW><<<dim3(nt, B), T, 0, stream>>>(A, N, kb);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (nt > 1) {
      fold_rest<TW><<<dim3(nt, nt - 1, B), T, 0, stream>>>(A, N, kb);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  diagonal_any<<<B, 256, 0, stream>>>(A, has, N);
  return cudaGetLastError();
}

}  // namespace

// B7: close B graphs of N <= 512 nodes, bits [B, N, ceil(N/32)] int32 in
// `in`, the closure to `out`, has_cycle to `has` (B bytes). Returns 0, a
// CUDA error code, or a negative code for refused arguments (see
// cycle_closure_error_string). Does not synchronise.
extern "C" int cycle_closure_launch(const int32_t* in, int32_t* out,
                                    uint8_t* has, int B, int N, int device,
                                    void* stream) {
  if (B < 0 || B > 65535) return -1;
  if (N < 1 || N > kMaxNodesMono) return -2;
  if (B == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nw = (N + 31) >> 5;
  const int threads = ((N + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(N) * odd_stride(nw) *
                      sizeof(uint32_t);
  closure_mono<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint32_t*>(in), reinterpret_cast<uint32_t*>(out),
      has, N);
  return static_cast<int>(cudaGetLastError());
}

// B8: close B graphs of 512 < N <= 4096 nodes in place, bits
// [B, N, N/32] int32 in `a`, at tile T in {32, 64, 128, 256} dividing N;
// has_cycle to `has`. Returns as cycle_closure_launch. Does not
// synchronise.
extern "C" int cycle_closure_tiled_launch(int32_t* a, uint8_t* has, int B,
                                          int N, int T, int device,
                                          void* stream) {
  if (B < 0 || B > 65535) return -1;
  if (N <= kMaxNodesMono || N > kMaxNodesTiled) return -3;
  if ((T != 32 && T != 64 && T != 128 && T != 256) || N % T) return -4;
  if (B == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  uint32_t* A = reinterpret_cast<uint32_t*>(a);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (T) {
    case 32: err = run_tiled<1>(A, has, B, N, s); break;
    case 64: err = run_tiled<2>(A, has, B, N, s); break;
    case 128: err = run_tiled<4>(A, has, B, N, s); break;
    default: err = run_tiled<8>(A, has, B, N, s); break;
  }
  return static_cast<int>(err);
}

extern "C" const char* cycle_closure_error_string(int code) {
  switch (code) {
    case -1: return "batch beyond 0..65535 graphs";
    case -2: return "N beyond the monolithic closure's 1..512";
    case -3: return "N beyond the blocked closure's 513..4096";
    case -4: return "tile not in {32, 64, 128, 256} or not dividing N";
    default: return cudaGetErrorString(static_cast<cudaError_t>(code));
  }
}
