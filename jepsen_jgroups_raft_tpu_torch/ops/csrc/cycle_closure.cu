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
// Every form is bit-Warshall: for each pivot k, every row i with bit k
// set ORs in row k. Row k does not change at step k (OR with itself), and
// a row read while another thread updates it lies between its old and new
// value: both are subsets of the closure and supersets of what step k
// needs, so any interleaving of whole words gives the closure.
//
// B7 (`cycle_closure_launch`, N <= 512) has two forms:
//   * warp (N <= 128): one warp per graph, 4 graphs a block. Lane l
//     holds rows l, l + 32, ... in registers (NW x NW words, 16 at N =
//     128). For pivot k the owner lane k & 31 broadcasts row k's words
//     with __shfl_sync and every lane ORs them into its rows with bit k
//     set: no block barrier at all. A graph's N NW words are staged
//     through shared memory with consecutive lanes on consecutive words.
//   * panels (128 < N <= 512): one CTA per graph, one thread a row, the matrix
//     in shared memory (row stride padded to an odd word count so the
//     threads' rows fall in distinct banks), closed by `panel_warshall`:
//     blocked Warshall over 32-pivot panels. For panel p every warp
//     closes the 32 x 32 diagonal block in registers by shuffles, the
//     panel's rows take their paths through it (each warp some of their
//     words), one barrier, then every other row ORs in the panel rows its
//     panel word selects, read as broadcasts, and a second barrier: 2
//     barriers per 32 pivots where a barrier per pivot stood before.
//
// B8 (`cycle_closure_tiled_launch`, 512 < N <= 4096): the matrix stays in
// global memory (2 MB at N = 4096, L2-resident) and is closed in place by
// blocked Floyd-Warshall over T x T bit tiles (T = 32 TW). For each pivot
// block kb (rows and columns o..o+T-1), three dependent launches:
//   1. `close_diagonal` (grid B): one CTA a graph closes the diagonal
//      tile D in shared memory by `panel_warshall` and writes D*.
//   2. `fold_tiles`, row panel (grid N/T - 1 x B): tile (kb, jb), jb !=
//      kb, becomes P | D*.P (the pivot rows now hold every path whose
//      intermediate nodes lie in blocks <= kb).
//   3. `fold_tiles`, the rest (grid N/T x (N/T - 1) x B): every tile
//      (ib, jb) with ib != kb ORs in C.R, C = A[ib, kb] and R = A[kb, jb]
//      (new). The column panel (jb = kb) is one of these tiles.
// A fold stages R into shared memory by cp.async while C and the tile
// itself are staged; a thread owns one tile row and folds densely: for
// each pivot k of a 32-pivot word of C, one broadcast vector load of
// R[k] serves its TW accumulators, each word one LOP3 (acc |= R & -bit).
// Owning 2 or 4 rows a thread, so that a load serves more accumulators,
// was slower at every main-path bucket (PERF.md). A
// 32-pivot word that is zero in every lane of the warp is skipped, and
// so is a tile whose whole C is zero. The diagonal is closed once per
// graph and pivot block: closing it in each CTA of a pivot-row launch
// instead repeats that work N/T times, and it then takes most of B8's
// time.
// Step 3 reads tiles that another CTA of the same launch may be writing,
// and is exact under any interleaving of whole words: the C read lies
// between C and C | C.D*, and (C | C.D*).R = C.R because D*.R is
// contained in R. In step 2 each CTA reads only D* and its own tile,
// staged before it writes. A last kernel reads the diagonal.
// The merge of the column-panel fold into step 3 is the only departure
// from the reference's schedule (diagonal closure, row panel, column
// panel, fold); every intermediate matrix is a subset of the closure.
//
// Bound: the graphs' bit matrices read and written once (N^2 / 8 bytes
// each) at 3.35 TB/s, and N^3 / 32 word operations per graph (one
// Warshall pass) at 67 TOP/s; the second dominates at every bucket. The
// word operation (acc | R & mask) is one LOP3 on the integer pipe, so
// the folds are written to issue LOP3s: masks computed once per (row,
// pivot), pivot rows read as broadcast vector loads whose words feed
// as many accumulators. Registers: the warp form holds at most 16 matrix words a lane;
// the folds at most 16 accumulator words a row. No PyTorch headers;
// plain C entry points bound with ctypes (ops/_build.py).

#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxNodesWarp = 128;
constexpr int kMaxNodesMono = 512;
constexpr int kMaxNodesTiled = 4096;
constexpr int kWarpGraphs = 4;  // graphs (warps) a block in the warp form
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ int odd_stride(int nw) { return nw | 1; }

// All ones where bit k of c is set, else zero.
__device__ __forceinline__ uint32_t bit_mask(uint32_t c, int k) {
  return static_cast<uint32_t>(static_cast<int32_t>(c << (31 - k)) >> 31);
}

// `n` words from shared memory at p (16-byte aligned when n % 4 == 0) as
// vector loads.
template <int n>
__device__ __forceinline__ void load_words(uint32_t (&r)[n],
                                           const uint32_t* p) {
  if constexpr (n % 4 == 0) {
#pragma unroll
    for (int q = 0; q < n / 4; ++q) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[q];
      r[4 * q] = v.x;
      r[4 * q + 1] = v.y;
      r[4 * q + 2] = v.z;
      r[4 * q + 3] = v.w;
    }
  } else if constexpr (n == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    r[0] = v.x;
    r[1] = v.y;
  } else {
#pragma unroll
    for (int w = 0; w < n; ++w) r[w] = p[w];
  }
}

// cp.async of BYTES (4, 8 or 16) from global to shared memory.
template <int BYTES>
__device__ __forceinline__ void cp_async(uint32_t* dst, const uint32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(BYTES));
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Close the 32 x 32 block whose row `lane` is d: bit-Warshall in one
// warp, row k broadcast by a shuffle. The warp runs in lockstep and row k
// does not change at step k, so no barrier is needed.
__device__ __forceinline__ uint32_t close_32(uint32_t d) {
#pragma unroll
  for (int k = 0; k < 32; ++k) d |= __shfl_sync(kFull, d, k) & bit_mask(d, k);
  return d;
}

// Blocked Warshall over 32-pivot panels on the matrix M in shared memory:
// blockDim.x rows (one thread a row, a multiple of 32), row stride S
// (odd), pivots 0 .. 32 npanels - 1 (pivot k is row k, its bit in word
// k >> 5), m <= MW words a row. Pn is a 16-byte aligned scratch of 32 MW
// words for the panel's rows. Two barriers a panel; ends in a barrier.
template <int MW>
__device__ __forceinline__ void panel_warshall(uint32_t* M, int S,
                                               int npanels, int m,
                                               uint32_t* Pn) {
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int p = 0; p < npanels; ++p) {
    // 1. every warp closes the diagonal block of the panel in registers
    // (a read of a word another warp is writing lies between D and D*)
    uint32_t* prow = M + (32 * p + lane) * S;
    const uint32_t d = close_32(prow[p]);
    // 2. the panel's rows take their paths through it: word w by warp
    // w mod nwarps; with d closed, any mix of old and new rows is exact
    for (int w = warp; w < m; w += nwarps) {
      uint32_t v = prow[w];
#pragma unroll
      for (int k = 0; k < 32; ++k)
        v |= __shfl_sync(kFull, v, k) & bit_mask(d, k);
      prow[w] = v;
      Pn[lane * MW + w] = v;
    }
    __syncthreads();
    // 3. every other row ORs in the panel rows its panel word selects
    if (warp != p) {
      uint32_t* row = M + tid * S;
      const uint32_t c = row[p];
      if (__reduce_or_sync(kFull, c)) {  // warp-uniform skip
        uint32_t acc[MW];
#pragma unroll
        for (int w = 0; w < MW; ++w) acc[w] = w < m ? row[w] : 0u;
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const uint32_t mk = bit_mask(c, k);
          uint32_t r[MW];
          load_words<MW>(r, Pn + k * MW);
#pragma unroll
          for (int w = 0; w < MW; ++w) acc[w] |= r[w] & mk;
        }
#pragma unroll
        for (int w = 0; w < MW; ++w)
          if (w < m) row[w] = acc[w];
      }
    }
    __syncthreads();
  }
}

// B7, warp form: kWarpGraphs graphs a block, one warp each, the matrix
// in registers (N <= 32 NW). Static shared memory: kWarpGraphs x 32 NW x
// (NW | 1) words for staging.
template <int NW>
__global__ void closure_warp(const uint32_t* __restrict__ in,
                             uint32_t* __restrict__ out,
                             uint8_t* __restrict__ has, int B, int N) {
  constexpr int SW = NW | 1;
  __shared__ uint32_t stage[kWarpGraphs * 32 * NW * SW];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = blockIdx.x * kWarpGraphs + warp;
  if (g >= B) return;  // no block barrier below
  uint32_t* st = stage + warp * (32 * NW * SW);
  const int cells = N * NW;
  const size_t base = static_cast<size_t>(g) * cells;
  for (int idx = lane; idx < cells; idx += 32) {
    const int i = idx / NW;
    st[i * SW + idx - i * NW] = in[base + idx];
  }
  __syncwarp();
  uint32_t R[NW][NW];
#pragma unroll
  for (int r = 0; r < NW; ++r) {
    const int i = 32 * r + lane;
#pragma unroll
    for (int w = 0; w < NW; ++w) R[r][w] = i < N ? st[i * SW + w] : 0u;
  }
#pragma unroll
  for (int kr = 0; kr < NW; ++kr) {
    const int kn = min(32, N - 32 * kr);
#pragma unroll 4
    for (int kl = 0; kl < kn; ++kl) {
      uint32_t rk[NW];
#pragma unroll
      for (int w = 0; w < NW; ++w) rk[w] = __shfl_sync(kFull, R[kr][w], kl);
#pragma unroll
      for (int r = 0; r < NW; ++r) {
        const uint32_t mk = bit_mask(R[r][kr], kl);
#pragma unroll
        for (int w = 0; w < NW; ++w) R[r][w] |= rk[w] & mk;
      }
    }
  }
  __syncwarp();
  uint32_t cyc = 0;
#pragma unroll
  for (int r = 0; r < NW; ++r) {
    const int i = 32 * r + lane;
    if (i < N) {
#pragma unroll
      for (int w = 0; w < NW; ++w) st[i * SW + w] = R[r][w];
      cyc |= (R[r][r] >> lane) & 1u;
    }
  }
  __syncwarp();
  for (int idx = lane; idx < cells; idx += 32) {
    const int i = idx / NW;
    out[base + idx] = st[i * SW + idx - i * NW];
  }
  cyc = __any_sync(kFull, cyc);
  if (lane == 0) has[g] = cyc ? 1 : 0;
}

// B7, panel form: one CTA per graph, 32 NW threads (one a row, padding
// rows zero), the matrix in shared memory. Dynamic shared memory:
// 32 MW + 32 NW (NW | 1) words.
template <int MW>
__global__ void closure_panels(const uint32_t* __restrict__ in,
                               uint32_t* __restrict__ out,
                               uint8_t* __restrict__ has, int N) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int nw = (N + 31) >> 5;
  const int S = odd_stride(nw);
  uint32_t* Pn = smem;
  uint32_t* M = smem + 32 * MW;
  const int tid = threadIdx.x;
  const int cells = N * nw;
  const size_t base = static_cast<size_t>(blockIdx.x) * cells;
  for (int idx = tid; idx < cells; idx += blockDim.x) {
    const int i = idx / nw;
    M[i * S + idx - i * nw] = in[base + idx];
  }
  if (tid >= N)
    for (int w = 0; w < nw; ++w) M[tid * S + w] = 0;
  __syncthreads();
  panel_warshall<MW>(M, S, nw, nw, Pn);
  for (int idx = tid; idx < cells; idx += blockDim.x) {
    const int i = idx / nw;
    out[base + idx] = M[i * S + idx - i * nw];
  }
  const int cyc = tid < N ? (M[tid * S + (tid >> 5)] >> (tid & 31)) & 1 : 0;
  const int any = __syncthreads_or(cyc);
  if (tid == 0) has[blockIdx.x] = any ? 1 : 0;
}

// B8 step 1: close the diagonal tile D of pivot block kb of graph
// blockIdx.x in place, T = 32 TW threads, one a row.
template <int TW>
__global__ void __launch_bounds__(32 * TW)
    close_diagonal(uint32_t* __restrict__ A, int N, int kb) {
  constexpr int T = 32 * TW;
  constexpr int S = TW | 1;
  __shared__ __align__(16) uint32_t Pn[32 * TW];
  __shared__ uint32_t M[T * S];
  const int nw = N >> 5;
  const int tid = threadIdx.x;
  uint32_t* d = A + static_cast<size_t>(blockIdx.x) * N * nw +
                static_cast<size_t>(kb * T) * nw + kb * TW;
  for (int q = tid; q < T * TW; q += T) {
    const int i = q / TW, w = q - i * TW;
    M[i * S + w] = d[static_cast<size_t>(i) * nw + w];
  }
  __syncthreads();
  panel_warshall<TW>(M, S, TW, TW, Pn);
  for (int q = tid; q < T * TW; q += T) {
    const int i = q / TW, w = q - i * TW;
    d[static_cast<size_t>(i) * nw + w] = M[i * S + w];
  }
}

// B8 steps 2 and 3: tile (ib, jb) ORs in A[ib, kb] . A[kb, jb]. With
// `row_panel` the tiles are (kb, jb), jb != kb (C = D*, R the tile's own
// rows as they were); else (ib, jb) with ib != kb (R the new pivot rows).
// T threads, one a tile row.
template <int TW>
__global__ void __launch_bounds__(32 * TW)
    fold_tiles(uint32_t* __restrict__ A, int N, int kb, bool row_panel) {
  constexpr int T = 32 * TW;
  constexpr int S = (2 * TW) | 1;            // [C | acc] row stride
  constexpr int CP = TW < 4 ? TW : 4;        // words a cp.async moves
  __shared__ __align__(16) uint32_t R[T * TW];
  __shared__ uint32_t CA[T * S];
  const int nw = N >> 5;
  int ib, jb;
  if (row_panel) {
    ib = kb;
    jb = blockIdx.x < kb ? blockIdx.x : blockIdx.x + 1;
  } else {
    ib = blockIdx.y < kb ? blockIdx.y : blockIdx.y + 1;
    jb = blockIdx.x;
  }
  const int tid = threadIdx.x;
  uint32_t* a = A + static_cast<size_t>(blockIdx.z) * N * nw;
  // R = the pivot rows' tile (kb, jb), copied asynchronously
  const uint32_t* pivot = a + static_cast<size_t>(kb * T) * nw + jb * TW;
  for (int q = tid; q < T * TW / CP; q += T) {
    const int i = q / (TW / CP), w = (q - i * (TW / CP)) * CP;
    cp_async<4 * CP>(R + i * TW + w, pivot + static_cast<size_t>(i) * nw + w);
  }
  // C = tile (ib, kb) and the tile itself, consecutive lanes on
  // consecutive words of a row
  uint32_t* rows = a + static_cast<size_t>(ib * T) * nw;
  uint32_t any = 0;
  for (int q = tid; q < T * TW; q += T) {
    const int i = q / TW, w = q - i * TW;
    const uint32_t* row = rows + static_cast<size_t>(i) * nw;
    const uint32_t c = row[kb * TW + w];
    any |= c;
    CA[i * S + w] = c;
    CA[i * S + TW + w] = row[jb * TW + w];
  }
  cp_async_wait_all();
  if (!__syncthreads_or(any != 0)) return;  // uniform: no path via kb
  uint32_t acc[TW];
#pragma unroll
  for (int w = 0; w < TW; ++w) acc[w] = CA[tid * S + TW + w];
  for (int wk = 0; wk < TW; ++wk) {
    const uint32_t c = CA[tid * S + wk];
    if (!__reduce_or_sync(kFull, c)) continue;  // warp-uniform skip
    const uint32_t* rk = R + wk * 32 * TW;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      uint32_t r[TW];
      load_words<TW>(r, rk + k * TW);
      const uint32_t mk = bit_mask(c, k);
#pragma unroll
      for (int w = 0; w < TW; ++w) acc[w] |= r[w] & mk;
    }
  }
#pragma unroll
  for (int w = 0; w < TW; ++w) CA[tid * S + TW + w] = acc[w];
  __syncthreads();
  for (int q = tid; q < T * TW; q += T) {
    const int i = q / TW, w = q - i * TW;
    rows[static_cast<size_t>(i) * nw + jb * TW + w] = CA[i * S + TW + w];
  }
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
    close_diagonal<TW><<<B, T, 0, stream>>>(A, N, kb);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    if (nt > 1) {
      fold_tiles<TW><<<dim3(nt - 1, 1, B), T, 0, stream>>>(A, N, kb, true);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
      fold_tiles<TW><<<dim3(nt, nt - 1, B), T, 0, stream>>>(A, N, kb,
                                                          false);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  diagonal_any<<<B, 256, 0, stream>>>(A, has, N);
  return cudaGetLastError();
}

template <int NW>
void launch_warp(const uint32_t* in, uint32_t* out, uint8_t* has, int B,
                 int N, cudaStream_t s) {
  closure_warp<NW><<<(B + kWarpGraphs - 1) / kWarpGraphs, 32 * kWarpGraphs,
                     0, s>>>(in, out, has, B, N);
}

template <int MW>
void launch_panels(const uint32_t* in, uint32_t* out, uint8_t* has, int B,
                   int N, cudaStream_t s) {
  const int nw = (N + 31) >> 5;
  const size_t smem = (static_cast<size_t>(32) * MW +
                       static_cast<size_t>(32) * nw * odd_stride(nw)) *
                      sizeof(uint32_t);
  closure_panels<MW><<<B, 32 * nw, smem, s>>>(in, out, has, N);
}

}  // namespace

// B7: close B graphs of N <= 512 nodes, bits [B, N, ceil(N/32)] int32 in
// `in`, the closure to `out`, has_cycle to `has` (B bytes): the warp form
// up to 128 nodes, the panel form above. Returns 0, a CUDA error code, or
// a negative code for refused arguments (see cycle_closure_error_string).
// Does not synchronise.
extern "C" int cycle_closure_launch(const int32_t* in, int32_t* out,
                                    uint8_t* has, int B, int N, int device,
                                    void* stream) {
  if (B < 0 || B > 65535) return -1;
  if (N < 1 || N > kMaxNodesMono) return -2;
  if (B == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint32_t* i = reinterpret_cast<const uint32_t*>(in);
  uint32_t* o = reinterpret_cast<uint32_t*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nw = (N + 31) >> 5;
  switch (nw) {
    case 1: launch_warp<1>(i, o, has, B, N, s); break;
    case 2: launch_warp<2>(i, o, has, B, N, s); break;
    case 3: launch_warp<3>(i, o, has, B, N, s); break;
    case 4: launch_warp<4>(i, o, has, B, N, s); break;
    default:
      if (nw <= 8) {
        launch_panels<8>(i, o, has, B, N, s);
      } else {
        launch_panels<16>(i, o, has, B, N, s);
      }
  }
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
