// frontier_tiles: per row u of each bitmap tile, the smallest local
// column c with A[b,u,c] > 0 and f[b,c] > 0, else INT32_MAX; with a query
// axis, the same for Q frontiers f[q] against the shared tiles.
//
// Replaces the Pallas kernel src/repro/kernels/frontier_tile.py::frontier_tiles
// (BFS's dense bottom-up K_D path, src/repro/algorithms/bfs.py:162, and
// under vmap the multi-source BFS of graph serving, :137-149).
//
// Contract: tile b is zero at rows >= rows[b] and columns >= cols[b] (its
// block's rectangle in the padded T x T tile; no extents means the whole
// tile).  The kernel reads nothing outside the rectangle.
//
// Bound on Hopper: memory.  The work is one compare per frontier column of
// a row, and only the ones up to the row's first hit are needed, so the
// bytes read depend on the data: from nothing (an empty frontier) up to
// every frontier column of every row inside the rectangles.
//
// Design: grid (nd, Q), 256 threads (8 warps); one block per (tile, query).
// * Each query's frontier is compacted by its own block, so a block whose
//   query has an empty frontier in the tile writes INT32_MAX and leaves
//   without stalling the other queries' blocks.  The tile is read once per
//   query that probes it (the probes stop at different columns).
// * The block reads the frontier columns c < cols[b] of its tile once and
//   compacts the set ones, in order, into a list in shared memory (a
//   ballot and a prefix popc per warp, warp offsets through shared
//   memory).
// * Rows u >= rows[b] -- and every row when the list is empty -- write
//   INT32_MAX without reading the tile.
// * A warp takes 8 rows at a time and walks the list 32 entries per step:
//   lane l gathers A[b, u, list[j0 + l]] for each of the 8 rows (8
//   independent loads in flight), one ballot per row gives that row's
//   hits, and because the list is in column order the lowest set bit is
//   the row's minimum.  A row leaves the walk at its first hit, the warp
//   when all 8 have (the paper's "stop at the first frontier neighbour",
//   Listing 3, which the TPU kernel had to replace with a full
//   min-reduction over the tile).
// The result is exact for any T.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_guard.cuh"  // restores the caller's current device
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 8;   // rows in flight per warp
constexpr int kIntMax = 2147483647;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ bool positive(float v) { return v > 0.f; }
__device__ __forceinline__ bool positive(__nv_bfloat16 v) { return __bfloat162float(v) > 0.f; }
__device__ __forceinline__ bool positive(uint8_t v) { return v != 0; }

__device__ __forceinline__ int extent(const int* ext, long long b, int t) {
  return ext ? min(max(ext[b], 0), t) : t;
}

template <typename T, typename F>
__global__ void __launch_bounds__(kThreads)
frontier_tiles_kernel(const T* __restrict__ tiles, const F* __restrict__ fcols,
                      const int* __restrict__ ext_rows, const int* __restrict__ ext_cols,
                      int* __restrict__ out, long long nd, int t) {
  extern __shared__ int list[];   // the tile's frontier columns, in order
  __shared__ int warp_n[kWarps];
  const long long b = blockIdx.x;
  const int rows = extent(ext_rows, b, t), cols = extent(ext_cols, b, t);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // this block's query: its frontier and output slabs
  const long long slab = (long long)blockIdx.y * nd * t;
  fcols += slab;
  int* o = out + slab + b * t;

  int n = 0;
  for (int c0 = 0; c0 < cols; c0 += kThreads) {
    const int c = c0 + tid;
    const bool set = c < cols && positive(fcols[b * t + c]);
    const unsigned m = __ballot_sync(kAll, set);
    if (lane == 0) warp_n[warp] = __popc(m);
    __syncthreads();
    int at = n;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      at += w < warp ? warp_n[w] : 0;
      n += warp_n[w];
    }
    if (set) list[at + __popc(m & ((1u << lane) - 1u))] = c;
    __syncthreads();
  }

  for (int u = (n ? rows : 0) + tid; u < t; u += kThreads) o[u] = kIntMax;
  if (n == 0) return;

  for (int u0 = warp * kRows; u0 < rows; u0 += kWarps * kRows) {
    const T* row = tiles + (b * t + u0) * (long long)t;
    unsigned open = 0;
    int best[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      best[k] = kIntMax;
      open |= (u0 + k < rows ? 1u : 0u) << k;
    }
    for (int j0 = 0; j0 < n && open; j0 += 32) {
      const int j = j0 + lane;
      const int c = j < n ? list[j] : 0;
      bool hit[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        hit[k] = j < n && ((open >> k) & 1u) && positive(row[(long long)k * t + c]);
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const unsigned m = __ballot_sync(kAll, hit[k]);
        if (m && ((open >> k) & 1u)) {   // uniform across the warp
          best[k] = __shfl_sync(kAll, c, __ffs(m) - 1);
          open &= ~(1u << k);
        }
      }
    }
    int mine = kIntMax;
#pragma unroll
    for (int k = 0; k < kRows; ++k) mine = lane == k ? best[k] : mine;
    if (lane < kRows && u0 + lane < rows) o[u0 + lane] = mine;
  }
}

template <typename T, typename F>
cudaError_t launch(const void* tiles, const void* fcols, const int* rows, const int* cols,
                   int* out, long long nq, long long nd, int t, cudaStream_t stream) {
  if (nd > 0x7fffffffLL || nq < 1 || nq > 65535) return cudaErrorInvalidValue;
  const size_t smem = (size_t)t * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(frontier_tiles_kernel<T, F>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  frontier_tiles_kernel<T, F><<<dim3((unsigned)nd, (unsigned)nq), kThreads, smem, stream>>>(
      static_cast<const T*>(tiles), static_cast<const F*>(fcols), rows, cols, out, nd, t);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_f(const void* tiles, const void* fcols, const int* rows, const int* cols,
                     int* out, long long nq, long long nd, int t, int fdtype,
                     cudaStream_t stream) {
  switch (fdtype) {
    case 0: return launch<T, uint8_t>(tiles, fcols, rows, cols, out, nq, nd, t, stream);
    case 1: return launch<T, float>(tiles, fcols, rows, cols, out, nq, nd, t, stream);
    case 2: return launch<T, __nv_bfloat16>(tiles, fcols, rows, cols, out, nq, nd, t, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of the tiles: 0 = float32, 1 = bfloat16.
// fdtype of the frontier columns: 0 = bool (one byte), 1 = float32, 2 = bfloat16.
// fcols and out are (nq, nd, T); out is int32.  rows and cols are the (nd,)
// int32 extents of the tiles, or both null for whole tiles.
extern "C" int frontier_tiles_launch(int device, const void* tiles, const void* fcols,
                                     const void* rows, const void* cols, void* out,
                                     long long nq, long long nd, int t, int dtype,
                                     int fdtype, void* stream) {
  DeviceGuard guard(device);  // the caller's device is current again on return
  if (guard.err != cudaSuccess) return guard.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  const int* er = static_cast<const int*>(rows);
  const int* ec = static_cast<const int*>(cols);
  switch (dtype) {
    case 0: return launch_f<float>(tiles, fcols, er, ec, o, nq, nd, t, fdtype, s);
    case 1: return launch_f<__nv_bfloat16>(tiles, fcols, er, ec, o, nq, nd, t, fdtype, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* frontier_tiles_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
