// frontier_tiles: per row u of each bitmap tile, the smallest local
// column c with A[b,u,c] > 0 and f[b,c] > 0, else INT32_MAX.
//
// Replaces the Pallas kernel src/repro/kernels/frontier_tile.py::frontier_tiles
// (BFS's dense bottom-up K_D path, src/repro/algorithms/bfs.py:162).
//
// Bound on Hopper: memory.  The work is one compare per tile element, and
// only the elements up to the first hit of a row are needed, so the bytes
// read depend on the data: from nd*T*sizeof(f) when every row hits in its
// first columns up to nd*T*T*sizeof(tile) when no row hits.
//
// Design: grid (nd, ceil(T/8)), 8 warps; one warp per tile row.  The
// frontier columns of tile b are staged once per block as bytes in shared
// memory.  The warp scans the row 32 columns at a time, lane l reading
// column c0+l (one coalesced line per step, and only where the frontier
// bit is set); __ballot_sync gathers the hits of the step and the lowest
// set bit is the row's minimum, so the warp stops at the first step with
// a hit.  That early exit is the paper's "stop at the first frontier
// neighbour" (Listing 3), which the TPU kernel had to replace with a full
// min-reduction.  The result is exact; an empty frontier gives INT32_MAX
// everywhere.  Any T works: lanes past T are masked (the Pallas kernel
// shrank its panel to a divisor of T instead).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // tile rows per block
constexpr int kIntMax = 2147483647;

__device__ __forceinline__ bool positive(float v) { return v > 0.f; }
__device__ __forceinline__ bool positive(__nv_bfloat16 v) { return __bfloat162float(v) > 0.f; }
__device__ __forceinline__ bool positive(uint8_t v) { return v != 0; }

template <typename T, typename F>
__global__ void __launch_bounds__(kWarps * 32)
frontier_tiles_kernel(const T* __restrict__ tiles, const F* __restrict__ fcols,
                      int* __restrict__ out, int t) {
  extern __shared__ uint8_t f_s[];
  const long long b = blockIdx.x;
  for (int c = threadIdx.x; c < t; c += blockDim.x) f_s[c] = positive(fcols[b * t + c]);
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int u = blockIdx.y * kWarps + warp;
  if (u >= t) return;  // the whole warp shares u
  const T* row = tiles + (b * t + u) * (long long)t;
  int best = kIntMax;
  for (int c0 = 0; c0 < t; c0 += 32) {
    const int c = c0 + lane;
    const bool hit = c < t && f_s[c] && positive(row[c]);
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (mask) {
      best = c0 + __ffs(mask) - 1;
      break;
    }
  }
  if (lane == 0) out[b * t + u] = best;
}

template <typename T, typename F>
cudaError_t launch(const void* tiles, const void* fcols, int* out, long long nd,
                   int t, cudaStream_t stream) {
  const size_t smem = (size_t)t;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(frontier_tiles_kernel<T, F>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((unsigned)nd, (unsigned)((t + kWarps - 1) / kWarps));
  frontier_tiles_kernel<T, F><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(tiles), static_cast<const F*>(fcols), out, t);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_f(const void* tiles, const void* fcols, int* out, long long nd,
                     int t, int fdtype, cudaStream_t stream) {
  switch (fdtype) {
    case 0: return launch<T, uint8_t>(tiles, fcols, out, nd, t, stream);
    case 1: return launch<T, float>(tiles, fcols, out, nd, t, stream);
    case 2: return launch<T, __nv_bfloat16>(tiles, fcols, out, nd, t, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype of the tiles: 0 = float32, 1 = bfloat16.
// fdtype of the frontier columns: 0 = bool (one byte), 1 = float32, 2 = bfloat16.
extern "C" int frontier_tiles_launch(int device, const void* tiles, const void* fcols,
                                     void* out, long long nd, int t, int dtype,
                                     int fdtype, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  switch (dtype) {
    case 0: return launch_f<float>(tiles, fcols, o, nd, t, fdtype, s);
    case 1: return launch_f<__nv_bfloat16>(tiles, fcols, o, nd, t, fdtype, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* frontier_tiles_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
