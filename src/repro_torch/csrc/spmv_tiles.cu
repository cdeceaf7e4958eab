// spmv_tiles: y[b] = A[b]^T x[b] over a batch of dense 0/1 bitmap tiles.
//
// Replaces the Pallas kernel src/repro/kernels/spmv_tile.py::spmv_tiles
// (PageRank's dense K_D path, src/repro/algorithms/pagerank.py:100).
//
// Bound on Hopper: memory.  Each tile element is read once and used in
// one multiply-add, so the kernel moves nd*T*T*sizeof(tile) bytes for
// 2*nd*T*T flops -- far below the ~20 flop/byte at which an H100's f32
// units, let alone its tensor cores, would become the limit.
//
// Design: grid (nd, ceil(T/128)), 128 threads.  x[b] is staged once per
// block in shared memory; each thread owns one output column c and walks
// the rows r, so a warp reads 32 neighbouring elements of row r (one
// coalesced 128-byte line in f32) per step and keeps 8 loads in flight
// through the unrolled loop.  The f32 accumulator is private to the
// thread, so no reduction or atomic is needed.  Any T works: the last
// column block masks c >= T (the Pallas kernel asserted T % 128 == 0).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;  // output columns per block, one per thread

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kCols)
spmv_tiles_kernel(const T* __restrict__ tiles, const T* __restrict__ xs,
                  float* __restrict__ ys, int t) {
  extern __shared__ float x_s[];
  const long long b = blockIdx.x;
  const T* xb = xs + b * t;
  for (int r = threadIdx.x; r < t; r += blockDim.x) x_s[r] = to_f32(xb[r]);
  __syncthreads();
  const int c = blockIdx.y * kCols + threadIdx.x;
  if (c >= t) return;
  const T* a = tiles + b * (long long)t * t + c;
  float acc = 0.f;
#pragma unroll 8
  for (int r = 0; r < t; ++r) acc = fmaf(to_f32(a[(long long)r * t]), x_s[r], acc);
  ys[b * t + c] = acc;
}

template <typename T>
cudaError_t launch(const void* tiles, const void* xs, float* ys, long long nd,
                   int t, cudaStream_t stream) {
  const size_t smem = (size_t)t * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(spmv_tiles_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
  }
  dim3 grid((unsigned)nd, (unsigned)((t + kCols - 1) / kCols));
  spmv_tiles_kernel<T><<<grid, kCols, smem, stream>>>(
      static_cast<const T*>(tiles), static_cast<const T*>(xs), ys, t);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (tiles and xs share it); ys is float32.
extern "C" int spmv_tiles_launch(int device, const void* tiles, const void* xs,
                                 void* ys, long long nd, int t, int dtype,
                                 void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* y = static_cast<float*>(ys);
  switch (dtype) {
    case 0: return launch<float>(tiles, xs, y, nd, t, s);
    case 1: return launch<__nv_bfloat16>(tiles, xs, y, nd, t, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* spmv_tiles_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
