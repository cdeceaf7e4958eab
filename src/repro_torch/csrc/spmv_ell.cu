// spmv_ell: ELL-format SpMV, y[b, r] = sum_k x[b, idx[b, r, k]] * valid[b, r, k].
//
// Replaces the Pallas kernel src/repro/kernels/spmv_ell.py::spmv_ell (the
// sparse-path SpMV over padded neighbour lists; no algorithm of the
// reference calls it).
//
// Bound on Hopper: memory.  Each (b, r, k) entry costs a 4-byte index, a
// 1-byte mask and, where the mask is set, one gathered element of x, for
// one add -- well under one flop per byte.
//
// Design: a group of L lanes per (b, r) row, L a power of two up to 32, so
// that a warp's loads of idx and valid cover whole 128-byte lines.
// * Vector route (K % 4 == 0, idx 16-byte and valid 4-byte aligned): lane j
//   of a group takes the chunks j, j + L, ... of four entries, one int4
//   load of indices and one 4-byte load of masks each; L is the least power
//   of two >= K / 4 (K = 32: 8 lanes a row, a warp reads 4 rows' 512
//   contiguous bytes of idx and 128 of valid).
// * Scalar route (any other K, e.g. K = 7): lane j takes the entries j,
//   j + L, ... one at a time; L is the least power of two >= K, so a warp
//   reads 32 / L neighbouring rows' entries, contiguous in memory.
// Each lane gathers x[b, idx] only where the mask is set (padding entries
// may hold any index and are never dereferenced), through the read-only
// path: at the chip configuration one batch row of x (4 MB in float32)
// stays in the 50 MB L2.  The group sums its lanes' float32 partials with
// __shfl_xor_sync, and its first lane writes y once, in x's dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_guard.cuh"  // restores the caller's current device

namespace {

constexpr int kThreads = 256;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float gather(const float* p) { return __ldg(p); }
__device__ __forceinline__ float gather(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
spmv_ell_kernel(const int* __restrict__ idx, const unsigned char* __restrict__ valid,
                const T* __restrict__ x, T* __restrict__ y, long long rows, int r, int k,
                long long n, int lanes_log2) {
  const int lanes = 1 << lanes_log2;
  const long long row = ((long long)blockIdx.x * kThreads + threadIdx.x) >> lanes_log2;
  const int j = threadIdx.x & (lanes - 1);
  float acc = 0.f;
  if (row < rows) {
    const T* xb = x + (row / r) * n;
    if (kVec) {
      const int4* ip = reinterpret_cast<const int4*>(idx + row * k);
      const uchar4* vp = reinterpret_cast<const uchar4*>(valid + row * k);
      for (int c = j; c < k / 4; c += lanes) {
        const int4 i4 = __ldg(ip + c);
        const uchar4 v4 = __ldg(vp + c);
        if (v4.x) acc += gather(xb + i4.x);
        if (v4.y) acc += gather(xb + i4.y);
        if (v4.z) acc += gather(xb + i4.z);
        if (v4.w) acc += gather(xb + i4.w);
      }
    } else {
      const int* ip = idx + row * k;
      const unsigned char* vp = valid + row * k;
      for (int c = j; c < k; c += lanes)
        if (__ldg(vp + c)) acc += gather(xb + __ldg(ip + c));
    }
  }
  for (int o = lanes >> 1; o > 0; o >>= 1) acc += __shfl_xor_sync(kAll, acc, o);
  if (row < rows && j == 0) put(y + row, acc);
}

template <typename T, bool kVec>
cudaError_t launch(const void* idx, const void* valid, const void* x, void* y, int b, int r,
                   int k, long long n, cudaStream_t stream) {
  const long long rows = (long long)b * r;
  const int per_lane = kVec ? k / 4 : k;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < per_lane && lanes_log2 < 5) ++lanes_log2;
  const long long threads = rows << lanes_log2;
  spmv_ell_kernel<T, kVec><<<(unsigned)((threads + kThreads - 1) / kThreads), kThreads, 0,
                             stream>>>(
      static_cast<const int*>(idx), static_cast<const unsigned char*>(valid),
      static_cast<const T*>(x), static_cast<T*>(y), rows, r, k, n, lanes_log2);
  return cudaGetLastError();
}

}  // namespace

// idx: (b, r, k) int32; valid: (b, r, k) bool (one byte each); x: (b, n);
// y: (b, r) in x's dtype: 0 = float32, 1 = bfloat16.  All contiguous.
// vec = 1 takes the vector route: the caller promises k % 4 == 0, idx 16-byte
// and valid 4-byte aligned.
extern "C" int spmv_ell_launch(int device, const void* idx, const void* valid, const void* x,
                               void* y, int b, int r, int k, long long n, int dtype, int vec,
                               void* stream) {
  DeviceGuard guard(device);  // the caller's device is current again on return
  if (guard.err != cudaSuccess) return guard.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 2 + (vec ? 1 : 0)) {
    case 0: return launch<float, false>(idx, valid, x, y, b, r, k, n, s);
    case 1: return launch<float, true>(idx, valid, x, y, b, r, k, n, s);
    case 2: return launch<__nv_bfloat16, false>(idx, valid, x, y, b, r, k, n, s);
    case 3: return launch<__nv_bfloat16, true>(idx, valid, x, y, b, r, k, n, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* spmv_ell_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
