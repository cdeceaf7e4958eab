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
// Design: one thread per (b, r), 256 threads a block.  The thread walks
// its K entries, reads x[b, idx] only where the mask is set (padding
// entries may hold any index), and sums in float32; y is written once in
// x's dtype.  The inputs are restrict-qualified, so x may be read through
// the read-only cache; at the chip configuration one batch row of x (4 MB
// in float32) fits in L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
spmv_ell_kernel(const int* __restrict__ idx, const unsigned char* __restrict__ valid,
                const T* __restrict__ x, T* __restrict__ y, long long rows, int r, int k,
                long long n) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= rows) return;
  const T* xb = x + (t / r) * n;
  const int* ip = idx + t * k;
  const unsigned char* vp = valid + t * k;
  float acc = 0.f;
  for (int j = 0; j < k; ++j)
    if (vp[j]) acc += to_f32(xb[ip[j]]);
  put(y + t, acc);
}

template <typename T>
cudaError_t launch(const void* idx, const void* valid, const void* x, void* y, int b, int r,
                   int k, long long n, cudaStream_t stream) {
  const long long rows = (long long)b * r;
  spmv_ell_kernel<T><<<(unsigned)((rows + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      static_cast<const int*>(idx), static_cast<const unsigned char*>(valid),
      static_cast<const T*>(x), static_cast<T*>(y), rows, r, k, n);
  return cudaGetLastError();
}

}  // namespace

// idx: (b, r, k) int32; valid: (b, r, k) bool (one byte each); x: (b, n);
// y: (b, r) in x's dtype: 0 = float32, 1 = bfloat16.  All contiguous.
extern "C" int spmv_ell_launch(int device, const void* idx, const void* valid, const void* x,
                               void* y, int b, int r, int k, long long n, int dtype,
                               void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(idx, valid, x, y, b, r, k, n, s);
    case 1: return launch<__nv_bfloat16>(idx, valid, x, y, b, r, k, n, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* spmv_ell_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
