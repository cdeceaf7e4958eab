// tc_tiles: triangle count of tile triples,
//   sum_b sum_{r,s} (A_ik[b] A_jk[b]^T)[r,s] * A_ij[b][r,s],
// where triple b = idx[b] = (ij, ik, jk) names three tiles of one batch
// and a triple whose ij entry is negative counts nothing.
//
// Replaces the Pallas kernel src/repro/kernels/tc_tile.py::tc_tiles
// (triangle counting's dense K_D path, src/repro/algorithms/tc.py:313).
//
// Bound on Hopper: operations.  A full (T x T x T) product per triple is
// 2*T^3 flops against 3*T^2 elements read.  The work the data needs is
// only 2*T per nonzero of A_ij (one wedge row dot product per edge), so
// the mask decides how far this kernel, which computes whole patches, is
// from that bound.
//
// Design: grid (B, ceil(T/64)^2), 256 threads; each block owns one
// 64x64 patch (r in [r0, r0+64), s in [s0, s0+64)) of one triple.
// * The block first loads its A_ij patch into shared memory and leaves
//   at once when the patch is empty -- on sparse tiles most of the
//   product is never computed.
// * It then runs the wedge product over c in steps of 32: 64x32 panels
//   of A_ik (rows r) and A_jk (rows s) are read coalesced along c and
//   stored transposed in shared memory; each thread accumulates a 4x4
//   set of wedge counts (rows ty+16i, columns tx+16j, so that a warp's
//   shared reads are broadcasts or consecutive words) in f32 registers.
//   A wedge count is an integer <= T, exact in f32.
// * It masks the counts with the patch, sums them as 64-bit integers,
//   and adds the block's partial to one global 64-bit counter with a
//   single atomicAdd.
// The TPU kernel carried one f32 sum across its sequential grid; blocks
// here run in no order, and integer atomics make the count exact and
// independent of that order (the f32 sum is exact only below 2^24).
// The kernel reads the three tiles in place through idx, so the
// (B, T, T) operand copies the reference gathers are never built.  Any T
// works: out-of-range rows and columns load as zero.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kPatch = 64;   // patch side (rows r and columns s)
constexpr int kStep = 32;    // depth of one shared-memory panel along c
constexpr int kThreads = 256;
constexpr int kSub = 4;      // wedge counts per thread along r and along s

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
tc_tiles_kernel(const T* __restrict__ tiles, const int* __restrict__ idx,
                unsigned long long* __restrict__ count, int t, int patches) {
  __shared__ float a_s[kStep][kPatch + 1];
  __shared__ float b_s[kStep][kPatch + 1];
  __shared__ float m_s[kPatch][kPatch + 1];
  __shared__ long long warp_sum[kThreads / 32];

  const long long b = blockIdx.x;
  const int ij = idx[3 * b], ik = idx[3 * b + 1], jk = idx[3 * b + 2];
  if (ij < 0) return;  // masked (padding) triple
  const int r0 = (blockIdx.y / patches) * kPatch;
  const int s0 = (blockIdx.y % patches) * kPatch;
  const size_t tt = (size_t)t * t;
  const T* a_ij = tiles + (size_t)ij * tt;
  const T* a_ik = tiles + (size_t)ik * tt;
  const T* a_jk = tiles + (size_t)jk * tt;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  int any = 0;
  for (int e = tid; e < kPatch * kPatch; e += kThreads) {
    const int rr = e / kPatch, ss = e % kPatch;
    const int r = r0 + rr, s = s0 + ss;
    const float v = (r < t && s < t) ? to_f32(a_ij[(size_t)r * t + s]) : 0.f;
    m_s[rr][ss] = v;
    any |= (v != 0.f);
  }
  if (!__syncthreads_or(any)) return;  // empty patch: no triangle here

  float acc[kSub][kSub] = {};
  for (int c0 = 0; c0 < t; c0 += kStep) {
    for (int e = tid; e < kPatch * kStep; e += kThreads) {
      const int rr = e / kStep, cc = e % kStep;
      const int c = c0 + cc;
      const int r = r0 + rr, s = s0 + rr;
      a_s[cc][rr] = (r < t && c < t) ? to_f32(a_ik[(size_t)r * t + c]) : 0.f;
      b_s[cc][rr] = (s < t && c < t) ? to_f32(a_jk[(size_t)s * t + c]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int cc = 0; cc < kStep; ++cc) {
      float av[kSub], bv[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) av[i] = a_s[cc][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kSub; ++j) bv[j] = b_s[cc][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  long long part = 0;
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j)
      part += __float2ll_rn(acc[i][j] * m_s[ty + 16 * i][tx + 16 * j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) part += __shfl_down_sync(0xffffffffu, part, off);
  if ((tid & 31) == 0) warp_sum[tid >> 5] = part;
  __syncthreads();
  if (tid == 0) {
    long long total = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += warp_sum[w];
    if (total) atomicAdd(count, (unsigned long long)total);
  }
}

template <typename T>
cudaError_t launch(const void* tiles, const int* idx, unsigned long long* count,
                   long long nb, int t, cudaStream_t stream) {
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(unsigned long long), stream);
  if (e != cudaSuccess || nb == 0) return e;
  const int patches = (t + kPatch - 1) / kPatch;
  dim3 grid((unsigned)nb, (unsigned)(patches * patches));
  tc_tiles_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(tiles), idx,
                                                    count, t, patches);
  return cudaGetLastError();
}

}  // namespace

// dtype of the tiles: 0 = float32, 1 = bfloat16.  idx is (nb, 3) int32;
// count is one int64, zeroed here on the same stream before the launch.
extern "C" int tc_tiles_launch(int device, const void* tiles, const void* idx,
                               void* count, long long nb, int t, int dtype,
                               void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  unsigned long long* cnt = static_cast<unsigned long long*>(count);
  switch (dtype) {
    case 0: return launch<float>(tiles, ix, cnt, nb, t, s);
    case 1: return launch<__nv_bfloat16>(tiles, ix, cnt, nb, t, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* tc_tiles_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
