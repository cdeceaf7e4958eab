// flash_attention: online-softmax attention with float32 running (m, l, acc),
// grouped K/V heads (GQA) and suffix-aligned causal masking.
//
// Replaces the Pallas kernel src/repro/kernels/attn_tile.py::flash_attention
// (the LM's prefill/eval attention, src/repro/models/attention.py:147).
//
// Computes, for every (b, h) and query row i:
//   out[i] = softmax_j(scale * q[i] . k[j]) v[j]   over the visible keys j,
// where head h reads K/V head h / (H / H_kv) (the reference repeats K/V to
// H heads first; reading the shared head in place gives the same numbers),
// and with `causal` key j is visible to row i iff j <= i + (S_k - S_q).
// scale = D^-1/2 is applied to q in float32, as the TPU kernel does.  A row
// with no visible key gets l = 0 and writes 0 (acc / max(l, 1e-30)).
//
// Bound on Hopper: operations.  The two products do 4*D flops for every
// visible (query, key) pair, and each q/k/v/o element is read or written
// once, so at the LM's shapes (S = 4096, D = 128) there are ~1,600 flops
// per byte -- far above the ~295 at which even the bf16 tensor cores
// outrun device memory.  This first version runs both products in float32
// on the CUDA cores (67 TFLOP/s peak, not the tensor cores' 989).
//
// Design: grid (ceil(S_q/64), B*H), 128 threads.  A block owns 64 query
// rows; it stages them once in shared memory (float32, scaled), then walks
// the keys in tiles of 32 rows: K and V tiles are staged in shared memory,
// each thread computes a 4x4 patch of the 64x32 score tile (rows 4*ty..,
// columns tx + 8*j), row max and row sum are reduced over the 8 threads
// that share a row with __shfl_xor_sync, the probabilities go through
// shared memory, and each thread accumulates 4 rows x D/8 output columns
// in registers.  Causal blocks stop at their last visible key tile, and
// blocks are issued last-query-block first so the longest ones start
// early.  Ragged S_q and S_k are masked here (the Pallas kernel asserted
// S % 128 == 0).  Row strides of the q and k tiles are padded by one word
// and the probability tile by two, so that no shared-memory read conflicts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;                     // query rows per block
constexpr int kBK = 32;                     // key rows per shared-memory tile
constexpr int kThreads = 128;
constexpr int kColThreads = 8;              // threads sharing one score row
constexpr int kRows = kBQ / (kThreads / kColThreads);   // 4 rows per thread
constexpr int kCols = kBK / kColThreads;                // 4 score columns per thread
constexpr int kPld = kBK + 2;               // padded row stride of the p tile
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) +
                          (size_t)kBK * D + (size_t)kBQ * kPld);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int h, int group,
                       int sq, int sk, int causal, float scale) {
  constexpr int kLd = D + 1;                // padded row stride of the q and k tiles
  constexpr int kDc = D / kColThreads;      // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                        // kBQ x kLd
  float* k_s = q_s + kBQ * kLd;             // kBK x kLd
  float* v_s = k_s + kBK * kLd;             // kBK x D
  float* p_s = v_s + kBK * D;               // kBQ x kPld

  const int bh = blockIdx.y;
  const int b = bh / h, hh = bh % h;
  const int h_kv = h / group;
  const long long q0 = (long long)(gridDim.x - 1 - blockIdx.x) * kBQ;
  const T* qp = q + ((long long)bh * sq + q0) * D;
  const T* kp = k + (long long)(b * h_kv + hh / group) * sk * D;
  const T* vp = v + (long long)(b * h_kv + hh / group) * sk * D;
  T* op = o + ((long long)bh * sq + q0) * D;

  const int tid = threadIdx.x;
  const int tx = tid % kColThreads, ty = tid / kColThreads;
  const long long off = (long long)sk - sq;  // row i sees keys j <= i + off

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    q_s[r * kLd + c] = q0 + r < sq ? to_f32(qp[(long long)r * D + c]) * scale : 0.f;
  }

  float acc[kRows][kDc];
  float m[kRows], l[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNeg;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDc; ++c) acc[i][c] = 0.f;
  }

  long long kend = sk;
  if (causal) kend = min(kend, q0 + kBQ + off);   // past the block's last visible key
  for (long long k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();                        // the previous tile is consumed
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < sk;
      k_s[r * kLd + c] = in ? to_f32(kp[(k0 + r) * D + c]) : 0.f;
      v_s[r * D + c] = in ? to_f32(vp[(k0 + r) * D + c]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = q_s[(ty * kRows + i) * kLd + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv[j] = k_s[(tx + kColThreads * j) * kLd + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const long long row = q0 + ty * kRows + i;
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const long long col = k0 + tx + kColThreads * j;
        const bool ok = col < sk && (!causal || col <= row + off);
        s[i][j] = ok ? s[i][j] : kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < kColThreads; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = s[i][j] > kNeg / 2 ? expf(s[i][j] - m_new) : 0.f;
        p_s[(ty * kRows + i) * kPld + tx + kColThreads * j] = p;
        sum += p;
      }
#pragma unroll
      for (int w = 1; w < kColThreads; w <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      const float alpha = expf(fminf(m[i] - m_new, 0.f));
      l[i] = alpha * l[i] + sum;
#pragma unroll
      for (int c = 0; c < kDc; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = p_s[(ty * kRows + i) * kPld + kk];
#pragma unroll
      for (int c = 0; c < kDc; ++c) {
        const float vv = v_s[kk * D + tx + kColThreads * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    if (q0 + r >= sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kDc; ++c) put(&op[(long long)r * D + tx + kColThreads * c], acc[i][c] / den);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int b, int h,
                   int h_kv, int sq, int sk, int causal, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)((sq + kBQ - 1) / kBQ), (unsigned)(b * h));
  flash_attention_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), h, h / h_kv, sq, sk, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, int b, int h,
                     int h_kv, int sq, int sk, int d, int causal, float scale,
                     cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64>(q, k, v, o, b, h, h_kv, sq, sk, causal, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, b, h, h_kv, sq, sk, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (b, h, sq, d); k, v: (b, h_kv, sk, d); all contiguous and of one
// dtype: 0 = float32, 1 = bfloat16.  d must be 64 or 128, h a multiple of h_kv.
extern "C" int flash_attention_launch(int device, const void* q, const void* k,
                                      const void* v, void* o, int b, int h, int h_kv,
                                      int sq, int sk, int d, int causal, float scale,
                                      int dtype, void* stream) {
  if (h_kv <= 0 || h % h_kv != 0) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_d<float>(q, k, v, o, b, h, h_kv, sq, sk, d, causal, scale, s);
    case 1: return launch_d<__nv_bfloat16>(q, k, v, o, b, h, h_kv, sq, sk, d, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
