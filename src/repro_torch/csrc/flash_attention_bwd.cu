// flash_attention_bwd: the gradient of flash_attention (flash_attention.cu)
// with respect to q, k and v, from the forward's output and its row
// log-sum-exp.
//
// Replaces no Pallas kernel.  src/repro/kernels/attn_tile.py::flash_attention
// has no custom_vjp: JAX differentiates through the Pallas call, which on the
// CPU (interpret mode) raises, so the reference trains through its plain
// _sdpa path (src/repro/models/attention.py).  A training step of the port
// runs the forward kernel, so it needs this backward.  It computes what
// repro_torch.kernels.ref.attention_bwd_ref computes, for scale = D^-1/2:
//
//   P  = exp(scale q k^T - lse) over the visible keys, else 0
//   dV = P^T dO,   dP = dO V^T,   Delta = rowsum(dO o O),   dS = P o (dP - Delta)
//   dQ = scale dS K,   dK = scale dS^T Q
//
// with dK and dV summed over the H/H_kv query heads that read one K/V head,
// and suffix-aligned causal masking (key j is visible to row i iff
// j <= i + S_k - S_q).  A row with no visible key has lse = +inf and sends
// exactly 0.  Ragged S_q and S_k are masked here; D is 64 or 128.
//
// Three kernels, launched in order on the caller's stream:
//
// (a) delta: one warp per query row, Delta = rowsum(dO o O) in float32.
// (b) dkdv: a block per (tile of 64 keys, b * H_kv), 256 threads.  It stages K
//     and V of its keys in shared memory once and keeps dK and dV in
//     registers (each thread 4 keys x D/16 columns of each); it loops over the
//     group's query heads and over the query tiles of 64 rows that can see its
//     keys (causal: from row k0 - (S_k - S_q) on), recomputing S^T and dP^T
//     (each thread a 4 x 4 patch) and P from lse, then accumulates P^T dO and
//     dS^T Q through shared memory.  The block owns its 64 output rows of dK
//     and dV: no atomics, and the shared head is never repeated.
// (c) dq: a block per (tile of 64 query rows, b * H), 128 threads, issued last
//     tile first so that the longest causal rows start early; it walks the
//     tiles of 32 keys the rows see, recomputing S and dP, and keeps dQ in
//     registers.
//
// No float atomics anywhere: two runs on the same inputs give the same bits.
// The price is that (b) and (c) both recompute S and dP: seven products per
// visible (query, key) pair where a backward needs five.
//
// Bound on Hopper: operations.  The five products do 10 D flops for every
// visible (query, key) pair, at most 989 TFLOP/s on the bf16 tensor cores;
// each input and gradient is read or written once, ~1,000 flops per byte at
// S = 4096.  This first version does all its arithmetic in float32 on the CUDA
// cores (67 TFLOP/s) for both dtypes: bf16 inputs are widened as they are
// staged into shared memory and the gradients are rounded to the input dtype
// once, at the store.  It is meant to be right and simple; a wgmma/TMA
// redesign is queued (ROADMAP B).  Shared-memory rows are padded by one float
// so that no read of a thread's patch conflicts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_guard.cuh"  // restores the caller's current device

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// ------------------------------------------------------------ (a) Delta

constexpr int kDeltaRows = 8;               // rows per 256-thread block, a warp each

template <typename T>
__global__ void __launch_bounds__(256)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
             long long rows, int d) {
  const long long row = (long long)blockIdx.x * kDeltaRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;                  // the whole warp leaves together
  const T* op = o + row * d;
  const T* gp = dout + row * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s = fmaf(to_float(op[c]), to_float(gp[c]), s);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
  if (lane == 0) delta[row] = s;
}

// ------------------------------------------------------------ (b) dK, dV

namespace kv {

constexpr int kBK = 64;                     // keys per block
constexpr int kBQ = 64;                     // query rows per tile
constexpr int kThreads = 256;
constexpr int kColThreads = 16;             // threads sharing one key row of a tile
constexpr int kRows = kBK / (kThreads / kColThreads);   // 4 keys per thread
constexpr int kCols = kBQ / kColThreads;                // 4 query rows per thread
constexpr int kPld = kBQ + 1;               // padded row stride of the p and ds tiles

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * (size_t)kBK * (D + 1) + 2 * (size_t)kBQ * (D + 1) +
                          2 * (size_t)kBK * kPld + 2 * (size_t)kBQ);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
       const T* __restrict__ dout, const float* __restrict__ lse,
       const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int h,
       int group, int sq, int sk, int causal, float scale) {
  constexpr int kLd = D + 1;                // padded row stride of the k, v, q, dO tiles
  constexpr int kDc = D / kColThreads;      // output columns per thread
  extern __shared__ float smem[];
  float* k_s = smem;                        // kBK x kLd
  float* v_s = k_s + kBK * kLd;             // kBK x kLd
  float* q_s = v_s + kBK * kLd;             // kBQ x kLd
  float* do_s = q_s + kBQ * kLd;            // kBQ x kLd
  float* p_s = do_s + kBQ * kLd;            // kBK x kPld: P^T of the tile
  float* ds_s = p_s + kBK * kPld;           // kBK x kPld: dS^T of the tile
  float* lse_s = ds_s + kBK * kPld;         // kBQ
  float* dl_s = lse_s + kBQ;                // kBQ: Delta

  const int bkv = blockIdx.y;               // b * h_kv + K/V head
  const int h_kv = h / group;
  const int b = bkv / h_kv, hk = bkv % h_kv;
  const long long k0 = (long long)blockIdx.x * kBK;
  const long long off = (long long)sk - sq;  // row i sees keys j <= i + off
  const int tid = threadIdx.x;
  const int tx = tid % kColThreads, ty = tid / kColThreads;

  const T* kp = k + ((long long)bkv * sk + k0) * D;
  const T* vp = v + ((long long)bkv * sk + k0) * D;
  for (int e = tid; e < kBK * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const bool in = k0 + r < sk;
    k_s[r * kLd + c] = in ? to_float(kp[(long long)r * D + c]) : 0.f;
    v_s[r * kLd + c] = in ? to_float(vp[(long long)r * D + c]) : 0.f;
  }

  float acc_k[kRows][kDc], acc_v[kRows][kDc];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kDc; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  // the first query tile with a row that sees key k0
  long long qstart = causal ? max(0LL, k0 - off) : 0LL;
  qstart -= qstart % kBQ;
  for (int g = 0; g < group; ++g) {
    const long long bh = (long long)b * h + (long long)hk * group + g;
    const T* qp = q + bh * sq * D;
    const T* dop = dout + bh * sq * D;
    for (long long q0 = qstart; q0 < sq; q0 += kBQ) {
      __syncthreads();                      // the previous tile is consumed
      for (int e = tid; e < kBQ * D; e += kThreads) {
        const int r = e / D, c = e % D;
        const bool in = q0 + r < sq;
        q_s[r * kLd + c] = in ? to_float(qp[(q0 + r) * D + c]) : 0.f;
        do_s[r * kLd + c] = in ? to_float(dop[(q0 + r) * D + c]) : 0.f;
      }
      if (tid < kBQ) {
        const bool in = q0 + tid < sq;
        lse_s[tid] = in ? lse[bh * sq + q0 + tid] : INFINITY;
        dl_s[tid] = in ? delta[bh * sq + q0 + tid] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: this thread's 4 keys x 4 query rows
      float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float kr[kRows], vr[kRows], qr[kCols], gr[kCols];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          kr[i] = k_s[(ty * kRows + i) * kLd + d];
          vr[i] = v_s[(ty * kRows + i) * kLd + d];
        }
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          qr[j] = q_s[(tx + kColThreads * j) * kLd + d];
          gr[j] = do_s[(tx + kColThreads * j) * kLd + d];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kCols; ++j) {
            s[i][j] = fmaf(kr[i], qr[j], s[i][j]);
            dp[i][j] = fmaf(vr[i], gr[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const long long key = k0 + ty * kRows + i;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int c = tx + kColThreads * j;
          const long long row = q0 + c;
          const bool ok = key < sk && row < sq && (!causal || key <= row + off);
          const float p = ok ? expf(s[i][j] * scale - lse_s[c]) : 0.f;
          p_s[(ty * kRows + i) * kPld + c] = p;
          ds_s[(ty * kRows + i) * kPld + c] = p * (dp[i][j] - dl_s[c]);
        }
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q over the tile's rows
#pragma unroll 4
      for (int c = 0; c < kBQ; ++c) {
        float pr[kRows], sr[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          pr[i] = p_s[(ty * kRows + i) * kPld + c];
          sr[i] = ds_s[(ty * kRows + i) * kPld + c];
        }
#pragma unroll
        for (int cc = 0; cc < kDc; ++cc) {
          const float gv = do_s[c * kLd + tx + kColThreads * cc];
          const float qv = q_s[c * kLd + tx + kColThreads * cc];
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            acc_v[i][cc] = fmaf(pr[i], gv, acc_v[i][cc]);
            acc_k[i][cc] = fmaf(sr[i], qv, acc_k[i][cc]);
          }
        }
      }
    }
  }

  T* dkp = dk + ((long long)bkv * sk + k0) * D;
  T* dvp = dv + ((long long)bkv * sk + k0) * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    if (k0 + r >= sk) continue;
#pragma unroll
    for (int cc = 0; cc < kDc; ++cc) {
      const long long at = (long long)r * D + tx + kColThreads * cc;
      dkp[at] = from_float<T>(acc_k[i][cc] * scale);
      dvp[at] = from_float<T>(acc_v[i][cc]);
    }
  }
}

}  // namespace kv

// ------------------------------------------------------------ (c) dQ

namespace qd {

constexpr int kBQ = 64;                     // query rows per block
constexpr int kBK = 32;                     // keys per shared-memory tile
constexpr int kThreads = 128;
constexpr int kColThreads = 8;              // threads sharing one query row
constexpr int kRows = kBQ / (kThreads / kColThreads);   // 4 rows per thread
constexpr int kCols = kBK / kColThreads;                // 4 keys per thread
constexpr int kPld = kBK + 2;               // padded row stride of the ds tile

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * (size_t)kBQ * (D + 1) + 2 * (size_t)kBK * (D + 1) +
                          (size_t)kBQ * kPld + 2 * (size_t)kBQ);
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads)
kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
       const T* __restrict__ dout, const float* __restrict__ lse,
       const float* __restrict__ delta, T* __restrict__ dq, int h, int group, int sq, int sk,
       int causal, float scale) {
  constexpr int kLd = D + 1;
  constexpr int kDc = D / kColThreads;      // dQ columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                        // kBQ x kLd
  float* do_s = q_s + kBQ * kLd;            // kBQ x kLd
  float* k_s = do_s + kBQ * kLd;            // kBK x kLd
  float* v_s = k_s + kBK * kLd;             // kBK x kLd
  float* ds_s = v_s + kBK * kLd;            // kBQ x kPld
  float* lse_s = ds_s + kBQ * kPld;         // kBQ
  float* dl_s = lse_s + kBQ;                // kBQ

  const int bh = blockIdx.y;
  const int b = bh / h, hh = bh % h;
  const int h_kv = h / group;
  const long long q0 = (long long)(gridDim.x - 1 - blockIdx.x) * kBQ;
  const long long off = (long long)sk - sq;
  const T* qp = q + ((long long)bh * sq + q0) * D;
  const T* dop = dout + ((long long)bh * sq + q0) * D;
  const T* kp = k + (long long)(b * h_kv + hh / group) * sk * D;
  const T* vp = v + (long long)(b * h_kv + hh / group) * sk * D;
  const int tid = threadIdx.x;
  const int tx = tid % kColThreads, ty = tid / kColThreads;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const bool in = q0 + r < sq;
    q_s[r * kLd + c] = in ? to_float(qp[(long long)r * D + c]) : 0.f;
    do_s[r * kLd + c] = in ? to_float(dop[(long long)r * D + c]) : 0.f;
  }
  if (tid < kBQ) {
    const bool in = q0 + tid < sq;
    lse_s[tid] = in ? lse[(long long)bh * sq + q0 + tid] : INFINITY;
    dl_s[tid] = in ? delta[(long long)bh * sq + q0 + tid] : 0.f;
  }

  float acc[kRows][kDc];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < kDc; ++c) acc[i][c] = 0.f;

  long long kend = sk;
  if (causal) kend = min(kend, q0 + kBQ + off);   // past the block's last visible key
  for (long long k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();                        // the previous tile is consumed
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D;
      const bool in = k0 + r < sk;
      k_s[r * kLd + c] = in ? to_float(kp[(k0 + r) * D + c]) : 0.f;
      v_s[r * kLd + c] = in ? to_float(vp[(k0 + r) * D + c]) : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols], dp[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qr[kRows], gr[kRows], kr[kCols], vr[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        qr[i] = q_s[(ty * kRows + i) * kLd + d];
        gr[i] = do_s[(ty * kRows + i) * kLd + d];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        kr[j] = k_s[(tx + kColThreads * j) * kLd + d];
        vr[j] = v_s[(tx + kColThreads * j) * kLd + d];
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qr[i], kr[j], s[i][j]);
          dp[i][j] = fmaf(gr[i], vr[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty * kRows + i;
      const long long row = q0 + r;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const long long col = k0 + tx + kColThreads * j;
        const bool ok = col < sk && row < sq && (!causal || col <= row + off);
        const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        ds_s[r * kPld + tx + kColThreads * j] = p * (dp[i][j] - dl_s[r]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float sr[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) sr[i] = ds_s[(ty * kRows + i) * kPld + kk];
#pragma unroll
      for (int c = 0; c < kDc; ++c) {
        const float kval = k_s[kk * kLd + tx + kColThreads * c];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][c] = fmaf(sr[i], kval, acc[i][c]);
      }
    }
  }

  T* dqp = dq + ((long long)bh * sq + q0) * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    if (q0 + r >= sq) continue;
#pragma unroll
    for (int c = 0; c < kDc; ++c)
      dqp[(long long)r * D + tx + kColThreads * c] = from_float<T>(acc[i][c] * scale);
  }
}

}  // namespace qd

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const float* lse, const void* dout, float* delta, void* dq, void* dk,
                   void* dv, int b, int h, int h_kv, int sq, int sk, int causal, float scale,
                   cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* gt = static_cast<const T*>(dout);
  const int group = h / h_kv;
  cudaError_t e;
  const long long rows = (long long)b * h * sq;
  if (rows > 0) {
    delta_kernel<T><<<(unsigned)((rows + kDeltaRows - 1) / kDeltaRows), 32 * kDeltaRows, 0,
                      stream>>>(static_cast<const T*>(o), gt, delta, rows, D);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (sk > 0 && b > 0) {   // with sq = 0 every block writes zeros
    constexpr size_t smem = kv::smem_bytes<D>();
    e = cudaFuncSetAttribute(kv::kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    dim3 grid((unsigned)((sk + kv::kBK - 1) / kv::kBK), (unsigned)(b * h_kv));
    kv::kernel<D, T><<<grid, kv::kThreads, smem, stream>>>(
        qt, kt, vt, gt, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), h, group, sq, sk,
        causal, scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (sq > 0 && b > 0) {   // with sk = 0 every block writes zeros
    constexpr size_t smem = qd::smem_bytes<D>();
    e = cudaFuncSetAttribute(qd::kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    dim3 grid((unsigned)((sq + qd::kBQ - 1) / qd::kBQ), (unsigned)(b * h));
    qd::kernel<D, T><<<grid, qd::kThreads, smem, stream>>>(
        qt, kt, vt, gt, lse, delta, static_cast<T*>(dq), h, group, sq, sk, causal, scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <int D>
cudaError_t launch_dtype(int dtype, const void* q, const void* k, const void* v, const void* o,
                         const float* lse, const void* dout, float* delta, void* dq, void* dk,
                         void* dv, int b, int h, int h_kv, int sq, int sk, int causal,
                         float scale, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch<D, float>(q, k, v, o, lse, dout, delta, dq, dk, dv, b, h, h_kv, sq, sk,
                              causal, scale, stream);
    case 1:
      return launch<D, __nv_bfloat16>(q, k, v, o, lse, dout, delta, dq, dk, dv, b, h, h_kv,
                                      sq, sk, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout, dq: (b, h, sq, d); k, v, dk, dv: (b, h_kv, sk, d); all contiguous
// and of one dtype, 0 = float32 or 1 = bfloat16.  lse: float32 (b, h, sq) from
// the forward; delta: float32 (b, h, sq) scratch.  d must be 64 or 128, h a
// multiple of h_kv.  Returns the first launch error, else cudaSuccess.
extern "C" int flash_attention_bwd_launch(int device, const void* q, const void* k,
                                          const void* v, const void* o, const void* lse,
                                          const void* dout, void* delta, void* dq, void* dk,
                                          void* dv, int b, int h, int h_kv, int sq, int sk,
                                          int d, int causal, float scale, int dtype,
                                          void* stream) {
  if (h_kv <= 0 || h % h_kv != 0 || (d != 64 && d != 128)) return cudaErrorInvalidValue;
  DeviceGuard guard(device);  // the caller's device is current again on return
  if (guard.err != cudaSuccess) return guard.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  return d == 128
             ? launch_dtype<128>(dtype, q, k, v, o, l, dout, dl, dq, dk, dv, b, h, h_kv, sq, sk,
                                 causal, scale, s)
             : launch_dtype<64>(dtype, q, k, v, o, l, dout, dl, dq, dk, dv, b, h, h_kv, sq, sk,
                                causal, scale, s);
}

extern "C" const char* flash_attention_bwd_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
