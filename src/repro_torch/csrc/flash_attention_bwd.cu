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
// Three kernels, launched in order on the caller's stream: (a) Delta, one
// warp per query row in float32; (b) dK/dV, a block per tile of keys that
// loops over the GQA group's query heads and the query tiles that see its
// keys; (c) dQ, a block per tile of query rows that walks the keys its rows
// see.  Why no atomics: a block owns its rows of dK and dV (b) or of dQ (c)
// and sums them in one fixed order, so two runs give the same bits and the
// shared K/V head is never repeated.  The price is that (c) recomputes S and
// dP: seven products per visible (query, key) pair where a backward needs
// five.
//
// Bound on Hopper: operations.  The five products do 10 D flops a visible
// pair, at most 989 TFLOP/s on the bf16 tensor cores; each input and
// gradient is read or written once, ~1,000 flops per byte at S = 4096.  At
// B = 2, H = 32, S = 4096, D = 128, causal that is 0.687 TFLOP, 0.695 ms;
// the seven products done are 0.962 TFLOP, 0.97 ms at peak.
//
// Two routes, chosen by dtype in flash_attention_bwd_launch:
//
// * bfloat16 (training): Hopper's tensor cores, the forward's machinery
//   (hopper.cuh).  (b) and (c) run 384 threads in three warpgroups:
//   warpgroup 2 is the producer (setmaxnreg 24), one of its threads issues
//   every TMA load; warpgroups 0 and 1 are the consumers (setmaxnreg 240),
//   64 rows each.  The tensor maps are 3-D per head plane, (D, S, B*H), so a
//   ragged tile is zero-filled, not read from the next head; 128-byte
//   swizzle, boxes of 64 columns x 128 rows for the tiles a block keeps and
//   64 x 64 for the ones it streams through a ring of two stages, each with
//   a full and an empty mbarrier.  A consumer arrives on a stage's empty
//   barrier only after its wgmmas on that stage have retired.
//   (b) grid (B*H_kv, ceil(S_k/128)), small key tiles first (with causal
//       masking those see the most query rows).  The producer loads the
//       block's 128 keys of K and V once, then streams Q and dO tiles of 64
//       rows over the group's heads and, within each, the tiles from row
//       k0 - (S_k - S_q) on.  Per stage a consumer (64 keys) issues
//         S^T = K Q^T and dP^T = V dO^T   m64n64k16, both operands shared,
//                                          K-major;
//       meanwhile it loads the tile's 64 lse (times log2 e) and Delta into
//       shared memory with plain loads (a ragged S_q need not start a head's
//       slice on 16 bytes, which TMA wants); then P = exp2(S^T scale log2 e
//       - lse log2 e) and dS = P o (dP - Delta) in float32, masked only on
//       tiles that cross the causal diagonal, both rounded to bf16 and
//       packed from the accumulator into wgmma A fragments; then
//         dV += P^T dO and dK += dS^T Q   m64nDk16, A from registers, B the
//                                          stage read through the MN-major
//                                          descriptor.
//       A stage that no key of the warpgroup sees is skipped (it would add
//       exact zeros).  The epilogue scales dK, rounds both to bf16 once and
//       stores the rows below S_k.
//   (c) grid (B*H, ceil(S_q/128)), last query tile first.  The producer
//       loads the block's Q and dO once and streams K and V tiles of 64 keys;
//       a causal block stops at its last visible tile.  Per stage a consumer
//       (64 rows) issues S = Q K^T and dP = dO V^T (m64n64k16, shared,
//       K-major), forms dS as (b) does, masked on tiles that cross the
//       diagonal or the ragged end of S_k, and issues dQ += dS K with K read
//       through the MN-major descriptor of the same swizzled tile.  lse and
//       Delta of its two rows a thread are loaded once.
//
//   Precision.  bf16 products are exact in the float32 sums; P and dS are
//   rounded to bf16 before their products (no hi/lo split as the forward
//   needs: the gradients are held to a relative L2 error of 1e-2 against
//   the float32 result, chip_smoke.BWD_BF16_REL); Delta comes from the
//   forward's bf16 output; the gradients are rounded to bf16 once.  The
//   arithmetic emulated on the CPU (tests/test_torch_attention_numerics.py:
//   bf16 randn inputs; GQA, ragged S, S_q > S_k, non-causal; D = 64 and 128)
//   is within 2.3e-3 to 2.5e-3 of the reference's float32 gradients in
//   relative L2, against 1.6e-3 to 2.0e-3 with P and dS in float32.
//
// * float32 (exactness checks, held to LM_TOL, which TF32 or bf16 products
//   would not meet): the CUDA cores.  (b) a 256-thread block per 64 keys x
//   b*H_kv stages K and V in shared memory once and keeps dK and dV in
//   registers (each thread 4 keys x D/16 columns of each), recomputing S^T
//   and dP^T (a 4 x 4 patch a thread) over the query tiles of 64 rows and
//   accumulating P^T dO and dS^T Q through shared memory; (c) a 128-thread
//   block per 64 query rows walks tiles of 32 keys and keeps dQ in
//   registers.  Shared-memory rows are padded by one float so that no read
//   of a thread's patch conflicts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "device_guard.cuh"  // restores the caller's current device
#include "hopper.cuh"        // mbarrier, TMA, wgmma and tensor-map helpers

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

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

template <int D>
__global__ void __launch_bounds__(kThreads)
kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
       const float* __restrict__ dout, const float* __restrict__ lse,
       const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv, int h,
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

  const float* kp = k + ((long long)bkv * sk + k0) * D;
  const float* vp = v + ((long long)bkv * sk + k0) * D;
  for (int e = tid; e < kBK * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const bool in = k0 + r < sk;
    k_s[r * kLd + c] = in ? kp[(long long)r * D + c] : 0.f;
    v_s[r * kLd + c] = in ? vp[(long long)r * D + c] : 0.f;
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
    const float* qp = q + bh * sq * D;
    const float* dop = dout + bh * sq * D;
    for (long long q0 = qstart; q0 < sq; q0 += kBQ) {
      __syncthreads();                      // the previous tile is consumed
      for (int e = tid; e < kBQ * D; e += kThreads) {
        const int r = e / D, c = e % D;
        const bool in = q0 + r < sq;
        q_s[r * kLd + c] = in ? qp[(q0 + r) * D + c] : 0.f;
        do_s[r * kLd + c] = in ? dop[(q0 + r) * D + c] : 0.f;
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

  float* dkp = dk + ((long long)bkv * sk + k0) * D;
  float* dvp = dv + ((long long)bkv * sk + k0) * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    if (k0 + r >= sk) continue;
#pragma unroll
    for (int cc = 0; cc < kDc; ++cc) {
      const long long at = (long long)r * D + tx + kColThreads * cc;
      dkp[at] = acc_k[i][cc] * scale;
      dvp[at] = acc_v[i][cc];
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

template <int D>
__global__ void __launch_bounds__(kThreads)
kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
       const float* __restrict__ dout, const float* __restrict__ lse,
       const float* __restrict__ delta, float* __restrict__ dq, int h, int group, int sq, int sk,
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
  const float* qp = q + ((long long)bh * sq + q0) * D;
  const float* dop = dout + ((long long)bh * sq + q0) * D;
  const float* kp = k + (long long)(b * h_kv + hh / group) * sk * D;
  const float* vp = v + (long long)(b * h_kv + hh / group) * sk * D;
  const int tid = threadIdx.x;
  const int tx = tid % kColThreads, ty = tid / kColThreads;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const bool in = q0 + r < sq;
    q_s[r * kLd + c] = in ? qp[(long long)r * D + c] : 0.f;
    do_s[r * kLd + c] = in ? dop[(long long)r * D + c] : 0.f;
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
      k_s[r * kLd + c] = in ? kp[(k0 + r) * D + c] : 0.f;
      v_s[r * kLd + c] = in ? vp[(k0 + r) * D + c] : 0.f;
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

  float* dqp = dq + ((long long)bh * sq + q0) * D;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty * kRows + i;
    if (q0 + r >= sq) continue;
#pragma unroll
    for (int c = 0; c < kDc; ++c)
      dqp[(long long)r * D + tx + kColThreads * c] = acc[i][c] * scale;
  }
}

}  // namespace qd

template <typename T>
cudaError_t launch_delta(const void* o, const void* dout, float* delta, long long rows, int d,
                        cudaStream_t stream) {
  if (rows == 0) return cudaSuccess;
  delta_kernel<T><<<(unsigned)((rows + kDeltaRows - 1) / kDeltaRows), 32 * kDeltaRows, 0,
                    stream>>>(static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows,
                              d);
  return cudaGetLastError();
}

template <int D>
cudaError_t f32_launch(const void* q, const void* k, const void* v, const void* o,
                       const float* lse, const void* dout, float* delta, void* dq, void* dk,
                       void* dv, int b, int h, int h_kv, int sq, int sk, int causal, float scale,
                       cudaStream_t stream) {
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* gt = static_cast<const float*>(dout);
  const int group = h / h_kv;
  cudaError_t e = launch_delta<float>(o, dout, delta, (long long)b * h * sq, D, stream);
  if (e != cudaSuccess) return e;
  if (sk > 0 && b > 0) {   // with sq = 0 every block writes zeros
    constexpr size_t smem = kv::smem_bytes<D>();
    e = cudaFuncSetAttribute(kv::kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    dim3 grid((unsigned)((sk + kv::kBK - 1) / kv::kBK), (unsigned)(b * h_kv));
    kv::kernel<D><<<grid, kv::kThreads, smem, stream>>>(
        qt, kt, vt, gt, lse, delta, static_cast<float*>(dk), static_cast<float*>(dv), h, group,
        sq, sk, causal, scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  if (sq > 0 && b > 0) {   // with sk = 0 every block writes zeros
    constexpr size_t smem = qd::smem_bytes<D>();
    e = cudaFuncSetAttribute(qd::kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    dim3 grid((unsigned)((sq + qd::kBQ - 1) / qd::kBQ), (unsigned)(b * h));
    qd::kernel<D><<<grid, qd::kThreads, smem, stream>>>(
        qt, kt, vt, gt, lse, delta, static_cast<float*>(dq), h, group, sq, sk, causal, scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// ------------------------------------------------------------ bfloat16: tensor cores

namespace tc {

using namespace hopper;

constexpr int kThreads = 384;               // consumer warpgroups 0 and 1, producer 2
constexpr int kConsumerWarps = 8;           // arrivals that free a stage
constexpr int kStages = 2;                  // streamed tiles in flight
constexpr int kBig = 128;                   // rows of a tile a block keeps (K, V in (b); Q, dO in (c))
constexpr int kSmall = 64;                  // rows of a streamed tile (Q, dO in (b); K, V in (c))
constexpr int kBigPanel = kBig * 128;       // bytes of 128 rows x 64 bf16 columns
constexpr int kSmallPanel = kSmall * 128;   // bytes of 64 rows x 64 bf16 columns
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of (b) and (c), from a 1024-byte aligned base: the block's
// two kept tiles, each D/64 panels of 128 rows x 128 bytes (128-byte
// swizzle within each 1024-byte group of 8 rows), then kStages stages of
// two streamed tiles of D/64 panels of 64 rows, then (b)'s lse and Delta
// of a query tile, two buffers of 2 x 64 floats per consumer warpgroup,
// then the barriers: kept_full, full[kStages], empty[kStages].
template <int D>
struct Smem {
  static constexpr int kKept = (D / 64) * kBigPanel;
  static constexpr int kStage = (D / 64) * kSmallPanel;
  static constexpr int kStream = 2 * kKept;
  static constexpr int kRows = kStream + kStages * 2 * kStage;
  static constexpr int kBar = kRows + 2 * 2 * 2 * kSmall * 4;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;   // + alignment slack
};

// The mbarriers at the end of Smem: the kept tiles' one, then each stage's full and empty.
struct Bars {
  uint32_t kept;
  __device__ uint32_t full(int s) const { return kept + 8 * (1 + s); }
  __device__ uint32_t empty(int s) const { return kept + 8 * (1 + kStages + s); }
};

__device__ __forceinline__ void init_bars(const Bars& bars) {
  if (threadIdx.x == 0) {
    bar_init(bars.kept, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(bars.full(s), 1);
      bar_init(bars.empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
}

// The 128 threads of consumer warpgroup `wg` (named barrier 1 + wg; 0 is __syncthreads).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// The producer's loads of a kept tile (box 64 x 128) or a stage's tile (64 x 64).
template <int D, int kRowsBox>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int row, int head) {
#pragma unroll
  for (int p = 0; p < D / 64; ++p)
    tma_load(dst + p * kRowsBox * 128, map, bar, 64 * p, row, head);
}

// acc (m64 x n64) (+)= A B^T over D: A the warpgroup's 64 rows of a kept
// tile, B a stage's 64-row tile, both K-major (steps of 16 columns are 32
// bytes inside a swizzled row; past 64 columns, the next panel).
template <int D>
__device__ __forceinline__ void mma_kept_stage(float (&acc)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    mma_ss_n64(acc, desc(a + (ks / 4) * kBigPanel + (ks % 4) * 32, 16),
               desc(b + (ks / 4) * kSmallPanel + (ks % 4) * 32, 16), ks > 0);
}

// acc (m64 x nD) += A B over 64 rows of B: A packed bf16 fragments of an
// m64 x n64 accumulator, B a stage's 64-row tile read MN-major (16 rows are
// 2048 bytes; the D/64 panels are kSmallPanel apart).
template <int D>
__device__ __forceinline__ void mma_regs_stage(float (&acc)[D / 2], const uint32_t (&a)[16],
                                               uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kSmall / 16; ++kk)
    mma_rs<D>(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
              desc(b + kk * 2048, kSmallPanel));
}

// The rows of an m64 x nD accumulator that lie below `limit`, times
// `scale`, rounded to bf16 and stored: element 4j + 2r + e of a thread is
// row `row_lo + 8 r`, column 8j + c_lane + e.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, const float (&acc)[D / 2],
                                           int row_lo, int limit, int c_lane, float scale) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row >= limit) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(out + (long long)row * D + 8 * j + c_lane) =
          pack_bf16(acc[4 * j + 2 * r] * scale, acc[4 * j + 2 * r + 1] * scale);
  }
}

// (b) dK, dV: a block per (tile of 128 keys, b * H_kv).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
            const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
            const float* __restrict__ lse, const float* __restrict__ delta,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int h, int group,
            int sq, int sk, int causal, float scale, float scale_log2) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t k_s = base, v_s = base + L::kKept;
  auto q_s = [&](int s) { return base + L::kStream + s * 2 * L::kStage; };
  auto do_s = [&](int s) { return q_s(s) + L::kStage; };
  const Bars bars{base + L::kBar};

  const int bkv = blockIdx.x;                 // b * H_kv + K/V head
  const int b = bkv / (h / group), hk = bkv % (h / group);
  const int k0 = blockIdx.y * kBig;
  const long long off = (long long)sk - sq;  // row i sees keys j <= i + off
  // the first query tile with a row that sees key k0
  long long qstart = causal ? max(0LL, k0 - off) : 0LL;
  qstart -= qstart % kSmall;
  const int ntiles = qstart < sq ? (int)((sq - qstart + kSmall - 1) / kSmall) : 0;
  const int nt = group * ntiles;              // stages: (head of the group, query tile)
  const int wg = threadIdx.x / 128;
  init_bars(bars);

  if (wg == 2) {
    // ---- producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      bar_expect_tx(bars.kept, 2 * L::kKept);
      load_tile<D, kBig>(k_s, &tm_k, bars.kept, k0, bkv);
      load_tile<D, kBig>(v_s, &tm_v, bars.kept, k0, bkv);
      for (int t = 0; t < nt; ++t) {
        const int s = t % kStages;
        const int bh = b * h + hk * group + t / ntiles;
        const int q0 = (int)qstart + (t % ntiles) * kSmall;
        bar_wait(bars.empty(s), ((t / kStages) & 1) ^ 1);
        bar_expect_tx(bars.full(s), 2 * L::kStage);
        load_tile<D, kSmall>(q_s(s), &tm_q, bars.full(s), q0, bh);
        load_tile<D, kSmall>(do_s(s), &tm_do, bars.full(s), q0, bh);
      }
    }
  } else {
    // ---- consumers: 64 keys each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int kw = k0 + 64 * wg;              // this warpgroup's first key
    // accumulator layout of wgmma m64nN: element 4j + e of a thread lies in
    // row key_lo + 8 * (e / 2), column 8j + c_lane + e % 2
    const int key_lo = kw + 16 * warp + lane / 4;
    const int c_lane = 2 * (lane % 4);
    const uint32_t k_wg = k_s + wg * 64 * 128, v_wg = v_s + wg * 64 * 128;
    // this warpgroup's two buffers of a query tile's lse * log2(e) and Delta
    float* rows = reinterpret_cast<float*>(smem_raw + (base - raw) + L::kRows) + wg * 4 * kSmall;

    float acc_k[D / 2], acc_v[D / 2], st[32], dpt[32];
    uint32_t p_t[16], ds_t[16];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;

    bar_wait(bars.kept, 0);
    int n = 0;                                // stages computed: picks the buffer
    for (int t = 0; t < nt; ++t) {
      const int s = t % kStages;
      const long long bh = (long long)b * h + hk * group + t / ntiles;
      const int q0 = (int)qstart + (t % ntiles) * kSmall;
      bar_wait(bars.full(s), (t / kStages) & 1);
      if (!causal || kw <= q0 + kSmall - 1 + off) {   // else no key of ours is seen: zeros
        // S^T = K Q^T and dP^T = V dO^T
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
        mma_kept_stage<D>(st, k_wg, q_s(s));
        mma_kept_stage<D>(dpt, v_wg, do_s(s));
        wgmma_commit();
        // meanwhile the tile's lse (log2 units; +inf past S_q) and Delta
        float* buf = rows + (n & 1) * 2 * kSmall;
        const int row = q0 + tid % kSmall;
        if (tid < kSmall) buf[tid] = row < sq ? lse[bh * sq + row] * kLog2e : INFINITY;
        else buf[tid] = row < sq ? delta[bh * sq + row] : 0.f;
        warpgroup_sync(wg);
        ++n;
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);

        // P and dS in float32, rounded to bf16 as the A fragments of P^T, dS^T
        const bool masked = causal && kw + 63 > q0 + off;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 l2 = *reinterpret_cast<const float2*>(buf + 8 * j + c_lane);
          const float2 dl = *reinterpret_cast<const float2*>(buf + kSmall + 8 * j + c_lane);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * j + e;
            float p = exp2f(fmaf(st[i], scale_log2, -(e % 2 ? l2.y : l2.x)));
            if (masked && key_lo + 8 * (e / 2) > q0 + 8 * j + c_lane + e % 2 + off) p = 0.f;
            dpt[i] = p * (dpt[i] - (e % 2 ? dl.y : dl.x));
            st[i] = p;
          }
        }
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          p_t[u] = pack_bf16(st[2 * u], st[2 * u + 1]);
          ds_t[u] = pack_bf16(dpt[2 * u], dpt[2 * u + 1]);
        }

        // dV += P^T dO and dK += dS^T Q
        fence_regs(acc_k);
        fence_regs(acc_v);
        fence_regs(p_t);
        fence_regs(ds_t);
        wgmma_fence();
        mma_regs_stage<D>(acc_v, p_t, do_s(s));
        mma_regs_stage<D>(acc_k, ds_t, q_s(s));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc_k);
        fence_regs(acc_v);
        fence_regs(p_t);
        fence_regs(ds_t);
      }
      __syncwarp();
      if (lane == 0) bar_arrive(bars.empty(s));
    }

    const long long at = (long long)bkv * sk;
    store_rows<D>(dk + at * D, acc_k, key_lo, sk, c_lane, scale);
    store_rows<D>(dv + at * D, acc_v, key_lo, sk, c_lane, 1.f);
  }
}

// (c) dQ: a block per (tile of 128 query rows, b * H).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
          const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
          const float* __restrict__ lse, const float* __restrict__ delta,
          __nv_bfloat16* __restrict__ dq, int h, int group, int sq, int sk, int causal,
          float scale, float scale_log2) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base, do_s = base + L::kKept;
  auto k_s = [&](int s) { return base + L::kStream + s * 2 * L::kStage; };
  auto v_s = [&](int s) { return k_s(s) + L::kStage; };
  const Bars bars{base + L::kBar};

  const int bh = blockIdx.x;
  const int bkv = (bh / h) * (h / group) + (bh % h) / group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBig;   // the longest causal blocks first
  const long long off = (long long)sk - sq;
  long long kend = sk;
  if (causal) kend = min(kend, q0 + kBig + off);        // past the block's last visible key
  const int nk = kend > 0 ? (int)((kend + kSmall - 1) / kSmall) : 0;
  const int wg = threadIdx.x / 128;
  init_bars(bars);

  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      bar_expect_tx(bars.kept, 2 * L::kKept);
      load_tile<D, kBig>(q_s, &tm_q, bars.kept, q0, bh);
      load_tile<D, kBig>(do_s, &tm_do, bars.kept, q0, bh);
      for (int t = 0; t < nk; ++t) {
        const int s = t % kStages;
        bar_wait(bars.empty(s), ((t / kStages) & 1) ^ 1);
        bar_expect_tx(bars.full(s), 2 * L::kStage);
        load_tile<D, kSmall>(k_s(s), &tm_k, bars.full(s), t * kSmall, bkv);
        load_tile<D, kSmall>(v_s(s), &tm_v, bars.full(s), t * kSmall, bkv);
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int row_first = q0 + 64 * wg;
    const int r_lo = row_first + 16 * warp + lane / 4;
    const int c_lane = 2 * (lane % 4);
    const uint32_t q_wg = q_s + wg * 64 * 128, do_wg = do_s + wg * 64 * 128;

    float l2[2], dl[2];                       // this thread's two rows' lse * log2(e), Delta
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r_lo + 8 * r;
      l2[r] = row < sq ? lse[(long long)bh * sq + row] * kLog2e : INFINITY;
      dl[r] = row < sq ? delta[(long long)bh * sq + row] : 0.f;
    }
    float acc[D / 2], sc[32], dp[32];
    uint32_t ds[16];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    bar_wait(bars.kept, 0);
    for (int t = 0; t < nk; ++t) {
      const int s = t % kStages;
      const int k0 = t * kSmall;
      bar_wait(bars.full(s), (t / kStages) & 1);
      if (!causal || k0 <= row_first + 63 + off) {   // else none of our rows sees these keys
        // S = Q K^T and dP = dO V^T
        fence_regs(sc);
        fence_regs(dp);
        wgmma_fence();
        mma_kept_stage<D>(sc, q_wg, k_s(s));
        mma_kept_stage<D>(dp, do_wg, v_s(s));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);

        const bool masked = k0 + kSmall > sk || (causal && k0 + kSmall - 1 > row_first + off);
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i % 4) / 2;
          float p = exp2f(fmaf(sc[i], scale_log2, -l2[r]));
          if (masked) {
            const int col = k0 + 8 * (i / 4) + c_lane + i % 2;
            if (col >= sk || (causal && col > r_lo + 8 * r + off)) p = 0.f;
          }
          dp[i] = p * (dp[i] - dl[r]);
        }
#pragma unroll
        for (int u = 0; u < 16; ++u) ds[u] = pack_bf16(dp[2 * u], dp[2 * u + 1]);

        // dQ += dS K, K read through the MN-major descriptor
        fence_regs(acc);
        fence_regs(ds);
        wgmma_fence();
        mma_regs_stage<D>(acc, ds, k_s(s));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(ds);
      }
      __syncwarp();
      if (lane == 0) bar_arrive(bars.empty(s));
    }
    store_rows<D>(dq + (long long)bh * sq * D, acc, r_lo, sq, c_lane, scale);
  }
}

// A 3-D map (D, rows, heads) of a contiguous (heads, rows, D) bf16 tensor,
// read in boxes of 64 columns x `box_rows` rows with 128-byte swizzle; rows
// past the end of a head are zero-filled.
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int d, int rows, int heads,
                       int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)heads};
  return tensor_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, dims, (cuuint64_t)d * 2,
                       (cuuint64_t)d * 2 * rows, 64, (cuuint32_t)box_rows);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const float* lse, const void* dout, float* delta, void* dq, void* dk,
                   void* dv, int b, int h, int h_kv, int sq, int sk, int causal, float scale,
                   cudaStream_t stream) {
  const size_t elem = sizeof(__nv_bfloat16);
  if (b == 0 || sq == 0 || sk == 0) {   // no (query, key) pair: every gradient is 0
    cudaError_t e = cudaMemsetAsync(dq, 0, (size_t)b * h * sq * D * elem, stream);
    if (e == cudaSuccess) e = cudaMemsetAsync(dk, 0, (size_t)b * h_kv * sk * D * elem, stream);
    if (e == cudaSuccess) e = cudaMemsetAsync(dv, 0, (size_t)b * h_kv * sk * D * elem, stream);
    return e;
  }
  cudaError_t e = launch_delta<__nv_bfloat16>(o, dout, delta, (long long)b * h * sq, D, stream);
  if (e != cudaSuccess) return e;
  CUtensorMap k_big, v_big, q_small, do_small, q_big, do_big, k_small, v_small;
  if ((e = tensor_map(&k_big, k, D, sk, b * h_kv, kBig)) != cudaSuccess) return e;
  if ((e = tensor_map(&v_big, v, D, sk, b * h_kv, kBig)) != cudaSuccess) return e;
  if ((e = tensor_map(&q_small, q, D, sq, b * h, kSmall)) != cudaSuccess) return e;
  if ((e = tensor_map(&do_small, dout, D, sq, b * h, kSmall)) != cudaSuccess) return e;
  if ((e = tensor_map(&q_big, q, D, sq, b * h, kBig)) != cudaSuccess) return e;
  if ((e = tensor_map(&do_big, dout, D, sq, b * h, kBig)) != cudaSuccess) return e;
  if ((e = tensor_map(&k_small, k, D, sk, b * h_kv, kSmall)) != cudaSuccess) return e;
  if ((e = tensor_map(&v_small, v, D, sk, b * h_kv, kSmall)) != cudaSuccess) return e;
  constexpr int smem = Smem<D>::kBytes;
  const int group = h / h_kv;
  const float scale_log2 = scale * kLog2e;
  e = cudaFuncSetAttribute(dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dkdv_kernel<D><<<dim3((unsigned)(b * h_kv), (unsigned)((sk + kBig - 1) / kBig)), kThreads,
                   smem, stream>>>(k_big, v_big, q_small, do_small, lse, delta,
                                   static_cast<__nv_bfloat16*>(dk),
                                   static_cast<__nv_bfloat16*>(dv), h, group, sq, sk, causal,
                                   scale, scale_log2);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  e = cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dq_kernel<D><<<dim3((unsigned)(b * h), (unsigned)((sq + kBig - 1) / kBig)), kThreads, smem,
                 stream>>>(q_big, do_big, k_small, v_small, lse, delta,
                           static_cast<__nv_bfloat16*>(dq), h, group, sq, sk, causal, scale,
                           scale_log2);
  return cudaGetLastError();
}

}  // namespace tc

template <int D>
cudaError_t launch_dtype(int dtype, const void* q, const void* k, const void* v, const void* o,
                         const float* lse, const void* dout, float* delta, void* dq, void* dk,
                         void* dv, int b, int h, int h_kv, int sq, int sk, int causal,
                         float scale, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return f32_launch<D>(q, k, v, o, lse, dout, delta, dq, dk, dv, b, h, h_kv, sq, sk,
                           causal, scale, stream);
    case 1:
      return tc::launch<D>(q, k, v, o, lse, dout, delta, dq, dk, dv, b, h, h_kv, sq, sk,
                           causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout, dq: (b, h, sq, d); k, v, dk, dv: (b, h_kv, sk, d); all contiguous
// and of one dtype, 0 = float32 (CUDA cores) or 1 = bfloat16 (tensor cores;
// q, k, v and dout 16-byte aligned for TMA).  lse: float32 (b, h, sq) from
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
