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
// Masked scores are -1e30; a row with no visible key gets l = 0 and writes
// 0 (acc / max(l, 1e-30)).  Ragged S_q and S_k are masked here (the Pallas
// kernel asserted S % 128 == 0).
//
// With a non-null `lse` (the training forward, which saves it for the backward
// in flash_attention_bwd.cu) each row's natural-log log-sum-exp of its scaled
// scores is written as float32 (B, H, S_q), +inf for a row with no visible key;
// a null `lse` (prefill, serving) writes nothing more.
//
// Bound on Hopper: operations.  The two products do 4*D flops for every
// visible (query, key) pair, at most 989 TFLOP/s on the bf16 tensor cores,
// and each q/k/v/o element is read or written once, so at the LM's shapes
// (S = 4096, D = 128) there are ~1,600 flops per byte -- far above the
// ~295 at which the tensor cores outrun device memory.
//
// Two routes, chosen by dtype in flash_attention_launch:
//
// * bfloat16 (the LM's prefill): Hopper's tensor cores.  Grid (ceil(S_q/128),
//   B*H), issued last query tile first so that the longest causal blocks
//   start early; 384 threads in three warpgroups.  Warpgroup 2 is the
//   producer: it gives up registers (setmaxnreg 24) and one thread issues
//   every TMA load -- Q once, then K and V tiles of 128 keys through a
//   ring of two shared-memory stages with a full and an empty mbarrier
//   each.  The tensor maps are 3-D, (D, S, B*H) for q and (D, S_k, B*H_kv)
//   for k and v, so a ragged tile at the end of one head is zero-filled by
//   the hardware instead of reading the next head's rows; 128-byte swizzle,
//   boxes of 64 columns x 128 rows.  Warpgroups 0 and 1 are the consumers
//   (setmaxnreg 240), 64 query rows each.  Per K/V tile a consumer
//     - computes S = Q K^T with wgmma m64n128k16 (both operands in shared
//       memory, bf16 products exact in the float32 sums);
//     - scales S in float32 by scale * log2(e) (q is not pre-scaled: q *
//       scale rounded to bf16 would add error), masks it only on tiles
//       that cross the causal diagonal or the ragged end, and runs the
//       online softmax on exp2, the row max reduced over the four threads
//       that share a row of the wgmma accumulator;
//     - splits P in registers into P_hi = bf16(P) and P_lo = bf16(P - P_hi)
//       and issues O += P_hi V and O += P_lo V as register-A wgmmas that
//       read the V stage through the transposed (MN-major) descriptor;
//     - arrives on the stage's empty barrier only after both have retired.
//   A causal block stops at its last visible K tile.  The epilogue divides
//   by max(l, 1e-30), rounds to bf16 and stores the rows below S_q.
//
//   Why P is split.  The check this kernel is held to is |out - want| <=
//   1e-4 + 2^-8 |want| against the float32 plain version: the output's own
//   bf16 rounding plus 1e-4.  Emulated on the CPU (bf16 randn q, k, v,
//   B=1, H=8, S=2048, D=128, causal; exact bf16 products summed in float32;
//   P rounded as named before the PV product; output rounded to bf16), the
//   largest share of that limit used is 0.960 with P in float32, 12.1 with
//   P as one bf16 term (4.0 even on rows 512-2048), 1.67 with P in fp16,
//   and 0.960 with P_hi + P_lo.  The split costs one more wgmma on the PV
//   product (1.5x the tensor-core work) and no shared-memory traffic: both
//   terms are A operands taken from registers.
//
// * float32 (exactness checks only; TF32 or bf16 products would not meet
//   their 2e-4): the CUDA cores.  Grid (ceil(S_q/64), B*H), 128 threads; a
//   block stages its 64 query rows once in shared memory (scaled), then
//   walks the keys in tiles of 32 rows; each thread computes a 4x4 patch
//   of the 64x32 score tile, row max and sum are reduced over the 8
//   threads that share a row with __shfl_xor_sync, the probabilities go
//   through shared memory, and each thread accumulates 4 rows x D/8 output
//   columns in registers.  Row strides are padded so that no shared-memory
//   read conflicts.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "device_guard.cuh"  // restores the caller's current device
#include <stdint.h>

#include "hopper.cuh"     // mbarrier, TMA, wgmma and tensor-map helpers

namespace {

constexpr float kNeg = -1e30f;

__global__ void fill_inf_kernel(float* p, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) p[i] = INFINITY;
}

cudaError_t fill_inf(float* p, long long n, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  fill_inf_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(p, n);
  return cudaGetLastError();
}

// ------------------------------------------------------------ float32: CUDA cores

namespace f32 {

constexpr int kBQ = 64;                     // query rows per block
constexpr int kBK = 32;                     // key rows per shared-memory tile
constexpr int kThreads = 128;
constexpr int kColThreads = 8;              // threads sharing one score row
constexpr int kRows = kBQ / (kThreads / kColThreads);   // 4 rows per thread
constexpr int kCols = kBK / kColThreads;                // 4 score columns per thread
constexpr int kPld = kBK + 2;               // padded row stride of the p tile

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * (D + 1) + (size_t)kBK * (D + 1) +
                          (size_t)kBK * D + (size_t)kBQ * kPld);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
       float* __restrict__ o, float* __restrict__ lse, int h, int group, int sq, int sk,
       int causal, float scale) {
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
  const float* qp = q + ((long long)bh * sq + q0) * D;
  const float* kp = k + (long long)(b * h_kv + hh / group) * sk * D;
  const float* vp = v + (long long)(b * h_kv + hh / group) * sk * D;
  float* op = o + ((long long)bh * sq + q0) * D;

  const int tid = threadIdx.x;
  const int tx = tid % kColThreads, ty = tid / kColThreads;
  const long long off = (long long)sk - sq;  // row i sees keys j <= i + off

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D;
    q_s[r * kLd + c] = q0 + r < sq ? qp[(long long)r * D + c] * scale : 0.f;
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
      k_s[r * kLd + c] = in ? kp[(k0 + r) * D + c] : 0.f;
      v_s[r * D + c] = in ? vp[(k0 + r) * D + c] : 0.f;
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
    for (int c = 0; c < kDc; ++c) op[(long long)r * D + tx + kColThreads * c] = acc[i][c] / den;
    // m is in natural units here (q was scaled), l the full row sum
    if (lse != nullptr && tx == 0)
      lse[(long long)bh * sq + q0 + r] = l[i] > 0.f ? m[i] + logf(l[i]) : INFINITY;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                   int h, int h_kv, int sq, int sk, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)((sq + kBQ - 1) / kBQ), (unsigned)(b * h));
  kernel<D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, h, h / h_kv, sq, sk, causal, scale);
  return cudaGetLastError();
}

}  // namespace f32

// ------------------------------------------------------------ bfloat16: tensor cores

namespace tc {

constexpr int kBQ = 128;                    // query rows per block, 64 per consumer warpgroup
constexpr int kBK = 128;                    // keys per K/V tile
constexpr int kStages = 2;                  // K/V tiles in flight
constexpr int kThreads = 384;               // consumer warpgroups 0 and 1, producer 2
constexpr int kConsumerWarps = 8;           // arrivals that free a stage
constexpr int kPanel = 128 * 128;           // bytes of 128 rows x 64 bf16 columns
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared memory, from a 1024-byte aligned base: Q, K[kStages], V[kStages],
// each a 128 x D tile stored as D/64 panels of 128 rows x 128 bytes (the
// TMA box; 128-byte swizzle within each 1024-byte group of 8 rows), then
// the barriers: q_full, full[kStages], empty[kStages].
template <int D>
struct Smem {
  static constexpr int kTile = (D / 64) * kPanel;
  static constexpr int kK = kTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;   // + alignment slack
};

using namespace hopper;

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
       const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
       float* __restrict__ lse, int h, int group, int sq, int sk, int causal,
       float scale_log2) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t q_full = base + L::kBar;
  auto k_s = [&](int s) { return base + L::kK + s * L::kTile; };
  auto v_s = [&](int s) { return base + L::kV + s * L::kTile; };
  auto full = [&](int s) { return q_full + 8 * (1 + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + kStages + s); };

  const int bh = blockIdx.y;
  const int bkv = (bh / h) * (h / group) + (bh % h) / group;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const long long off = (long long)sk - sq;     // row i sees keys j <= i + off
  long long kend = sk;
  if (causal) kend = min(kend, q0 + kBQ + off);  // past the block's last visible key
  const int nk = kend > 0 ? (int)((kend + kBK - 1) / kBK) : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    bar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      bar_init(full(s), 1);
      bar_init(empty(s), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 256) {
      bar_expect_tx(q_full, L::kTile);
      for (int p = 0; p < D / 64; ++p) tma_load(q_s + p * kPanel, &tm_q, q_full, 64 * p, q0, bh);
      for (int t = 0; t < nk; ++t) {
        const int s = t % kStages;
        bar_wait(empty(s), ((t / kStages) & 1) ^ 1);
        bar_expect_tx(full(s), 2 * L::kTile);
        for (int p = 0; p < D / 64; ++p) {
          tma_load(k_s(s) + p * kPanel, &tm_k, full(s), 64 * p, t * kBK, bkv);
          tma_load(v_s(s) + p * kPanel, &tm_v, full(s), 64 * p, t * kBK, bkv);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    // accumulator layout of wgmma m64nN: element 4j + e of a thread lies in
    // row r_lo + 8 * (e / 2), column 8j + 2 * (lane % 4) + e % 2
    const int r_lo = q0 + 64 * wg + 16 * warp + lane / 4;
    const int c_lane = 2 * (lane % 4);
    const uint32_t q_wg = q_s + wg * 64 * 128;   // this warpgroup's 64 rows of each panel
    const long long row_first = (long long)q0 + 64 * wg;

    float acc[D / 2], sc[64];
    uint32_t p_hi[32], p_lo[32];
    float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    bar_wait(q_full, 0);
    for (int t = 0; t < nk; ++t) {
      const int s = t % kStages;
      const int k0 = t * kBK;
      bar_wait(full(s), (t / kStages) & 1);

      // S = Q K^T over D in steps of 16 (32 bytes inside a swizzled row)
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t koff = (ks / 4) * kPanel + (ks % 4) * 32;
        mma_ss_n128(sc, desc(q_wg + koff, 16), desc(k_s(s) + koff, 16), ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      // online softmax in the exp2 domain; mask only tiles that need it
      const bool masked = k0 + kBK > sk || (causal && k0 + kBK - 1 > row_first + off);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        float x = sc[i] * scale_log2;
        if (masked) {
          const long long col = k0 + 8 * (i / 4) + c_lane + (i % 2);
          const long long row = r_lo + 8 * ((i % 4) / 2);
          if (col >= sk || (causal && col > row + off)) x = kNeg;
        }
        sc[i] = x;
        mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], x);
      }
      float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f(fminf(m[r] - mx[r], 0.f));
        m[r] = mx[r];
      }
      // P, its thread-partial row sums, and its split into two bf16 terms;
      // the pair (sc[2u], sc[2u+1]) is register u of the wgmma A fragment
#pragma unroll
      for (int u = 0; u < 32; ++u) {
        const int r = u % 2;
        float p0 = exp2f(sc[2 * u] - m[r]), p1 = exp2f(sc[2 * u + 1] - m[r]);
        if (masked) {
          p0 = sc[2 * u] > kNeg / 2 ? p0 : 0.f;
          p1 = sc[2 * u + 1] > kNeg / 2 ? p1 : 0.f;
        }
        sum[r] += p0 + p1;
        p_hi[u] = pack_bf16(p0, p1);
        p_lo[u] = pack_bf16(p0 - __uint_as_float(p_hi[u] << 16),
                            p1 - __uint_as_float(p_hi[u] & 0xffff0000u));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = alpha[r] * l[r] + sum[r];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i % 4) / 2];

      // O += P_hi V + P_lo V over the 128 keys in steps of 16 (2048 bytes)
      fence_regs(acc);
      fence_regs(p_hi);
      fence_regs(p_lo);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t b = desc(v_s(s) + kk * 2048, kPanel);
        mma_rs<D>(acc, p_hi[4 * kk], p_hi[4 * kk + 1], p_hi[4 * kk + 2], p_hi[4 * kk + 3], b);
        mma_rs<D>(acc, p_lo[4 * kk], p_lo[4 * kk + 1], p_lo[4 * kk + 2], p_lo[4 * kk + 3], b);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(p_hi);
      fence_regs(p_lo);
      __syncwarp();
      if (lane == 0) bar_arrive(empty(s));
    }

    // epilogue: the row sums over the four threads of a row, then O / l
    __nv_bfloat16* ob = o + (long long)bh * sq * D;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float den = fmaxf(l[r], 1e-30f);
      const int row = r_lo + 8 * r;
      // m is in the exp2 domain of the scaled scores: lse = (m + log2 l) ln 2
      if (lse != nullptr && row < sq && lane % 4 == 0)
        lse[(long long)bh * sq + row] = l[r] > 0.f ? (m[r] + log2f(l[r])) * kLn2 : INFINITY;
      if (row < sq) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          *reinterpret_cast<uint32_t*>(ob + (long long)row * D + 8 * j + c_lane) =
              pack_bf16(acc[4 * j + 2 * r] / den, acc[4 * j + 2 * r + 1] / den);
        }
      }
    }
  }
}

// A 3-D map (D, rows, heads) of a contiguous (heads, rows, D) bf16 tensor,
// read in boxes of 64 columns x 128 rows with 128-byte swizzle; rows past
// the end of a head are zero-filled.
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int d, int rows, int heads) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)heads};
  return tensor_map_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, dims, (cuuint64_t)d * 2,
                       (cuuint64_t)d * 2 * rows, 64, 128);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int b,
                   int h, int h_kv, int sq, int sk, int causal, float scale,
                   cudaStream_t stream) {
  if (sk == 0) {   // no key at all: every row is empty, writes 0 and has lse +inf
    if (lse != nullptr) {
      cudaError_t e = fill_inf(lse, (long long)b * h * sq, stream);
      if (e != cudaSuccess) return e;
    }
    return cudaMemsetAsync(o, 0, (size_t)b * h * sq * D * sizeof(__nv_bfloat16), stream);
  }
  CUtensorMap mq, mk, mv;
  cudaError_t e;
  if ((e = tensor_map(&mq, q, D, sq, b * h)) != cudaSuccess) return e;
  if ((e = tensor_map(&mk, k, D, sk, b * h_kv)) != cudaSuccess) return e;
  if ((e = tensor_map(&mv, v, D, sk, b * h_kv)) != cudaSuccess) return e;
  constexpr int smem = Smem<D>::kBytes;
  e = cudaFuncSetAttribute(kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((unsigned)((sq + kBQ - 1) / kBQ), (unsigned)(b * h));
  kernel<D><<<grid, kThreads, smem, stream>>>(mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse,
                                               h, h / h_kv, sq, sk, causal, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q, o: (b, h, sq, d); k, v: (b, h_kv, sk, d); all contiguous and of one
// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (tensor cores, all four
// 16-byte aligned for TMA).  d must be 64 or 128, h a multiple of h_kv.
// lse: null, or float32 (b, h, sq), written with each row's log-sum-exp.
extern "C" int flash_attention_launch(int device, const void* q, const void* k,
                                      const void* v, void* o, void* lse, int b, int h,
                                      int h_kv, int sq, int sk, int d, int causal,
                                      float scale, int dtype, void* stream) {
  if (h_kv <= 0 || h % h_kv != 0 || (d != 64 && d != 128)) return cudaErrorInvalidValue;
  DeviceGuard guard(device);  // the caller's device is current again on return
  if (guard.err != cudaSuccess) return guard.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  const bool wide = d == 128;
  switch (dtype) {
    case 0:
      return wide ? f32::launch<128>(q, k, v, o, l, b, h, h_kv, sq, sk, causal, scale, s)
                  : f32::launch<64>(q, k, v, o, l, b, h, h_kv, sq, sk, causal, scale, s);
    case 1:
      return wide ? tc::launch<128>(q, k, v, o, l, b, h, h_kv, sq, sk, causal, scale, s)
                  : tc::launch<64>(q, k, v, o, l, b, h, h_kv, sq, sk, causal, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* flash_attention_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
