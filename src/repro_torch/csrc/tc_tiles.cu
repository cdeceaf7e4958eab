// tc_tiles: triangle count of tile triples,
//   sum_b sum_{r,s} (A_ik[b] A_jk[b]^T)[r,s] * A_ij[b][r,s],
// where triple b = idx[b] = (ij, ik, jk) names three tiles of one batch
// and a triple whose ij entry is negative counts nothing.
//
// Replaces the Pallas kernel src/repro/kernels/tc_tile.py::tc_tiles
// (triangle counting's dense K_D path, src/repro/algorithms/tc.py:313).
//
// Contract: the tiles hold 0/1 values (what BlockStore.materialize_tiles
// builds), and tile n is zero at rows >= rows[n] and columns >= cols[n]
// (its block's rectangle in the padded T x T tile; no extents means the
// whole tile).  On 0/1 inputs the tensor cores are exact: 0 and 1 are
// exact in TF32 and bf16, and every wedge count C[r,s] <= T <= 2^12 is
// exact in the float32 accumulator.  The count is an exact int64.
//
// Bound on Hopper: the bytes of the block rectangles, or the products at
// the TF32 tensor-core rate (2 * cols[ik] flops per entry of A_ij),
// whichever is larger.  Whole padded tiles are T^3 products per triple;
// the rectangles are a few percent of that.
//
// Design, two kernels on one stream:
// 1. patch_masks: grid (nd, ceil(T/64)), 128 threads.  One block reads
//    rows [64 rp, 64 rp + 64) of one tile inside its rectangle, 16 bytes
//    a load where rows are 16-byte aligned, and writes a 64-bit mask of
//    the 64-column patches that hold an entry.  Every tile is read once
//    here, however many triples name it.
// 2. tc_tiles: grid B * ceil(T/64), 160 threads, the row patches of one
//    triple next to each other (they share its A_jk panels in L2); a
//    block owns the 64 rows [r0, r0+64) of one triple's output, inside
//    the box
//      r < R = min(rows[ij], rows[ik]),  s < S = min(cols[ij], rows[jk]),
//      c < C = min(cols[ik], cols[jk]),
//    and works only on the patches of A_ij's mask below S: a block with
//    r0 >= R or no such patch leaves at once, since nothing outside the
//    box or off A_ij's entries can count.  Along c it takes only the
//    64-wide slices below C where A_ik's mask for rows [r0, r0+64) and
//    A_jk's for rows [s0, s0+64) are both set: elsewhere every product is
//    zero.
//    * Warp 4 is the producer: one thread walks the live patches and, per
//      patch, the panels (128 bytes of c) of those slices, and issues two
//      TMA loads per panel -- A_ik rows [r0, r0+64) and A_jk rows [s0, s0+64),
//      128 bytes of c each, 128-byte swizzle, from one 3-D tensor map over
//      the (nd, T, T) tiles -- into a ring of shared-memory stages with a
//      full and an empty mbarrier each.  Rows and columns past T are
//      zero-filled by the hardware.
//    * Warps 0-3 are one consumer warpgroup.  Per panel, four wgmma
//      m64n64k8 (float32 tiles: TF32) or k16 (bf16 tiles) with both
//      operands K-major in shared memory accumulate the 64 x 64 wedge
//      counts in float32 registers; one panel's group stays in flight
//      while the next is issued, and a stage is released when its group
//      has retired.  Before a patch's products each thread loads the 32
//      entries of A_ij its accumulator elements meet (the fragment's
//      (row, col) map); after them it multiplies and sums as int64.
//    * The block's sum goes to one global 64-bit counter with one
//      atomicAdd: exact and independent of the order blocks run in (the
//      TPU kernel carried one float32 sum across its sequential grid,
//      exact only below 2^24).
// TMA needs a 16-byte aligned base and row stride (T*4 or T*2 bytes).
// Where those fail, the same kernel takes its second route: the consumer
// warpgroup copies each panel into the same swizzled layout itself, with
// 4-byte cp.async (plain loads for a bf16 pair that is not 4-byte
// aligned), zero-filling past T, one stage at a time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "device_guard.cuh"  // restores the caller's current device
#include <stdint.h>

#include "hopper.cuh"     // mbarrier, TMA, wgmma and tensor-map helpers

namespace {

using namespace hopper;

constexpr int kPatch = 64;                   // output rows and columns of one patch (m64n64)
constexpr int kOperand = kPatch * 128;       // one 64-row panel, 128 bytes along c: 8 KB
constexpr int kStages = 3;                   // panels in flight (TMA route)
constexpr int kConsumers = 128;              // warpgroup 0 runs the wgmmas
constexpr int kThreads = kConsumers + 32;    // + one producer warp
constexpr int kMaxT = 64 * kPatch;           // a patch mask is 64 bits
constexpr uint32_t kAll = 0xffffffffu;

template <typename T>
struct Elt;
template <>
struct Elt<float> {                          // TF32 wgmma, k8 per instruction
  static constexpr int kPanel = 32;          // elements along c of a 128-byte panel
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};
template <>
struct Elt<__nv_bfloat16> {                  // bf16 wgmma, k16 per instruction
  static constexpr int kPanel = 64;
  static constexpr CUtensorMapDataType kMap = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int extent(const int* ext, long long tile, int t) {
  return ext ? min(max(ext[tile], 0), t) : t;
}

// ------------------------------------------------------------ 1. patch masks

// masks[n * P + rp], P = ceil(T/64): bit p set when tile n holds an entry in
// rows [64 rp, 64 rp + 64) and columns [64 p, 64 p + 64) of its rectangle.
template <typename T, bool kVec>
__global__ void __launch_bounds__(128)
patch_masks_kernel(const T* __restrict__ tiles, const int* __restrict__ ext_rows,
                   const int* __restrict__ ext_cols, unsigned long long* __restrict__ masks,
                   int t) {
  __shared__ uint32_t part[4][2];
  const long long n = blockIdx.x;
  const int r0 = blockIdx.y * kPatch;
  const int rows_here = min(kPatch, extent(ext_rows, n, t) - r0);
  const int cols = extent(ext_cols, n, t);
  const T* tile = tiles + (size_t)n * t * t + (size_t)r0 * t;
  uint64_t found = 0;
  if constexpr (kVec) {
    // 16-byte loads, which never straddle a patch; one crossing `cols`
    // holds only zeros past it
    constexpr int kWidth = 16 / sizeof(T);
    const int chunks = (cols + kWidth - 1) / kWidth;
#pragma unroll 4
    for (int e = threadIdx.x; e < rows_here * chunks; e += 128) {
      const int r = e / chunks, c = e % chunks * kWidth;
      const uint4 v = *reinterpret_cast<const uint4*>(tile + (size_t)r * t + c);
      found |= (v.x | v.y | v.z | v.w) ? 1ull << (c / kPatch) : 0ull;
    }
  } else {
    for (int e = threadIdx.x; e < rows_here * cols; e += 128) {
      const int r = e / cols, c = e % cols;
      found |= to_f32(tile[(size_t)r * t + c]) != 0.f ? 1ull << (c / kPatch) : 0ull;
    }
  }
  const int warp = threadIdx.x / 32;
  const uint32_t lo = __reduce_or_sync(kAll, (uint32_t)found);
  const uint32_t hi = __reduce_or_sync(kAll, (uint32_t)(found >> 32));
  if (threadIdx.x % 32 == 0) {
    part[warp][0] = lo;
    part[warp][1] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t l = 0, h = 0;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      l |= part[w][0];
      h |= part[w][1];
    }
    masks[n * gridDim.y + blockIdx.y] = ((unsigned long long)h << 32) | l;
  }
}

// ------------------------------------------------------------ 2. the count

// d (m64 x n64, f32) (+)= A (m64 x 32 bytes of c) B (32 bytes of c x n64),
// both K-major in 128-byte swizzled shared memory
template <typename T>
__device__ __forceinline__ void mma(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  if constexpr (sizeof(T) == 4) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " D32 "}, %32, %33, p, 1, 1;\n}"
        : F8(0), F8(8), F8(16), F8(24)
        : "l"(a), "l"(b), "r"(accumulate));
  } else {
    mma_ss_n64(d, a, b, accumulate);
  }
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

// The second route: rows [row0, row0+64) x 128 bytes of c from c0 of one
// tile, copied by the consumer warpgroup into the layout a 128-byte
// swizzled TMA box has (16-byte chunk q of row r at chunk q ^ (r % 8)).
template <typename T>
__device__ void copy_panel(uint32_t dst, const T* tile, int row0, int c0, int t, int tid) {
  for (int w = tid; w < kPatch * 32; w += kConsumers) {
    const int r = w / 32, wc = w % 32;       // row, 4-byte word of the row
    const uint32_t at = dst + r * 128 + ((((wc / 4) ^ (r % 8)) * 16) | ((wc % 4) * 4));
    const int gr = row0 + r;
    if constexpr (sizeof(T) == 4) {
      const int c = c0 + wc;
      const bool in = gr < t && c < t;
      cp_async4(at, in ? tile + (size_t)gr * t + c : tile, in ? 4 : 0);
    } else {
      const int c = c0 + 2 * wc;
      const uint16_t* x = reinterpret_cast<const uint16_t*>(tile) + (size_t)gr * t + c;
      if (gr < t && c + 1 < t && (reinterpret_cast<uintptr_t>(x) & 3) == 0) {
        cp_async4(at, x, 4);
      } else {
        const uint32_t lo = gr < t && c < t ? x[0] : 0u;
        const uint32_t hi = gr < t && c + 1 < t ? x[1] : 0u;
        asm volatile("st.shared.u32 [%0], %1;" ::"r"(at), "r"(lo | (hi << 16)) : "memory");
      }
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
}

template <typename T, bool kTma>
__global__ void __launch_bounds__(kThreads)
tc_tiles_kernel(const __grid_constant__ CUtensorMap tm, const T* __restrict__ tiles,
                const int* __restrict__ idx, const int* __restrict__ ext_rows,
                const int* __restrict__ ext_cols,
                const unsigned long long* __restrict__ masks,
                unsigned long long* __restrict__ count, int t) {
  constexpr int kPanel = Elt<T>::kPanel;
  extern __shared__ uint8_t smem_raw[];
  __shared__ long long warp_sum[kConsumers / 32];

  const int patches = (t + kPatch - 1) / kPatch;
  const long long b = blockIdx.x / patches;
  const int rp = blockIdx.x % patches;
  const int ij = idx[3 * b], ik = idx[3 * b + 1], jk = idx[3 * b + 2];
  if (ij < 0) return;  // masked (padding) triple
  const int r0 = rp * kPatch;
  const int R = min(extent(ext_rows, ij, t), extent(ext_rows, ik, t));
  const int S = min(extent(ext_cols, ij, t), extent(ext_rows, jk, t));
  const int C = min(extent(ext_cols, ik, t), extent(ext_cols, jk, t));
  if (r0 >= R || S == 0 || C == 0) return;  // outside the box: nothing counts
  // A_ij's patches in these rows that hold an entry, below S
  uint64_t live = masks[(size_t)ij * patches + rp];
  const int below = (S + kPatch - 1) / kPatch;
  if (below < 64) live &= (1ull << below) - 1;
  if (!live) return;  // no entry of A_ij: no triangle here

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  auto a_s = [&](int s) { return base + s * 2 * kOperand; };
  auto b_s = [&](int s) { return base + s * 2 * kOperand + kOperand; };
  const uint32_t bars = base + kStages * 2 * kOperand;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  const int nk = (C + kPanel - 1) / kPanel;  // panels along c inside the box
  constexpr int kSlice = kPatch / kPanel;    // panels per 64-wide slice of c
  // A_ik's 64-wide slices of c that hold an entry in rows [r0, r0 + 64), below C
  const int c_below = (C + kPatch - 1) / kPatch;
  const uint64_t ik_live = masks[(size_t)ik * patches + rp] &
                           (c_below < 64 ? (1ull << c_below) - 1 : ~0ull);
  // the slices of c where both A_ik's rows and A_jk's rows [s0, s0 + 64)
  // hold an entry: elsewhere every product is zero
  auto slices = [&](int s0) { return ik_live & masks[(size_t)jk * patches + s0 / kPatch]; };

  if constexpr (kTma) {
    if (tid == 0) {
      for (int s = 0; s < kStages; ++s) {
        bar_init(full(s), 1);
        bar_init(empty(s), kConsumers / 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
  }

  if (warp == kConsumers / 32) {
    // ---- producer: one thread issues every TMA load, patch by patch
    if (kTma && lane == 0) {
      int it = 0;
      for (uint64_t rest = live; rest; rest &= rest - 1) {
        const int s0 = (__ffsll((long long)rest) - 1) * kPatch;
        for (uint64_t cs = slices(s0); cs; cs &= cs - 1) {
          const int k0 = (__ffsll((long long)cs) - 1) * kSlice;
          for (int kk = k0; kk < min(k0 + kSlice, nk); ++kk, ++it) {
            const int s = it % kStages;
            bar_wait(empty(s), ((it / kStages) & 1) ^ 1);
            bar_expect_tx(full(s), 2 * kOperand);
            tma_load(a_s(s), &tm, full(s), kk * kPanel, r0, ik);
            tma_load(b_s(s), &tm, full(s), kk * kPanel, s0, jk);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: the 64 x 64 wedge counts of each live patch
  const size_t tt = (size_t)t * t;
  const T* a_ij = tiles + (size_t)ij * tt;
  // accumulator layout of wgmma m64n64: element 4j + e of a thread lies in
  // row r_lo + 8 * (e / 2), column 8j + 2 * (lane % 4) + e % 2 of the patch
  const int r_lo = r0 + 16 * warp + lane / 4;
  const int c_lane = 2 * (lane % 4);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  long long part = 0;
  int it = 0;
  for (uint64_t rest = live; rest; rest &= rest - 1) {
    const int s0 = (__ffsll((long long)rest) - 1) * kPatch;
    const uint64_t cs0 = slices(s0);
    if (!cs0) continue;                      // no wedge in this patch
    // A_ij under each accumulator element, loaded now and used after the
    // products, so that the loads' latency hides behind them
    T m[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = r_lo + 8 * ((i % 4) / 2), c = s0 + 8 * (i / 4) + c_lane + i % 2;
      m[i] = r < R && c < S ? a_ij[(size_t)r * t + c] : T(0.f);
    }
    int steps = 0;                           // panels of this patch so far
    for (uint64_t cs = cs0; cs; cs &= cs - 1) {
      const int k0 = (__ffsll((long long)cs) - 1) * kSlice;
      for (int kk = k0; kk < min(k0 + kSlice, nk); ++kk, ++it, ++steps) {
        int s = 0;
        if constexpr (kTma) {
          s = it % kStages;
          bar_wait(full(s), (it / kStages) & 1);
        } else {
          consumers_sync();                    // the last panel's wgmmas are done everywhere
          copy_panel(a_s(0), tiles + (size_t)ik * tt, r0, kk * kPanel, t, tid);
          copy_panel(b_s(0), tiles + (size_t)jk * tt, s0, kk * kPanel, t, tid);
          fence_proxy_async();
          consumers_sync();
        }
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int q = 0; q < 4; ++q)           // 32 bytes of c per instruction
          mma<T>(acc, desc(a_s(s) + 32 * q, 16), desc(b_s(s) + 32 * q, 16), steps > 0 || q > 0);
        wgmma_commit();
        if constexpr (kTma) {
          // the previous panel's group has retired: release its stage
          if (steps > 0) {
            wgmma_wait<1>();
            __syncwarp();
            if (lane == 0) bar_arrive(empty((it - 1) % kStages));
          }
        } else {
          wgmma_wait<0>();
        }
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if constexpr (kTma) {
      __syncwarp();
      if (lane == 0) bar_arrive(empty((it - 1) % kStages));
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) part += __float2ll_rn(acc[i] * to_f32(m[i]));
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) part += __shfl_down_sync(kAll, part, off);
  if (lane == 0) warp_sum[warp] = part;
  consumers_sync();
  if (tid == 0) {
    long long total = 0;
#pragma unroll
    for (int w = 0; w < kConsumers / 32; ++w) total += warp_sum[w];
    if (total) atomicAdd(count, (unsigned long long)total);
  }
}

template <typename T>
cudaError_t launch(const void* tiles, const int* idx, const int* rows, const int* cols,
                   unsigned long long* masks, unsigned long long* count, long long nd,
                   long long nb, int t, cudaStream_t stream) {
  cudaError_t e = cudaMemsetAsync(count, 0, sizeof(unsigned long long), stream);
  if (e != cudaSuccess || nb == 0 || nd == 0 || t == 0) return e;
  if (t > kMaxT || nb * ((t + kPatch - 1) / kPatch) > 0x7fffffffll) return cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(tiles);
  const unsigned patches = (unsigned)((t + kPatch - 1) / kPatch);
  const bool tma = ((size_t)t * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(tiles) % 16 == 0;
  const dim3 mgrid((unsigned)nd, patches);
  if (tma) patch_masks_kernel<T, true><<<mgrid, 128, 0, stream>>>(x, rows, cols, masks, t);
  else patch_masks_kernel<T, false><<<mgrid, 128, 0, stream>>>(x, rows, cols, masks, t);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;

  const unsigned grid = (unsigned)(nb * patches);
  CUtensorMap map{};
  if (tma) {
    const cuuint64_t dims[3] = {(cuuint64_t)t, (cuuint64_t)t, (cuuint64_t)nd};
    e = tensor_map_3d(&map, Elt<T>::kMap, tiles, dims, (cuuint64_t)t * sizeof(T),
                      (cuuint64_t)t * t * sizeof(T), Elt<T>::kPanel, kPatch);
    if (e != cudaSuccess) return e;
    constexpr int smem = kStages * 2 * kOperand + 16 * kStages + 1024;  // + alignment slack
    e = cudaFuncSetAttribute(tc_tiles_kernel<T, true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    tc_tiles_kernel<T, true><<<grid, kThreads, smem, stream>>>(map, x, idx, rows, cols, masks,
                                                               count, t);
  } else {
    constexpr int smem = 2 * kOperand + 1024;
    tc_tiles_kernel<T, false><<<grid, kThreads, smem, stream>>>(map, x, idx, rows, cols, masks,
                                                                count, t);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype of the tiles: 0 = float32 (TF32 tensor cores), 1 = bfloat16.  tiles
// is (nd, t, t); idx is (nb, 3) int32; rows and cols are the (nd,) int32
// extents of the tiles, or both null for whole tiles.  masks is scratch of
// nd * ceil(t/64) 64-bit words.  count is one int64, zeroed here on the same
// stream before the launches.  t <= 4096.
extern "C" int tc_tiles_launch(int device, const void* tiles, const void* idx,
                               const void* rows, const void* cols, void* masks, void* count,
                               long long nd, long long nb, int t, int dtype, void* stream) {
  DeviceGuard guard(device);  // the caller's device is current again on return
  if (guard.err != cudaSuccess) return guard.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ix = static_cast<const int*>(idx);
  const int* er = static_cast<const int*>(rows);
  const int* ec = static_cast<const int*>(cols);
  unsigned long long* mk = static_cast<unsigned long long*>(masks);
  unsigned long long* cnt = static_cast<unsigned long long*>(count);
  switch (dtype) {
    case 0: return launch<float>(tiles, ix, er, ec, mk, cnt, nd, nb, t, s);
    case 1: return launch<__nv_bfloat16>(tiles, ix, er, ec, mk, cnt, nd, nb, t, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* tc_tiles_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
