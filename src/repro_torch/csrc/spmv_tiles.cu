// spmv_tiles: y[b] = A[b]^T x[b] over a batch of dense 0/1 bitmap tiles,
// each read only inside its block rectangle; with a query axis,
// y[q, b] = A[b]^T x[q, b] for Q slices against the shared tiles.
//
// Replaces the Pallas kernel src/repro/kernels/spmv_tile.py::spmv_tiles
// (PageRank's dense K_D path, src/repro/algorithms/pagerank.py:100, and
// under vmap the batched PageRank of graph serving, :107-109).
//
// Contract: tile b is zero at rows >= rows[b] and columns >= cols[b] (its
// block's rectangle in the padded T x T tile; no extents means the whole
// tile).  The kernel uses no tile element and no x[b, r] outside the
// rectangle (a 16-byte load of the row segment may take up to V - 1
// elements past cols[b], inside the same row; their sums are dropped).
//
// Output contract: ys[b, c] is exactly 0 for every c >= cols[b].  PageRank
// index-adds all T columns of ys at tile_col_start[b] + c, and past
// cols[b] those indices are the next stripe's vertices.  The kernel writes
// every element of ys -- the sums below cols[b], zeros past it -- so the
// wrapper allocates ys with torch.empty and no memset runs.
//
// Bound on Hopper: memory.  Each tile element inside the rectangle is read
// once and used in one multiply-add: 2 flops per 4 bytes (float32) or 2
// bytes (bf16), far below the ~20 flop/byte at which an H100's float32
// units bind, so no tensor cores.  The bytes are the rectangles (about
// 6 % of the padded tiles at PageRank's chip configuration), x below
// rows[b], and ys.
//
// Design:
// * Work items are (tile, panel of kPanel = 256 columns), panel-major.  An
//   item walks every row below rows[b] of its panel's columns below
//   cols[b] and writes the panel's columns of ys: the sums, then zeros.
//   Each output has one writer and is summed in one fixed order: no
//   atomics, no memset, the same bits on every run.  A rectangle wider
//   than 256 columns spreads over two blocks.
// * Load balance over ragged rectangles (1 to 512 rows and columns): one
//   256-thread block per item, so the hardware's block scheduler hands
//   items to SMs as they free up; an item with no rows or columns writes
//   its zeros and leaves.  A persistent grid (as many blocks as the card
//   holds at once, items in a static interleave) measured 5-15 % slower on
//   the main path's inputs and was dropped (times in PERF.md).  Row slabs
//   (an item per 64 to 256 rows, an atomicAdd per column into a zeroed ys)
//   measured slower than whole-height panels on the same rectangles (H100
//   80GB HBM3, 700 W): there a tall rectangle is narrow and a wide one
//   short (chip_smoke.py prints the extents' correlation and the largest
//   rectangle), so the slabs bought little balance for their memset and
//   adds.
// * Inside an item the columns go to wp lanes, wp a power of two, each
//   lane owning V adjacent columns: V = 4 float32 or 8 bf16 elements (one
//   16-byte load) where the rows are 16-byte aligned, else V = 1 (the
//   scalar route: T * sizeof(element) not a multiple of 16, or a
//   misaligned tiles pointer).  The 256 / wp groups of wp lanes split the
//   rows.  A row segment costs its own 32-byte sectors, so a narrow
//   rectangle costs about its own bytes, not a 128-column panel's.
// * Bytes in flight: each thread issues the loads of kBatch = 4 rows (and
//   their x values) before it uses any, one 16-byte load a row: 16 KB a
//   block, and six blocks fit on an SM (40 registers a thread): ~96 KB in
//   flight per SM, against the ~25 KB an SM needs to cover DRAM's latency
//   at 3.35 TB/s.  The tile loads are __ldcs (evict-first): each element is
//   read once a call, so it should not push x and ys out of L2.  No TMA or
//   cp.async ring: a TMA box has a fixed size and would over-read the
//   narrow rectangles, and plain vector loads already keep enough in
//   flight.  (Batches of 8 or 16 rows, 128- or 512-thread blocks, 512-column
//   panels and loads without the evict-first hint measured no faster on
//   the main path's inputs, on the same card.)
// * The groups' partial sums fold with shuffles inside a warp and through
//   shared memory across warps.
// * Query axis: a block takes one item and a group of up to QG = 8 queries
//   (grid.y walks the groups).  It walks the item's rows once and keeps QG
//   accumulators per column, so a tile is read from HBM once per group,
//   not once per query; the QG x slices of a row are loaded beside its
//   tile segment.  Every query's sums run in the order the Q = 1 kernel
//   uses (the same rows per lane, the same fmaf chain, the same fold), so
//   row q of a batched launch equals the Q = 1 launch on row q bit for
//   bit.  The fold goes query by query through the one shared buffer.
//   QG is a template argument (1, 2, 4 or 8, the least that holds min(Q,
//   8)), so a Q = 1 launch keeps one accumulator set.
// * No global __device__ state: two streams may run the kernel at once.
//   The extents are clamped to [0, T] here and never read on the host.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPanel = 256;  // columns of a work item
constexpr int kBatch = 4;    // rows whose loads a thread issues together
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// V adjacent tile elements: one load of type raw, unpacked to float32.
template <typename T, int V> struct Elems {
  static_assert(V == 1, "vector routes are specialised below");
  using raw = T;
  static __device__ __forceinline__ raw zero() { return raw(0.f); }
  static __device__ __forceinline__ void unpack(const raw& v, float* f) { f[0] = to_f32(v); }
};
template <> struct Elems<float, 4> {
  using raw = float4;
  static __device__ __forceinline__ raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ void unpack(const raw& v, float* f) {
    f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
  }
};
template <> struct Elems<__nv_bfloat16, 8> {
  using raw = uint4;
  static __device__ __forceinline__ raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  static __device__ __forceinline__ void unpack(const raw& v, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(h[i]);
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
};

__device__ __forceinline__ int extent(const int* ext, long long b, int t) {
  return ext ? min(max(ext[b], 0), t) : t;
}

// Lanes that own columns in a chunk of cols columns (at most kThreads), and
// that count rounded up to a power of two: the width of a lane group.
template <int V>
__device__ __forceinline__ int lanes(int cols) { return min((cols + V - 1) / V, kThreads); }
__device__ __forceinline__ int pow2(int w) { return w <= 1 ? 1 : 1 << (32 - __clz(w - 1)); }

template <typename T, int V, int QG>
__global__ void __launch_bounds__(kThreads)
spmv_tiles_kernel(const T* __restrict__ tiles, const T* __restrict__ xs,
                  const int* __restrict__ ext_rows, const int* __restrict__ ext_cols,
                  float* __restrict__ ys, long long nd, int t, int nq) {
  using E = Elems<T, V>;
  __shared__ float part[kThreads * V];   // the groups' partial sums of a chunk
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // items panel-major: item = panel * nd + tile
  const long long item = blockIdx.x, b = item % nd;
  const int p0 = (int)(item / nd) * kPanel, p1 = min(p0 + kPanel, t);
  const int q0 = blockIdx.y * QG, nqg = min(QG, nq - q0);   // this block's queries
  const long long qstride = nd * t;    // one query's slab of xs and ys
  const int n = extent(ext_rows, b, t);   // rows to walk
  // columns to sum: the rectangle's inside this panel
  const int width = n > 0 ? max(min(extent(ext_cols, b, t), p1) - p0, 0) : 0;
  const T* a = tiles + b * t * (long long)t + p0;
  const T* x = xs + q0 * qstride + b * t;
  float* y = ys + q0 * qstride + b * t + p0;

  for (int c0 = 0; c0 < width; c0 += kThreads * V) {
    const int w = lanes<V>(width - c0), wp = pow2(w);
    const int groups = kThreads / wp;
    const int q = tid & (wp - 1), g = tid / wp;
    float acc[QG][V];
#pragma unroll
    for (int k = 0; k < QG; ++k)
#pragma unroll
      for (int j = 0; j < V; ++j) acc[k][j] = 0.f;
    if (q < w) {
      const T* p = a + c0 + q * V;
      for (int r = g; r < n; r += groups * kBatch) {
        typename E::raw v[kBatch];
        float xv[kBatch][QG];
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          const int rr = r + k * groups;
          v[k] = rr < n ? __ldcs(reinterpret_cast<const typename E::raw*>(p + (long long)rr * t))
                        : E::zero();
#pragma unroll
          for (int s = 0; s < QG; ++s)
            xv[k][s] = rr < n && s < nqg ? to_f32(x[s * qstride + rr]) : 0.f;
        }
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          float f[V];
          E::unpack(v[k], f);
#pragma unroll
          for (int s = 0; s < QG; ++s)
#pragma unroll
            for (int j = 0; j < V; ++j) acc[s][j] = fmaf(f[j], xv[k][s], acc[s][j]);
        }
      }
    }
    // fold the groups, one query at a time through part: inside a warp by
    // shuffles (wp < 32), then across warps (or, for wp >= 32, across the
    // groups) through shared memory
    const int parts = wp < 32 ? kWarps : groups, stride = wp * V;
#pragma unroll
    for (int s = 0; s < QG; ++s) {
      if (s >= nqg) break;   // uniform across the block
      int slot = g;
      bool writes = true;
      if (wp < 32) {
#pragma unroll
        for (int j = 0; j < V; ++j)
          for (int o = wp; o < 32; o <<= 1) acc[s][j] += __shfl_xor_sync(kAll, acc[s][j], o);
        slot = warp;
        writes = lane < wp;
      }
      if (writes) {
#pragma unroll
        for (int j = 0; j < V; ++j) part[slot * stride + q * V + j] = acc[s][j];
      }
      __syncthreads();
      for (int e = tid; e < w * V && c0 + e < width; e += kThreads) {
        float sum = 0.f;
        for (int i = 0; i < parts; ++i) sum += part[i * stride + e];
        y[s * qstride + c0 + e] = sum;
      }
      __syncthreads();
    }
  }
  for (int s = 0; s < nqg; ++s)   // past the rectangle
    for (int c = width + tid; c < p1 - p0; c += kThreads) y[s * qstride + c] = 0.f;
}

template <typename T, int V, int QG>
cudaError_t launch_q(const void* tiles, const void* xs, const int* rows, const int* cols,
                     float* ys, long long nd, int t, int nq, cudaStream_t stream) {
  const long long items = nd * ((t + kPanel - 1) / kPanel);   // one block each
  const long long groups = (nq + QG - 1) / QG;
  if (items > 0x7fffffffLL || groups > 65535) return cudaErrorInvalidValue;
  spmv_tiles_kernel<T, V, QG><<<dim3((unsigned)items, (unsigned)groups), kThreads, 0, stream>>>(
      static_cast<const T*>(tiles), static_cast<const T*>(xs), rows, cols, ys, nd, t, nq);
  return cudaGetLastError();
}

// the least query group that holds min(nq, 8) queries
template <typename T, int V>
cudaError_t launch(const void* tiles, const void* xs, const int* rows, const int* cols,
                   float* ys, long long nq, long long nd, int t, cudaStream_t stream) {
  if (nq < 1 || nq > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int q = (int)nq;
  if (q == 1) return launch_q<T, V, 1>(tiles, xs, rows, cols, ys, nd, t, q, stream);
  if (q == 2) return launch_q<T, V, 2>(tiles, xs, rows, cols, ys, nd, t, q, stream);
  if (q <= 4) return launch_q<T, V, 4>(tiles, xs, rows, cols, ys, nd, t, q, stream);
  return launch_q<T, V, 8>(tiles, xs, rows, cols, ys, nd, t, q, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (tiles and xs share it); xs is (nq, nd,
// T) and ys float32 (nq, nd, T), every element of it written.  rows and
// cols are the (nd,) int32 extents of the tiles, or both null for whole
// tiles.  vec = 1 takes 16-byte loads: the caller promises a 16-byte
// aligned tiles pointer and T * sizeof(element) a multiple of 16.
extern "C" int spmv_tiles_launch(int device, const void* tiles, const void* xs,
                                 const void* rows, const void* cols, void* ys,
                                 long long nq, long long nd, int t, int dtype, int vec,
                                 void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* y = static_cast<float*>(ys);
  const int* er = static_cast<const int*>(rows);
  const int* ec = static_cast<const int*>(cols);
  switch (dtype * 2 + (vec ? 1 : 0)) {
    case 0: return launch<float, 1>(tiles, xs, er, ec, y, nq, nd, t, s);
    case 1: return launch<float, 4>(tiles, xs, er, ec, y, nq, nd, t, s);
    case 2: return launch<__nv_bfloat16, 1>(tiles, xs, er, ec, y, nq, nd, t, s);
    case 3: return launch<__nv_bfloat16, 8>(tiles, xs, er, ec, y, nq, nd, t, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" const char* spmv_tiles_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
