// The three micro-probes of tools/probe_mosaic2.py, as parallel kernels.
//
// Replaces the Pallas kernels of tools/probe_mosaic2.py, each a serial
// scalar loop on the TPU:
//   A (probe_scalar_loads `kernel`): out = sum_i val[idx[i]], int32;
//   B (probe_dyn_slice `kernel`):    out = sum_i of the sum of rows
//                                    [off[i], off[i] + 2) of a (R, W) f32
//                                    array;
//   C (probe_accum_store `kernel`):  out = 2 * x, stored as (n/128, 128).
// Indices clamp into range (idx into [0, n_val), off into [0, R - 2]), as
// the twins' gathers do.
//
// What bounds them on an H100: memory. A reads 4 bytes of index and one
// scattered 4-byte value per term; C reads and writes 4 bytes an element;
// at the probes' size (16384 terms, 64 KB) those bytes take under 0.05 us,
// so a call costs the launch. B reads 2 * W floats a term: 3 KB at W = 384,
// 50.3 MB over the probe's 16384 terms, re-read from L2 (the (640, 384)
// array is 983 KB and stays there): an L2 rate, not the bytes-once bound,
// sets its time.
//
// A, gather_sum: ONE launch a call, one thread-block cluster of 8 blocks
// of 512 threads (__cluster_dims__; one int4 of indices a thread at 16384,
// a loop beyond), val read through the read-only path; each block reduces
// by shuffles into its shared memory, and after a cluster barrier block 0
// adds the 8 block sums through distributed shared memory
// (map_shared_rank) in rank order and writes out[0]. Nothing is zeroed or
// allocated; the int32 sum wraps as int32 does and is exact in any order.
// Design 1 of the same entry point: a grid of blocks whose sums atomicAdd
// into out[0], zeroed by cudaMemsetAsync first.
//
// C, tile_scale: one float4 load and store a thread, no loop (16 blocks of
// 256 threads at 16384 elements), a scalar tail for n % 4; x * 2 is exact.
//
// B, slice_sum: ONE launch a call of `grid` blocks of kSliceWarps warps
// (the wrapper gives a warp a term, up to kSliceBlocksPerSm blocks an
// SM, so no warp starts without a term). Warp g of the
// grid's nw = grid * kSliceWarps takes terms g, g + nw, g + 2 nw, ... (a
// static split), kSliceTerms at a time: its lanes load the offsets of 32
// of its terms at once, then for each group of kSliceTerms terms start
// every row load of kSliceChunks chunks before adding any. A term's two
// rows are 2W contiguous floats; with W % 4 == 0 (and `a` 16-byte aligned,
// which the wrapper checks) they are 2W/4 float4s, read through the
// read-only path; otherwise a template of the same kernel reads floats.
//
// The f32 sum's order, fixed for a given grid (the same bits on every call
// with the same inputs; tools/probe_mosaic2.py::slice_sum_order_model
// computes it in numpy):
//  1. a lane keeps 4 accumulators s0..s3. In the float4 path component k
//     of a float4 goes to s_k; in the float path item chunk c goes to
//     s_(c % 4). An item is float4 (or float) q = 32 c + lane of a term's
//     2W floats. For each group of kSliceTerms terms, in chunk groups of
//     kSliceChunks: for each term of the group in order, for each chunk
//     of the chunk group in order, the item is added (0.0f where the item
//     or the term is past the end);
//  2. the lane's value is (s0 + s1) + (s2 + s3), and the warp adds its
//     lanes by __shfl_down_sync at offsets 16, 8, 4, 2, 1 (lane 0's sum);
//  3. thread 0 adds its block's warp sums in warp order, writes the sum
//     to workspace[1 + block], fences and draws the ticket workspace[0]
//     (atomicAdd);
//  4. the block that draws the last ticket adds the grid's block sums:
//     thread t sums blocks t, t + 256, ... in order (from 0.0f), then 2.
//     and 3. over its threads, writes out[0] and resets the ticket to 0.
// The twin sums with torch and the JAX probe sequentially: both in other
// orders, so the kernel is held within 1e-5 of the sum of |terms| of
// them, and bit for bit to the order model.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kCluster = 8;      // gather_sum: blocks of its one cluster
constexpr int kClusterThreads = 512;  // and their threads: a quad each at
                                      // the probe's 16384 indices
constexpr int kAtomicMaxBlocks = 256;  // gather_sum design 1's grid
// slice_sum (kernels/probe_mosaic2.py's SLICE_* constants hold the same)
constexpr int kSliceWarps = 8;   // warps a block: kThreads / 32
constexpr int kSliceTerms = 4;   // terms a warp has in flight
constexpr int kSliceChunks = 6;  // chunks of 32 items a term loads at once:
                                 // a whole 2 x 384 slice as float4s
constexpr int kSliceBlocksPerSm = 2;

template <typename T, int kT = kThreads>
__device__ T block_sum(T v) {
  __shared__ T warp_sum[kT / 32];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = v;
  __syncthreads();
  v = threadIdx.x < kT / 32 ? warp_sum[threadIdx.x] : T(0);
  if (warp == 0)
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // valid in thread 0
}

__device__ __forceinline__ int gathered(const int* __restrict__ val,
                                        int i, int n_val) {
  return __ldg(val + min(max(i, 0), n_val - 1));
}

// This thread's share of sum_i val[idx[i]]: int4 quads of idx over
// `threads` threads from thread `t`, then the n % 4 tail on the first.
__device__ __forceinline__ int gather_part(const int* __restrict__ idx,
                                           const int* __restrict__ val,
                                           int n, int n_val, int t,
                                           int threads) {
  const int4* quads = reinterpret_cast<const int4*>(idx);
  int v = 0;
  for (int q = t; q < n / 4; q += threads) {
    const int4 i4 = __ldg(quads + q);
    v += gathered(val, i4.x, n_val) + gathered(val, i4.y, n_val) +
         gathered(val, i4.z, n_val) + gathered(val, i4.w, n_val);
  }
  if (t == 0)
    for (int i = n & ~3; i < n; ++i) v += gathered(val, idx[i], n_val);
  return v;
}

__global__ void __cluster_dims__(kCluster, 1, 1)
__launch_bounds__(kClusterThreads)
gather_sum_cluster_kernel(const int* __restrict__ idx,
                          const int* __restrict__ val, int n, int n_val,
                          int* __restrict__ out) {
  __shared__ int block_total;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  int v = gather_part(idx, val, n, n_val,
                      rank * kClusterThreads + threadIdx.x,
                      kCluster * kClusterThreads);
  v = block_sum<int, kClusterThreads>(v);
  if (threadIdx.x == 0) block_total = v;
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    int total = 0;
    for (int r = 0; r < kCluster; ++r)
      total += *cluster.map_shared_rank(&block_total, r);
    out[0] = total;
  }
  cluster.sync();  // keep every block's shared memory until block 0 read it
}

__global__ void __launch_bounds__(kThreads)
gather_sum_atomic_kernel(const int* __restrict__ idx,
                         const int* __restrict__ val, int n, int n_val,
                         int* __restrict__ out) {
  int v = gather_part(idx, val, n, n_val, blockIdx.x * kThreads + threadIdx.x,
                      gridDim.x * kThreads);
  v = block_sum(v);
  if (threadIdx.x == 0) atomicAdd(out, v);
}

// Steps 2-3 of the order: the warp's lanes by a shuffle tree, then the
// block's warps in warp order; the sum is valid in thread 0.
__device__ __forceinline__ float slice_block_sum(float v) {
  __shared__ float warp_sum[kSliceWarps];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = v;
  __syncthreads();
  float b = warp_sum[0];
  if (threadIdx.x == 0)
    for (int w = 1; w < kSliceWarps; ++w) b += warp_sum[w];
  return b;
}

// Item q of a term's two rows (a float4 or a float), 0 past the end.
template <bool kVec>
struct SliceItem;

template <>
struct SliceItem<true> {
  using T = float4;
  static __device__ __forceinline__ float4 load(const float* row, int q,
                                                bool ok) {
    return ok ? __ldg(reinterpret_cast<const float4*>(row) + q)
              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  static __device__ __forceinline__ void add(float (&s)[4], float4 v, int) {
    s[0] += v.x;
    s[1] += v.y;
    s[2] += v.z;
    s[3] += v.w;
  }
};

template <>
struct SliceItem<false> {
  using T = float;
  static __device__ __forceinline__ float load(const float* row, int q,
                                               bool ok) {
    return ok ? __ldg(row + q) : 0.0f;
  }
  static __device__ __forceinline__ void add(float (&s)[4], float v, int c) {
    s[c & 3] += v;
  }
};

template <bool kVec>
__global__ void __launch_bounds__(kThreads, kSliceBlocksPerSm)
slice_sum_kernel(const int* __restrict__ off, const float* __restrict__ a,
                 int n, int rows, int width, float* __restrict__ workspace,
                 float* __restrict__ out) {
  using Item = SliceItem<kVec>;
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const long long nw = static_cast<long long>(gridDim.x) * kSliceWarps;
  const long long g = blockIdx.x * kSliceWarps + (threadIdx.x >> 5);
  const int span = kVec ? width / 2 : 2 * width;  // items of a term
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (long long m0 = 0; g + m0 * nw < n; m0 += 32) {
    // the offsets of this warp's terms m0 .. m0 + 31, one a lane
    const long long mine = g + (m0 + lane) * nw;
    const int r_mine =
        mine < n ? min(max(__ldg(off + mine), 0), rows - 2) : 0;
    for (int j0 = 0; j0 < 32 && g + (m0 + j0) * nw < n; j0 += kSliceTerms) {
      const float* row[kSliceTerms];
      bool live[kSliceTerms];
#pragma unroll
      for (int j = 0; j < kSliceTerms; ++j) {
        live[j] = g + (m0 + j0 + j) * nw < n;
        row[j] = a + static_cast<size_t>(
                         __shfl_sync(0xffffffffu, r_mine, j0 + j)) * width;
      }
      for (int c0 = 0; c0 * 32 < span; c0 += kSliceChunks) {
        typename Item::T v[kSliceTerms][kSliceChunks];
#pragma unroll
        for (int j = 0; j < kSliceTerms; ++j)
#pragma unroll
          for (int k = 0; k < kSliceChunks; ++k) {
            const int q = (c0 + k) * 32 + lane;
            v[j][k] = Item::load(row[j], q, live[j] && q < span);
          }
#pragma unroll
        for (int j = 0; j < kSliceTerms; ++j)
#pragma unroll
          for (int k = 0; k < kSliceChunks; ++k) Item::add(s, v[j][k], c0 + k);
      }
    }
  }
  const float b = slice_block_sum((s[0] + s[1]) + (s[2] + s[3]));
  unsigned* ticket = reinterpret_cast<unsigned*>(workspace);
  float* partial = workspace + 1;
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = b;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float p = 0.0f;
  for (int blk = threadIdx.x; blk < gridDim.x; blk += kThreads)
    p += __ldcg(partial + blk);
  p = slice_block_sum(p);
  if (threadIdx.x == 0) {
    out[0] = p;
    *ticket = 0u;
  }
}

__global__ void __launch_bounds__(kThreads)
tile_scale_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                  int n) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q < n / 4) {
    const float4 v = __ldg(x + q);
    out[q] = make_float4(v.x * 2.0f, v.y * 2.0f, v.z * 2.0f, v.w * 2.0f);
  } else if (q == n / 4) {  // the scalar tail, n % 4 elements
    const float* xs = reinterpret_cast<const float*>(x);
    float* os = reinterpret_cast<float*>(out);
    for (int i = n & ~3; i < n; ++i) os[i] = xs[i] * 2.0f;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

}  // namespace

// A: out[0] = sum_i val[idx[i]] in one launch; idx 16-byte aligned.
// design 0: one cluster of 8 blocks; design 1: atomicAdd of the block sums
// into out[0], zeroed first (a memset and a launch).
extern "C" int gather_sum_launch(const int* idx, const int* val, int n,
                                 int n_val, int* out, int design,
                                 void* stream) {
  if (n < 0 || n_val <= 0 || !aligned16(idx) || design < 0 || design > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (design == 0) {
    gather_sum_cluster_kernel<<<kCluster, kClusterThreads, 0, s>>>(
        idx, val, n, n_val, out);
  } else {
    cudaError_t err = cudaMemsetAsync(out, 0, sizeof(int), s);
    if (err != cudaSuccess) return static_cast<int>(err);
    int blocks = ((n + 3) / 4 + kThreads - 1) / kThreads;
    blocks = blocks < 1 ? 1 : (blocks > kAtomicMaxBlocks ? kAtomicMaxBlocks
                                                         : blocks);
    gather_sum_atomic_kernel<<<blocks, kThreads, 0, s>>>(idx, val, n, n_val,
                                                         out);
  }
  return static_cast<int>(cudaGetLastError());
}

// B: out[0] = sum_i sum(a[off[i]:off[i]+2, :]) in one launch of `grid`
// blocks; a is (rows, width), 16-byte aligned; workspace holds a ticket of
// 0 then at least `grid` floats, bound to this stream (the last block
// resets the ticket).
extern "C" int slice_sum_launch(const int* off, const float* a, int n,
                                int rows, int width, int grid,
                                float* workspace, float* out, void* stream) {
  if (n < 0 || rows < 2 || width < 1 || grid < 1 || !aligned16(a))
    return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (width % 4 == 0)
    slice_sum_kernel<true><<<grid, kThreads, 0, s>>>(off, a, n, rows, width,
                                                     workspace, out);
  else
    slice_sum_kernel<false><<<grid, kThreads, 0, s>>>(off, a, n, rows, width,
                                                      workspace, out);
  return static_cast<int>(cudaGetLastError());
}

// C: out[i] = 2 * x[i]; x and out 16-byte aligned
extern "C" int tile_scale_launch(const float* x, float* out, int n,
                                 void* stream) {
  if (n < 0 || !aligned16(x) || !aligned16(out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int threads = n / 4 + (n % 4 != 0);  // a quad each, + the tail
  const int blocks = (threads + kThreads - 1) / kThreads;
  tile_scale_kernel<<<blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
