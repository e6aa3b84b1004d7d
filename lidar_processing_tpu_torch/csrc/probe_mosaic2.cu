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
// What bounds them on an H100: memory, in principle. A reads 4 bytes of
// index and one scattered 4-byte value per term; B reads 2 * W floats per
// term (the array is ~1 MB and stays in L2); C reads and writes 4 bytes an
// element. None does enough arithmetic to matter. At the probes' size
// (16384 terms, 64 KB) the bytes take under 0.05 us: what a call costs
// on the card is the launch, and on the host the launch path
// (kernels/_build.py::launch).
//
// Design, the current versions:
//  - C, tile_scale: one float4 load and store a thread, no loop (16 blocks
//    of 256 threads at 16384 elements), a scalar tail for n % 4; x * 2 is
//    exact.
//  - A, gather_sum: ONE launch a call, one thread-block cluster of 8
//    blocks of 512 threads (__cluster_dims__; one int4 of indices a
//    thread at 16384, a loop beyond), val read
//    through the read-only path; each block reduces by shuffles into its
//    shared memory, and after a cluster barrier block 0 adds the 8 block
//    sums through distributed shared memory (map_shared_rank) in rank
//    order and writes out[0]. Nothing is zeroed or allocated; the int32
//    sum wraps as int32 does and is exact in any order. The second design
//    the same entry point offers (design 1): a grid of blocks whose sums
//    atomicAdd into out[0], zeroed by cudaMemsetAsync first.
//  - B, slice_sum: two passes, a partial per block then one block sums
//    the partials in a fixed order (its f32 sum is taken in another order
//    than the twin's); each warp takes one term at a time, its lanes
//    striding along the two rows.
// The _v0 entry points keep the first port's A and C (two kernels and a
// partials buffer for A, a grid-stride scalar loop for C), so that one
// process can time both designs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 256;  // the v0 / slice_sum partials buffer
constexpr int kCluster = 8;      // gather_sum: blocks of its one cluster
constexpr int kClusterThreads = 512;  // and their threads: a quad each at
                                      // the probe's 16384 indices

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
sum_partials_kernel(const T* __restrict__ partial, int blocks,
                    T* __restrict__ out) {
  T v = T(0);
  for (int b = threadIdx.x; b < blocks; b += kThreads) v += partial[b];
  v = block_sum(v);
  if (threadIdx.x == 0) out[0] = v;
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

__global__ void __launch_bounds__(kThreads)
gather_sum_v0_kernel(const int* __restrict__ idx, const int* __restrict__ val,
                     int n, int n_val, int* __restrict__ partial) {
  int v = 0;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads)
    v += val[min(max(idx[i], 0), n_val - 1)];
  v = block_sum(v);
  if (threadIdx.x == 0) partial[blockIdx.x] = v;
}

__global__ void __launch_bounds__(kThreads)
slice_sum_kernel(const int* __restrict__ off, const float* __restrict__ a,
                 int n, int rows, int width, float* __restrict__ partial) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kThreads / 32);
  float v = 0.0f;
  for (int i = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5); i < n;
       i += warps) {
    const int r = min(max(off[i], 0), rows - 2);
    const float* row = a + static_cast<size_t>(r) * width;
    for (int c = lane; c < 2 * width; c += 32) v += row[c];
  }
  v = block_sum(v);
  if (threadIdx.x == 0) partial[blockIdx.x] = v;
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

__global__ void __launch_bounds__(kThreads)
tile_scale_v0_kernel(const float* __restrict__ x, float* __restrict__ out,
                     int n) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads)
    out[i] = x[i] * 2.0f;
}

int grid_for(int work_items) {
  const int b = (work_items + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
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
    const int blocks = grid_for((n + 3) / 4);
    gather_sum_atomic_kernel<<<blocks, kThreads, 0, s>>>(idx, val, n, n_val,
                                                         out);
  }
  return static_cast<int>(cudaGetLastError());
}

// A, the first port: two kernels; partial holds kMaxBlocks int32
extern "C" int gather_sum_v0_launch(const int* idx, const int* val, int n,
                                    int n_val, int* partial, int* out,
                                    void* stream) {
  if (n_val <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int blocks = grid_for(n);
  gather_sum_v0_kernel<<<blocks, kThreads, 0, s>>>(idx, val, n, n_val,
                                                   partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<int><<<1, kThreads, 0, s>>>(partial, blocks, out);
  return static_cast<int>(cudaGetLastError());
}

// B: out[0] = sum_i sum(a[off[i]:off[i]+2, :]); a is (rows, width)
extern "C" int slice_sum_launch(const int* off, const float* a, int n,
                                int rows, int width, float* partial,
                                float* out, void* stream) {
  if (rows < 2) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int blocks = grid_for(n * 32);  // one warp per term
  slice_sum_kernel<<<blocks, kThreads, 0, s>>>(off, a, n, rows, width,
                                               partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_partials_kernel<float><<<1, kThreads, 0, s>>>(partial, blocks, out);
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

// C, the first port: a grid-stride scalar loop
extern "C" int tile_scale_v0_launch(const float* x, float* out, int n,
                                    void* stream) {
  if (n <= 0) return 0;
  tile_scale_v0_kernel<<<grid_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(x, out, n);
  return static_cast<int>(cudaGetLastError());
}
