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
// scattered 4-byte value per term; B reads 2 * W floats per term (the
// array is ~1 MB and stays in L2); C reads and writes 4 bytes an element.
// None does enough arithmetic to matter.
//
// Design: A and B reduce in two passes so the sum is the same on every
// run: a grid-stride loop per thread, a shuffle + shared-memory block
// reduction into one partial per block, then one block sums the partials
// in a fixed order. A's int32 sum is exact (wrapping as int32 does); B's
// f32 sum is taken in another order than the twin's. B gives each warp one
// term at a time, its lanes striding along the two rows. C is one
// elementwise pass; x * 2 is exact.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 256;  // the wrapper's partials buffer

template <typename T>
__device__ T block_sum(T v) {
  __shared__ T warp_sum[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = v;
  __syncthreads();
  v = threadIdx.x < kThreads / 32 ? warp_sum[threadIdx.x] : T(0);
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

__global__ void __launch_bounds__(kThreads)
gather_sum_kernel(const int* __restrict__ idx, const int* __restrict__ val,
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
tile_scale_kernel(const float* __restrict__ x, float* __restrict__ out,
                  int n) {
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads)
    out[i] = x[i] * 2.0f;
}

int grid_for(int work_items) {
  const int b = (work_items + kThreads - 1) / kThreads;
  return b < 1 ? 1 : (b > kMaxBlocks ? kMaxBlocks : b);
}

}  // namespace

// A: out[0] = sum_i val[idx[i]]; partial holds kMaxBlocks int32
extern "C" int gather_sum_launch(const int* idx, const int* val, int n,
                                 int n_val, int* partial, int* out,
                                 void* stream) {
  if (n_val <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int blocks = grid_for(n);
  gather_sum_kernel<<<blocks, kThreads, 0, s>>>(idx, val, n, n_val, partial);
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

// C: out[i] = 2 * x[i]
extern "C" int tile_scale_launch(const float* x, float* out, int n,
                                 void* stream) {
  if (n <= 0) return 0;
  tile_scale_kernel<<<grid_for(n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(x, out, n);
  return static_cast<int>(cudaGetLastError());
}
