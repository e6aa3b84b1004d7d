// Batched minimum pairwise squared distance between point windows.
//
// Replaces lidar_processing_tpu/kernels/min_d2.py::_kernel (the Pallas TPU
// kernel launched by min_d2_planar). For each pair p it computes
//   out[p] = min_{i < Wu, j < Wv} (ux-vx)^2 + (uy-vy)^2 + (uz-vz)^2
// from six planar float32 windows (P, Wu) and (P, Wv). Masked lanes are
// pre-filled by the caller (+1e9 on the u side, -1e9 on the v side), so
// they never win the min.
//
// What bounds it on an H100: a pair reads 3*(Wu+Wv) floats and does
// 8*Wu*Wv flops (3 sub, 3 mul, 2 add; the min is a compare), so at the
// wide tiers (104x320, 296x320) it does ~100x more arithmetic than it
// reads and is bound by the FP32 pipes, not by HBM.
//
// Design: one thread block per pair. The block stages its pair's six
// windows in shared memory (at most (296+320)*3*4 B ~ 7.4 KB), its
// threads stride over the Wu x Wv grid keeping a running min in a
// register, then reduce by warp shuffles and across warps. Only P floats
// go back to device memory, as the TPU kernel kept its whole distance
// block in VMEM and wrote only the (B, 1) min.
//
// Rounding matches the JAX kernel as XLA compiles it on the CPU (jit or
// Pallas interpret mode) and the PyTorch twin
// (kernels/min_d2.py::min_d2_planar_ref): d2 = fma(dz, dz, fma(dx, dx,
// dy*dy)). The explicit __fmaf_rn / __fmul_rn intrinsics fix it, so
// nvcc's -fmad default decides nothing.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
min_d2_kernel(const float* __restrict__ ux, const float* __restrict__ uy,
              const float* __restrict__ uz, const float* __restrict__ vx,
              const float* __restrict__ vy, const float* __restrict__ vz,
              float* __restrict__ out, int wu, int wv) {
  extern __shared__ float smem[];
  float* sux = smem;
  float* suy = sux + wu;
  float* suz = suy + wu;
  float* svx = suz + wu;
  float* svy = svx + wv;
  float* svz = svy + wv;

  const size_t p = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < wu; i += kThreads) {
    sux[i] = ux[p * wu + i];
    suy[i] = uy[p * wu + i];
    suz[i] = uz[p * wu + i];
  }
  for (int j = tid; j < wv; j += kThreads) {
    svx[j] = vx[p * wv + j];
    svy[j] = vy[p * wv + j];
    svz[j] = vz[p * wv + j];
  }
  __syncthreads();

  // walk the flattened (i, j) grid with stride kThreads, stepping (i, j)
  // incrementally instead of dividing per element
  const int n = wu * wv;
  const int di = kThreads / wv;
  const int dj = kThreads - di * wv;
  int i = tid / wv;
  int j = tid - i * wv;
  float best = INFINITY;
  for (int k = tid; k < n; k += kThreads) {
    const float dx = __fsub_rn(sux[i], svx[j]);
    const float dy = __fsub_rn(suy[i], svy[j]);
    const float dz = __fsub_rn(suz[i], svz[j]);
    const float d2 = __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
    best = fminf(best, d2);
    i += di;
    j += dj;
    if (j >= wv) {
      j -= wv;
      i += 1;
    }
  }

  for (int off = 16; off > 0; off >>= 1)
    best = fminf(best, __shfl_down_sync(0xffffffffu, best, off));
  __shared__ float warp_min[kThreads / 32];
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (lane == 0) warp_min[warp] = best;
  __syncthreads();
  if (warp == 0) {
    best = lane < kThreads / 32 ? warp_min[lane] : INFINITY;
    for (int off = 16; off > 0; off >>= 1)
      best = fminf(best, __shfl_down_sync(0xffffffffu, best, off));
    if (lane == 0) out[p] = best;
  }
}

}  // namespace

extern "C" int min_d2_planar_launch(const float* ux, const float* uy,
                                    const float* uz, const float* vx,
                                    const float* vy, const float* vz,
                                    float* out, int p, int wu, int wv,
                                    void* stream) {
  if (p <= 0) return 0;
  const size_t smem = 3 * static_cast<size_t>(wu + wv) * sizeof(float);
  min_d2_kernel<<<p, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      ux, uy, uz, vx, vy, vz, out, wu, wv);
  return static_cast<int>(cudaGetLastError());
}
