// Min squared distance between two runs of one point array, per pair.
//
// Replaces the Pallas kernels of tools/probe_mosaic.py (`kernel`: runs of
// u <= 8 and v <= 48 points read from an (n/8, 24) stacked view) and
// tools/probe_mosaic3.py (`kernel` + `_window`: u <= 8, v <= 96, from a
// 128-lane planar layout, realigned with rolls and a one-hot matmul). For
// pair p:
//   out[p] = min over i < kU, j < kV of (ux-vx)^2 + (uy-vy)^2 + (uz-vz)^2
// where u_i is point us[p] + i if i < uc[p] and else the fill +1e9 (each
// coordinate), and v_j is point vs[p] + j if j < vc[p] and else -1e9. That
// is min_d2_planar over the windows _stacked_windows would gather, so the
// fills never win and the result is the min over the two runs; indices
// clamp into [0, n) as the twin's gathers do.
//
// What bounds it on an H100: per pair it reads (uc + vc) points and does
// 9 operations for each of uc * vc point pairs, a few hundred at most:
// the data-dependent reads (latency of scattered 4-byte loads) bound it,
// not the FP32 pipes.
//
// Design: one warp per pair, reading both runs straight from the x/y/z
// planes; no window tensor is built. Lane i < kU holds u_i (shuffled to
// the warp one at a time); each lane holds v_j for j = lane + 32k, keeps a
// running min in a register, and the warp reduces by shuffles. The TPU's
// (8, 128) stacking, its roll realignment and its one-hot matmul have no
// counterpart. d2 = fma(dz, dz, fma(dx, dx, dy*dy)) in explicit
// intrinsics, as csrc/min_d2.cu, makes it bit-identical to the twin.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;  // pairs per block
constexpr float kBig = 1.0e9f;

__device__ __forceinline__ float coord(const float* __restrict__ a, int k,
                                       int n, bool ok, float fill) {
  return ok ? a[min(max(k, 0), n - 1)] : fill;
}

template <int kU, int kV>
__global__ void __launch_bounds__(kWarps * 32)
pair_min_d2_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   const float* __restrict__ z, int n,
                   const int* __restrict__ us, const int* __restrict__ uc,
                   const int* __restrict__ vs, const int* __restrict__ vc,
                   float* __restrict__ out, int p) {
  static_assert(kU <= 32, "u run must fit one warp");
  constexpr int kPerLane = (kV + 31) / 32;
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (pair >= p) return;  // whole warps leave together

  const int u0 = us[pair], un = min(uc[pair], kU);
  const int v0 = vs[pair], vn = min(vc[pair], kV);
  const bool uok = lane < un;
  const float ux = coord(x, u0 + lane, n, uok, kBig);
  const float uy = coord(y, u0 + lane, n, uok, kBig);
  const float uz = coord(z, u0 + lane, n, uok, kBig);
  float vx[kPerLane], vy[kPerLane], vz[kPerLane];
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int j = lane + 32 * k;
    const bool ok = j < vn;
    vx[k] = coord(x, v0 + j, n, ok, -kBig);
    vy[k] = coord(y, v0 + j, n, ok, -kBig);
    vz[k] = coord(z, v0 + j, n, ok, -kBig);
  }

  float best = INFINITY;
#pragma unroll
  for (int i = 0; i < kU; ++i) {
    const float ax = __shfl_sync(0xffffffffu, ux, i);
    const float ay = __shfl_sync(0xffffffffu, uy, i);
    const float az = __shfl_sync(0xffffffffu, uz, i);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      if (lane + 32 * k >= kV) break;  // lanes past the window cap
      const float dx = __fsub_rn(ax, vx[k]);
      const float dy = __fsub_rn(ay, vy[k]);
      const float dz = __fsub_rn(az, vz[k]);
      best = fminf(best, __fmaf_rn(dz, dz,
                                   __fmaf_rn(dx, dx, __fmul_rn(dy, dy))));
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    best = fminf(best, __shfl_xor_sync(0xffffffffu, best, off));
  if (lane == 0) out[pair] = best;
}

template <int kU, int kV>
int launch(const float* x, const float* y, const float* z, int n,
           const int* us, const int* uc, const int* vs, const int* vc,
           float* out, int p, void* stream) {
  if (p <= 0) return 0;
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (p + kWarps - 1) / kWarps;
  pair_min_d2_kernel<kU, kV>
      <<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
          x, y, z, n, us, uc, vs, vc, out, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tools/probe_mosaic.py: u <= 8, v <= 48
extern "C" int pair_min_d2_v48_launch(const float* x, const float* y,
                                      const float* z, int n, const int* us,
                                      const int* uc, const int* vs,
                                      const int* vc, float* out, int p,
                                      void* stream) {
  return launch<8, 48>(x, y, z, n, us, uc, vs, vc, out, p, stream);
}

// tools/probe_mosaic3.py (and a frame's small supernode pairs): u <= 8,
// v <= 96
extern "C" int pair_min_d2_v96_launch(const float* x, const float* y,
                                      const float* z, int n, const int* us,
                                      const int* uc, const int* vs,
                                      const int* vc, float* out, int p,
                                      void* stream) {
  return launch<8, 96>(x, y, z, n, us, uc, vs, vc, out, p, stream);
}
