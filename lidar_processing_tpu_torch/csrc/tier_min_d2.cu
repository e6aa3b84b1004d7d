// Exact tests of one stixel tier table in one launch for B frames: the min
// squared distance of every pair slot, reading the point runs in place.
//
// Replaces, on the clustering main path, the per-tier loop of
// lidar_processing_tpu/ops/stixel.py::_tiered_exact around the Pallas
// kernel lidar_processing_tpu/kernels/min_d2.py::_kernel (min_d2_planar,
// one launch per tier over windows that _stacked_windows gathers). For
// tier t = (u_cap, v_cap, slots) and slot k < slots:
//   lo     = clamp(starts[t], 0, len - slots)   (lax.dynamic_slice's start)
//   active = k < n_in_tier[t]
//   (us, uc), (vs, vc) = the descriptors s_usuc[lo + k], s_vsvc[lo + k],
//            each start * 512 + count, if active; else (0, 0), (0, 0)
//   un = min(uc, u_cap), vn = min(vc, v_cap)
//   out[slot_off[t] + k] = min over i < un, j < vn of
//            d2(p[us + i], p[vs + j])
// where an empty side counts as one fill point, +1e9 in each coordinate
// on u and -1e9 on v. That is exactly min_d2_planar over the windows: any
// real pair beats any pair with a fill, and all fill lanes are equal. A
// point index q beyond the buffer reads what the windows' clamped row
// gather reads: row min(max(q / sr, 0), n / sr - 1), lane q mod sr, with
// sr = 8 points a row on u and 32 on v. d2 = fma(dz, dz, fma(dx, dx,
// dy*dy)) in explicit intrinsics, as in csrc/min_d2.cu: the rounding of
// the JAX package's exact test inside its jitted `cluster` on the CPU
// (found by crafted knife-edge pairs, tools/knife_cases.py). So every
// slot, inactive ones included, is bit-identical to the PyTorch twin
// (kernels/tier_min_d2.py::tier_min_d2_ref).
//
// What bounds it on an H100: a frame's active pairs touch ~12 B per point
// of each run and do 9 FP32 operations per real point pair, a few hundred
// thousand in all, far below both roofs; the old design did every slot at
// the full window width (296 x 320 lanes in the widest tier, mostly fill)
// and needed ~20 small launches per tier to gather the windows. What is
// left is the launch and the scattered 4-byte point loads.
//
// Design: one launch over every tier of the table and every frame of the
// batch; the block ranges per tier come from the static slot counts, so
// the host never waits. Frame f is blockIdx.y: its point buffer, its
// descriptors, its tier starts and counts and its output row sit at f
// times their per-frame sizes (the JAX package's vmap over frames, written
// out; each frame's slots are computed exactly as a batch of one).
//  - tiers with u_cap <= 32 and v_cap <= 96: one warp per pair slot, 8 a
//    block; u point i in lane i, shuffled to the warp one at a time; v
//    point j = lane + 32 m in registers (m < 3); the warp reduces by
//    shuffles (the scheme of csrc/probe_pairs.cu);
//  - wider tiers (runs up to 288 points): one block of 256 threads per
//    pair slot; both runs staged planar in shared memory (6.9 KB), the
//    threads stride over the un x vn real pairs only, then reduce by warp
//    shuffles and across warps (as csrc/min_d2.cu);
//  - an inactive slot writes the fill-to-fill value and exits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTiers = 8;
constexpr int kMaxFrames = 65535;  // gridDim.y
constexpr int kMaxRun = 288;   // widest run a block-per-pair tier stages
constexpr int kWarpU = 32;     // warp tiers: u in lanes
constexpr int kWarpV = 96;     // warp tiers: 3 v points a lane
constexpr int kCountBits = 9;  // descriptor = start * 512 + count
constexpr float kBig = 1.0e9f;

struct TierTable {
  int n;
  int u_cap[kMaxTiers];
  int v_cap[kMaxTiers];
  int slots[kMaxTiers];
  int per_warp[kMaxTiers];
  int slot_off[kMaxTiers];        // first output slot of each tier
  int block_off[kMaxTiers + 1];   // first block of each tier
  int slot_total;                 // output slots per frame
};

__device__ __forceinline__ float dist2(float ax, float ay, float az,
                                       float bx, float by, float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fmaf_rn(dz, dz, __fmaf_rn(dx, dx, __fmul_rn(dy, dy)));
}

// Point q of the (n, 3) buffer as a window row gather of 2^kShift points
// reads it (n is a multiple of 32).
template <int kShift>
__device__ __forceinline__ const float* point(const float* xyz, int q,
                                              int n) {
  const int row = min(max(q >> kShift, 0), (n >> kShift) - 1);
  return xyz + 3 * ((row << kShift) | (q & ((1 << kShift) - 1)));
}

__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// One warp: runs of un <= 32 and vn <= 96 points.
__device__ void warp_pair(const float* __restrict__ xyz, int n, int us,
                          int un, int vs, int vn, float* dst) {
  const int lane = threadIdx.x & 31;
  float ux = kBig, uy = kBig, uz = kBig;
  if (lane < un) {
    const float* p = point<3>(xyz, us + lane, n);
    ux = p[0];
    uy = p[1];
    uz = p[2];
  }
  float vx[kWarpV / 32], vy[kWarpV / 32], vz[kWarpV / 32];
#pragma unroll
  for (int m = 0; m < kWarpV / 32; ++m) {
    const int j = lane + 32 * m;
    vx[m] = vy[m] = vz[m] = -kBig;
    if (j < vn) {
      const float* p = point<5>(xyz, vs + j, n);
      vx[m] = p[0];
      vy[m] = p[1];
      vz[m] = p[2];
    }
  }
  // an empty side is its one fill point (lane 0 holds it)
  const int nu = max(un, 1);
  const int nv = max(vn, 1);
  float best = INFINITY;
  for (int i = 0; i < nu; ++i) {   // nu is the same on the whole warp
    const float ax = __shfl_sync(0xffffffffu, ux, i);
    const float ay = __shfl_sync(0xffffffffu, uy, i);
    const float az = __shfl_sync(0xffffffffu, uz, i);
#pragma unroll
    for (int m = 0; m < kWarpV / 32; ++m)
      if (lane + 32 * m < nv)
        best = fminf(best, dist2(ax, ay, az, vx[m], vy[m], vz[m]));
  }
  best = warp_min(best);
  if (lane == 0) *dst = best;
}

// One block: runs of un, vn <= kMaxRun points, staged in shared memory.
__device__ void block_pair(const float* __restrict__ xyz, int n, int us,
                           int un, int vs, int vn, float* dst) {
  __shared__ float su[3][kMaxRun];
  __shared__ float sv[3][kMaxRun];
  __shared__ float part[kWarps];
  const int tid = threadIdx.x;
  const int nu = max(un, 1);
  const int nv = max(vn, 1);
  for (int i = tid; i < nu; i += kThreads) {
    float x = kBig, y = kBig, z = kBig;
    if (i < un) {
      const float* p = point<3>(xyz, us + i, n);
      x = p[0];
      y = p[1];
      z = p[2];
    }
    su[0][i] = x;
    su[1][i] = y;
    su[2][i] = z;
  }
  for (int j = tid; j < nv; j += kThreads) {
    float x = -kBig, y = -kBig, z = -kBig;
    if (j < vn) {
      const float* p = point<5>(xyz, vs + j, n);
      x = p[0];
      y = p[1];
      z = p[2];
    }
    sv[0][j] = x;
    sv[1][j] = y;
    sv[2][j] = z;
  }
  __syncthreads();

  // stride over the flattened (i, j) grid of real pairs, stepping (i, j)
  // incrementally instead of dividing per element
  const int total = nu * nv;
  const int di = kThreads / nv;
  const int dj = kThreads - di * nv;
  int i = tid / nv;
  int j = tid - i * nv;
  float best = INFINITY;
  for (int e = tid; e < total; e += kThreads) {
    best = fminf(best, dist2(su[0][i], su[1][i], su[2][i], sv[0][j],
                             sv[1][j], sv[2][j]));
    i += di;
    j += dj;
    if (j >= nv) {
      j -= nv;
      i += 1;
    }
  }
  best = warp_min(best);
  if ((tid & 31) == 0) part[tid >> 5] = best;
  __syncthreads();
  if (tid < 32) {
    best = warp_min(tid < kWarps ? part[tid] : INFINITY);
    if (tid == 0) *dst = best;
  }
}

__global__ void __launch_bounds__(kThreads)
tier_min_d2_kernel(const float* __restrict__ xyz, int n,
                   const int* __restrict__ usuc,
                   const int* __restrict__ vsvc, int len,
                   const int* __restrict__ starts,
                   const int* __restrict__ n_in_tier,
                   float* __restrict__ out, TierTable tiers) {
  const size_t f = blockIdx.y;   // this block's frame
  xyz += f * 3 * static_cast<size_t>(n);
  usuc += f * len;
  vsvc += f * len;
  starts += f * tiers.n;
  n_in_tier += f * tiers.n;
  out += f * tiers.slot_total;
  int t = 0;
  while (t + 1 < tiers.n && static_cast<int>(blockIdx.x) >=
                                tiers.block_off[t + 1])
    ++t;
  const int local = blockIdx.x - tiers.block_off[t];
  const bool per_warp = tiers.per_warp[t];
  const int slots = tiers.slots[t];
  const int k = per_warp ? local * kWarps + (threadIdx.x >> 5) : local;
  if (k >= slots) return;   // a whole warp (warp tiers) or the whole block
  float* dst = out + tiers.slot_off[t] + k;
  if (k >= n_in_tier[t]) {   // inactive: both sides are one fill point
    if ((threadIdx.x & (per_warp ? 31 : kThreads - 1)) == 0)
      *dst = dist2(kBig, kBig, kBig, -kBig, -kBig, -kBig);
    return;
  }
  const int lo = min(max(starts[t], 0), len - slots);
  const int a = usuc[lo + k];
  const int b = vsvc[lo + k];
  const int mask = (1 << kCountBits) - 1;
  const int un = min(a & mask, tiers.u_cap[t]);
  const int vn = min(b & mask, tiers.v_cap[t]);
  if (per_warp)
    warp_pair(xyz, n, a >> kCountBits, un, b >> kCountBits, vn, dst);
  else
    block_pair(xyz, n, a >> kCountBits, un, b >> kCountBits, vn, dst);
}

}  // namespace

// table: n_tiers (u_cap, v_cap, slots) triples in host memory. Per frame
// (frames of them, one after another): xyz (n, 3), usuc and vsvc (len),
// starts and n_in_tier (n_tiers), and out the sum of the slots, tier after
// tier.
extern "C" int tier_min_d2_launch(const float* xyz, int n, const int* usuc,
                                  const int* vsvc, int len,
                                  const int* starts, const int* n_in_tier,
                                  float* out, const int* table, int n_tiers,
                                  int frames, void* stream) {
  if (n_tiers <= 0 || n_tiers > kMaxTiers || n < 32 || n % 32 != 0 ||
      frames <= 0 || frames > kMaxFrames)
    return static_cast<int>(cudaErrorInvalidValue);
  TierTable tiers = {};
  tiers.n = n_tiers;
  int blocks = 0;
  int slot_total = 0;
  for (int t = 0; t < n_tiers; ++t) {
    const int u = table[3 * t], v = table[3 * t + 1], s = table[3 * t + 2];
    const bool warp = u <= kWarpU && v <= kWarpV;
    if (s <= 0 || s > len || u < 0 || v < 0 ||
        (!warp && (u > kMaxRun || v > kMaxRun)))
      return static_cast<int>(cudaErrorInvalidValue);
    tiers.u_cap[t] = u;
    tiers.v_cap[t] = v;
    tiers.slots[t] = s;
    tiers.per_warp[t] = warp;
    tiers.slot_off[t] = slot_total;
    tiers.block_off[t] = blocks;
    slot_total += s;
    blocks += warp ? (s + kWarps - 1) / kWarps : s;
  }
  tiers.block_off[n_tiers] = blocks;
  tiers.slot_total = slot_total;
  tier_min_d2_kernel<<<dim3(blocks, frames), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      xyz, n, usuc, vsvc, len, starts, n_in_tier, out, tiers);
  return static_cast<int>(cudaGetLastError());
}
