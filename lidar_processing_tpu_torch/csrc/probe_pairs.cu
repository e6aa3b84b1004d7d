// Min squared distance between two runs of one point array, per pair.
//
// Replaces the Pallas kernels of tools/probe_mosaic.py (`kernel`: runs of
// u <= 8 and v <= 48 points read from an (n/8, 24) stacked view) and
// tools/probe_mosaic3.py (`kernel` + `_window`: u <= 8, v <= 96, from
// (n/128 + 16, 384) planar rows, realigned with rolls and a one-hot
// matmul). Contract, for pair p with un = clamp(uc[p], 0, kU) and
// vn = clamp(vc[p], 0, kV):
//   out[p] = min over i < kU, j < kV of fma(dz, dz, fma(dx, dx, dy*dy))
// where u_i is point clamp(us[p] + i, 0, n - 1) if i < un and else the
// fill (+1e9, +1e9, +1e9), and v_j is point clamp(vs[p] + j, 0, n - 1) if
// j < vn and else (-1e9, -1e9, -1e9). That is min_d2_planar over the
// windows the twin (kernels/probe_pairs.py::pair_min_d2_ref) gathers, and
// the kernel equals the twin bit for bit.
//
// Layout, read in place: `points` is an (R, 3L) f32 array, point k's axis
// a at points[k / L][a * L + k % L], n = R * L (padding rows count, so an
// index clamps into them as the twin's gathers do). L = 8 is
// probe_mosaic's stacked view, L = 128 probe_mosaic3's rows (both a
// template parameter: the division is a shift); R = 1 (a (3, n) planar
// tensor seen as (1, 3n)) reads points[a * n + k] with no division; any
// other L is a run-time argument. No plane is built: one launch a call.
//
// What bounds it on an H100: not bytes or FP32 throughput (a pair reads
// at most 8 + 96 points, 9 operations for each of at most 8 x 96 cells;
// the probes' 512 or 8192 pairs are ~0.1-3 MB and ~0.1-4 M operations,
// microseconds of either peak). At 512 pairs it is the launch and two
// dependent rounds through the memory system (a pair's descriptors, then
// the coordinates they name). At 8192 pairs, one wave of ~62 warps an SM,
// it is the instructions each warp issues: a fixed part (descriptors,
// address arithmetic, 3 coordinate loads a chunk, the reduction) and, per
// row of the window, 3 shuffles plus 7 instructions a cell for each chunk
// of 32 columns. tools/kernel_bench.py's count sweep shows both (PERF.md
// section 6).
//
// Design: one warp per pair. Lane i < kU holds u_i; each lane holds v_j
// for j = lane + 32c. Every load is issued before any compute, through
// the read-only path (ptxas predicates them, no branch in front of any);
// the layout's division is a shift for L = 8 and 128 and absent for one
// row (R = 1), each a template of its own. Then the warp evaluates the
// trimmed window, row by row (rows unrolled, leaving at the pair's last
// row), against as many chunks as the pair's columns fill: the row loop
// is instantiated for 1, 2 and 3 chunks and picked once a pair, since a
// chunk test inside it is predicated and would issue every chunk. Four
// warps a block: 2 and 8 were slower at 8192 pairs, and two pairs a warp
// (both pairs' loads before the first's compute) was no faster at 8192
// pairs and slower at 512.
//
// The trim, and why it is exact: every fill row of the window (i >= un)
// is the same vector and so is every fill column (j >= vn), so each fill
// row's cells equal row un's and each fill column's equal column vn's.
// The min over the kU x kV window is therefore the min over rows
// i < min(un + 1, kU) and columns j < min(vn + 1, kV): the real points
// plus one fill row and one fill column, where they exist. Each cell keeps
// the same fma chain, and a min is exact in any order, so the result is
// the full window's bits whatever the coordinates: empty runs, negative
// counts, counts past the caps, and points near -+1e9 where a fill row or
// column wins. The loop bounds are data-dependent but uniform across the
// warp. On the probes' draws (uc in 1-8, vc in 1-48 or 1-96) that is ~5.4
// rows of ~1.35 or ~2.0 chunks a pair instead of 8 rows of 2 or 3.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;  // warps a block
constexpr unsigned kAll = 0xffffffffu;
constexpr float kBig = 1.0e9f;
constexpr int kPlanar = -1;  // kL of one row: point k's x at pts[k]
constexpr int kAnyL = 0;     // kL of any other L, given at run time

// Point k's x in the (R, 3L) rows; its y and z sit L and 2L floats on.
template <int kL>
__device__ __forceinline__ const float* point(const float* __restrict__ pts,
                                              int k, int lanes) {
  const unsigned u = static_cast<unsigned>(k);  // clamped: k >= 0
  if constexpr (kL > 0) {
    return pts + (u / kL) * (3 * kL) + u % kL;
  } else if constexpr (kL == kPlanar) {
    return pts + u;
  } else {
    const unsigned l = static_cast<unsigned>(lanes);
    return pts + (u / l) * (3 * l) + u % l;
  }
}

// The trimmed window's min for one pair: rows i < rows_u, each broadcast
// from lane i, against the first kN chunks of v (lanes past the cap, in
// v48's second chunk, hold no column). kN is the pair's own chunk count,
// so no chunk past its columns costs an instruction.
template <int kU, int kN, int kC, int kV>
__device__ __forceinline__ float window_min(
    float ux, float uy, float uz, const float (&vx)[kC],
    const float (&vy)[kC], const float (&vz)[kC], int rows_u, int lane) {
  float best = INFINITY;
#pragma unroll
  for (int i = 0; i < kU; ++i) {
    if (i >= rows_u) break;  // uniform across the warp
    const float ax = __shfl_sync(kAll, ux, i);
    const float ay = __shfl_sync(kAll, uy, i);
    const float az = __shfl_sync(kAll, uz, i);
#pragma unroll
    for (int c = 0; c < kN; ++c) {
      if (lane + 32 * c < kV) {
        const float dx = __fsub_rn(ax, vx[c]);
        const float dy = __fsub_rn(ay, vy[c]);
        const float dz = __fsub_rn(az, vz[c]);
        best = fminf(best, __fmaf_rn(dz, dz, __fmaf_rn(dx, dx,
                                                       __fmul_rn(dy, dy))));
      }
    }
  }
  return best;
}

template <int kU, int kV, int kL>
__global__ void __launch_bounds__(kWarps * 32)
pair_min_d2_kernel(const float* __restrict__ pts, int rows, int lanes_rt,
                   const int* __restrict__ us, const int* __restrict__ uc,
                   const int* __restrict__ vs, const int* __restrict__ vc,
                   float* __restrict__ out, int p) {
  static_assert(kU <= 32, "u run must fit one warp");
  constexpr int kChunks = (kV + 31) / 32;
  static_assert(kChunks <= 3, "window_min is dispatched for <= 3 chunks");
  const int lanes = kL > 0 ? kL : lanes_rt;
  const int n = rows * lanes;
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (pair >= p) return;  // whole warps leave together

  // the descriptors (broadcast loads), then every coordinate they name,
  // before any compute
  const int un = min(max(__ldg(uc + pair), 0), kU);
  const int vn = min(max(__ldg(vc + pair), 0), kV);
  const int u0 = __ldg(us + pair), v0 = __ldg(vs + pair);
  float ux = kBig, uy = kBig, uz = kBig;
  if (lane < un) {
    const float* a = point<kL>(pts, min(max(u0 + lane, 0), n - 1), lanes);
    ux = __ldg(a);
    uy = __ldg(a + lanes);
    uz = __ldg(a + 2 * lanes);
  }
  float vx[kChunks], vy[kChunks], vz[kChunks];
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int j = lane + 32 * c;
    vx[c] = vy[c] = vz[c] = -kBig;
    if (j < vn) {
      const float* b = point<kL>(pts, min(max(v0 + j, 0), n - 1), lanes);
      vx[c] = __ldg(b);
      vy[c] = __ldg(b + lanes);
      vz[c] = __ldg(b + 2 * lanes);
    }
  }

  const int rows_u = min(un + 1, kU);  // the real rows + one fill row
  // the chunks that hold the real columns + one fill column
  const int chunks = (min(vn + 1, kV) + 31) / 32;
  constexpr int k2 = kChunks < 2 ? kChunks : 2;
  float best;
  if (chunks <= 1) {
    best = window_min<kU, 1, kChunks, kV>(ux, uy, uz, vx, vy, vz, rows_u,
                                          lane);
  } else if (chunks == 2) {
    best = window_min<kU, k2, kChunks, kV>(ux, uy, uz, vx, vy, vz, rows_u,
                                           lane);
  } else {
    best = window_min<kU, kChunks, kChunks, kV>(ux, uy, uz, vx, vy, vz,
                                                rows_u, lane);
  }
  for (int off = 16; off > 0; off >>= 1)
    best = fminf(best, __shfl_xor_sync(kAll, best, off));
  if (lane == 0) out[pair] = best;
}

template <int kU, int kV, int kL>
int launch_as(const float* pts, int rows, int lanes, const int* us,
              const int* uc, const int* vs, const int* vc, float* out, int p,
              cudaStream_t stream) {
  pair_min_d2_kernel<kU, kV, kL>
      <<<(p + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
          pts, rows, lanes, us, uc, vs, vc, out, p);
  return static_cast<int>(cudaGetLastError());
}

template <int kU, int kV>
int launch(const float* pts, int rows, int lanes, const int* us,
           const int* uc, const int* vs, const int* vc, float* out, int p,
           void* stream) {
  if (p <= 0) return 0;
  if (rows <= 0 || lanes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (lanes == 8)
    return launch_as<kU, kV, 8>(pts, rows, lanes, us, uc, vs, vc, out, p, s);
  if (lanes == 128)
    return launch_as<kU, kV, 128>(pts, rows, lanes, us, uc, vs, vc, out, p,
                                  s);
  if (rows == 1)
    return launch_as<kU, kV, kPlanar>(pts, rows, lanes, us, uc, vs, vc, out,
                                      p, s);
  return launch_as<kU, kV, kAnyL>(pts, rows, lanes, us, uc, vs, vc, out, p,
                                  s);
}

}  // namespace

// tools/probe_mosaic.py: u <= 8, v <= 48
extern "C" int pair_min_d2_v48_launch(const float* pts, int rows, int lanes,
                                      const int* us, const int* uc,
                                      const int* vs, const int* vc,
                                      float* out, int p, void* stream) {
  return launch<8, 48>(pts, rows, lanes, us, uc, vs, vc, out, p, stream);
}

// tools/probe_mosaic3.py (and a frame's small supernode pairs): u <= 8,
// v <= 96
extern "C" int pair_min_d2_v96_launch(const float* pts, int rows, int lanes,
                                      const int* us, const int* uc,
                                      const int* vs, const int* vc,
                                      float* out, int p, void* stream) {
  return launch<8, 96>(pts, rows, lanes, us, uc, vs, vc, out, p, stream);
}
