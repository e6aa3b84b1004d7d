// Connected components over compacted edge lists: parallel hook and
// compress in shared memory, one block per graph of a batch.
//
// Replaces lidar_processing_tpu/kernels/union_find.py::_uf_kernel (the
// Pallas SMEM kernel launched by cc_labels_pallas). Contract:
//   out[i] = the smallest node id in i's connected component over the
//            first n_edges edges (eu[e], ev[e]).
// That labelling is canonical, so any exact connected-components
// algorithm gives the same array; the PyTorch twin
// (kernels/union_find.py::cc_labels_ref) is a hook-and-jump fixpoint.
//
// What bounds it on an H100: chains of dependent shared-memory loads
// (latency), not bandwidth or flops: the 10240 labels (40 KB) and a
// frame's ~20k edges (~160 KB) are read once. The TPU kernel ran the union
// pass on one scalar core; on one CUDA thread that chain costs ~0.65 ms a
// frame (csrc/probe_uf.cu keeps the serial pass as uf_serial_launch).
//
// Design: ECL-CC's hook and compress (Jaiganesh & Burtscher, HPDC 2018),
// in one block of 1024 threads with the labels in dynamic shared memory.
// A batch of B frames is B blocks of one launch (blockIdx.x = frame, each
// with its own s_cap labels: 40 KB at the shipped 10240, so several blocks
// share an SM); block f reads edges f * ec onward, n_edges[f], and writes
// out row f. The JAX package runs its kernel once per frame under vmap
// (sequential_vmap); each block here does exactly what a batch of one does.
//   1. init: lab[i] = i; then, over every edge in parallel,
//      atomicMin(&lab[hi], lo): each node starts under its smallest
//      neighbour, ECL-CC's initialisation, with no chain of loads;
//   2. hook: thread t takes a contiguous chunk of ceil(ne / 1024) edges;
//      for each it finds both roots and, while they differ, hooks the
//      larger root under the smaller with atomicCAS(&lab[hi], hi, lo),
//      finding the roots again when the CAS loses a race;
//   3. compress: out[i] = root(i), read-only.
// Every write points a node at a smaller id of its own component (the
// init, a hook onto another root, or find's intermediate pointer jumping
// onto an ancestor), so lab[x] <= x always holds, parents lead to a root,
// and a root stays the smallest id of its tree: when the hooks are done
// each component is one tree whose root is its minimum, whatever the
// order in which the threads ran. The edge list arrives sorted by u, so
// chunks keep the 32 lanes of a warp on distant parts of the graph; with
// edge e on thread e mod 1024, as ECL-CC assigns them, a warp's lanes take
// 32 neighbouring edges and hook the same few roots against each other.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

// x's root, pointing each node on the way at its grandparent (ECL-CC's
// intermediate pointer jumping). The walk stops at the node whose label
// is its own id; lab[x] <= x makes the loop test a single comparison.
__device__ __forceinline__ int find_root(volatile int* lab, int x) {
  int cur = lab[x];
  if (cur != x) {
    int prev = x;
    int next;
    while (cur > (next = lab[cur])) {
      lab[prev] = next;
      prev = cur;
      cur = next;
    }
  }
  return cur;
}

__global__ void __launch_bounds__(kThreads)
union_find_kernel(const int* __restrict__ eu, const int* __restrict__ ev,
                  const int* __restrict__ n_edges, int* __restrict__ out,
                  int ec, int s_cap) {
  const size_t f = blockIdx.x;   // this block's frame
  eu += f * ec;
  ev += f * ec;
  n_edges += f;
  out += f * s_cap;
  extern __shared__ int lab[];
  volatile int* vlab = lab;
  for (int i = threadIdx.x; i < s_cap; i += kThreads) lab[i] = i;
  __syncthreads();

  int ne = *n_edges;
  ne = ne < 0 ? 0 : (ne > ec ? ec : ne);
  // out-of-range ids clamp, as a gather does in the XLA twin
  for (int e = threadIdx.x; e < ne; e += kThreads) {
    const int a = min(max(eu[e], 0), s_cap - 1);
    const int b = min(max(ev[e], 0), s_cap - 1);
    if (a != b) atomicMin(&lab[max(a, b)], min(a, b));
  }
  __syncthreads();

  const int per = (ne + kThreads - 1) / kThreads;
  const int last = min(ne, (threadIdx.x + 1) * per);
  for (int e = threadIdx.x * per; e < last; ++e) {
    int ra = find_root(vlab, min(max(eu[e], 0), s_cap - 1));
    int rb = find_root(vlab, min(max(ev[e], 0), s_cap - 1));
    while (ra != rb) {
      const int lo = min(ra, rb);
      const int hi = max(ra, rb);
      if (atomicCAS(&lab[hi], hi, lo) == hi) break;
      // another thread hooked hi first: climb from the old roots
      ra = find_root(vlab, ra);
      rb = find_root(vlab, rb);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < s_cap; i += kThreads) {
    int x = i;
    while (lab[x] != x) x = lab[x];
    out[i] = x;
  }
}

}  // namespace

// Per frame (frames of them, one after another): eu and ev (ec), n_edges
// (1), out (s_cap).
extern "C" int union_find_launch(const int* eu, const int* ev,
                                 const int* n_edges, int* out, int frames,
                                 int ec, int s_cap, void* stream) {
  if (s_cap <= 0 || frames <= 0) return 0;
  const size_t smem = static_cast<size_t>(s_cap) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      union_find_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  union_find_kernel<<<frames, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(eu, ev, n_edges,
                                                           out, ec, s_cap);
  return static_cast<int>(cudaGetLastError());
}

// Device clock stamps (kernels/stamp.py): one thread reads %globaltimer
// (the card's nanosecond clock) and stores it in out[r * stride] for each
// of `rows` rows. Replaces no TPU kernel: the compiled step is one CUDA
// graph, so the host sees only its ends, and a stamp node between two of
// its stages timestamps that boundary on every replay. It lives in this
// file so that the one library kernels/_build.py links gains a symbol and
// no build of its own. Bound by its launch: 8 bytes a row.
namespace {

__global__ void globaltimer_stamp_kernel(long long* out, int stride,
                                         int rows) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  for (int r = 0; r < rows; ++r) {
    out[static_cast<long long>(r) * stride] = static_cast<long long>(t);
  }
}

}  // namespace

extern "C" int globaltimer_stamp_launch(long long* out, int stride, int rows,
                                        void* stream) {
  globaltimer_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      out, stride, rows);
  return static_cast<int>(cudaGetLastError());
}
