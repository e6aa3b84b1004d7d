// Serial union-find over a compacted edge list, in shared memory.
//
// Replaces lidar_processing_tpu/kernels/union_find.py::_uf_kernel (the
// Pallas SMEM kernel launched by cc_labels_pallas). Contract:
//   out[i] = the smallest node id in i's connected component over the
//            first n_edges edges (eu[e], ev[e]).
// That labelling is canonical, so any exact connected-components
// algorithm gives the same array; the PyTorch twin
// (kernels/union_find.py::cc_labels_ref) is a hook-and-jump fixpoint.
//
// What bounds it on an H100: a chain of dependent shared-memory loads
// (~30 cycles each) on one thread — latency, not bandwidth or flops. The
// 10240 labels (40 KB) and a frame's ~20k edges would fit an SM's
// shared memory many times over; the work is inherently serial in this
// formulation.
//
// Design (simple and exact first, as on the TPU): one block; the labels
// live in dynamic shared memory; the block's threads initialise them in
// parallel; ONE thread runs the union pass over the edges with path
// halving, the larger root hooked under the smaller (so every parent id
// is smaller than its child's and each root is its component's min id),
// the equal-parent skip, and the root cache for a repeated u (the edge
// list arrives sorted by u). The flatten pass then runs on all threads:
// each walks read-only to its root, so no thread writes what another
// reads. n_edges is read from device memory, so the host never waits.
// A parallel hook-and-compress (ECL-CC) version is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ int find_halving(int* lab, int x) {
  while (lab[x] != x) {
    const int g = lab[lab[x]];
    lab[x] = g;  // path halving
    x = g;
  }
  return x;
}

__global__ void __launch_bounds__(kThreads)
union_find_kernel(const int* __restrict__ eu, const int* __restrict__ ev,
                  const int* __restrict__ n_edges, int* __restrict__ out,
                  int ec, int s_cap) {
  extern __shared__ int lab[];
  for (int i = threadIdx.x; i < s_cap; i += kThreads) lab[i] = i;
  __syncthreads();

  if (threadIdx.x == 0) {
    int ne = *n_edges;
    ne = ne < 0 ? 0 : (ne > ec ? ec : ne);
    int pu = -1;   // previous edge's u
    int pru = 0;   // a root on u's path at that time
    for (int e = 0; e < ne; ++e) {
      // out-of-range ids clamp, as a gather does in the XLA twin
      const int a = min(max(eu[e], 0), s_cap - 1);
      const int b = min(max(ev[e], 0), s_cap - 1);
      const int pa = lab[a];
      int r = pa;
      if (pa != lab[b]) {   // equal parents => already one set
        const int ru = find_halving(lab, a == pu ? pru : a);
        const int rv = find_halving(lab, b);
        r = min(ru, rv);
        if (ru != rv) lab[max(ru, rv)] = r;
      }
      pu = a;
      pru = r;
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

extern "C" int union_find_launch(const int* eu, const int* ev,
                                 const int* n_edges, int* out, int ec,
                                 int s_cap, void* stream) {
  if (s_cap <= 0) return 0;
  const size_t smem = static_cast<size_t>(s_cap) * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      union_find_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  union_find_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      eu, ev, n_edges, out, ec, s_cap);
  return static_cast<int>(cudaGetLastError());
}
