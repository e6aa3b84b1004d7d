// Serial union-find variants in shared memory: the probe kernels.
//
// Replaces the Pallas SMEM kernels of tools/probe_uf.py (`kernel`, the
// plain union-by-min probe) and of tools/probe_uf2.py (`k_v0`, the TPU
// production kernel's design: separate edge arrays, the equal-parent skip
// and the root cache; `k_v1`, packed u<<15|v edges; `k_v2`, packed edges
// without the equal-parent skip). The main path's csrc/union_find.cu is a
// parallel hook-and-compress kernel; k_v0 keeps the serial design here so
// the probe still measures it. Contract, as union_find.cu's:
//   out[i] = the smallest node id in i's connected component over the
//            first n_edges edges.
// That labelling is canonical, so every variant equals the PyTorch twin
// (kernels/union_find.py::cc_labels_ref) exactly.
//
// What bounds it on an H100: one thread's chain of dependent shared-memory
// loads (path halving), i.e. latency; a frame's edges (~0.2 MB) and labels
// (40 KB) are far from any bandwidth or flop limit. The variants exist to
// measure what each saving (fewer edge loads, the skip, the root cache)
// buys on this chain.
//
// Design: one kernel templated on the three switches, one block; labels in
// dynamic shared memory, initialised by all threads; thread 0 runs the
// union pass (larger root hooked under the smaller); all threads flatten
// read-only. n_edges is read on the device, so the host never waits.

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

// kPacked: edges as one word u << 15 | v (e0 only); else e0 = u, e1 = v.
// kSkip: an edge whose ends already share a parent is skipped.
// kCache: a repeated u starts its find from the root found last time.
template <bool kPacked, bool kSkip, bool kCache>
__global__ void __launch_bounds__(kThreads)
probe_uf_kernel(const int* __restrict__ e0, const int* __restrict__ e1,
                const int* __restrict__ n_edges, int* __restrict__ out,
                int ec, int s_cap) {
  extern __shared__ int lab[];
  for (int i = threadIdx.x; i < s_cap; i += kThreads) lab[i] = i;
  __syncthreads();

  if (threadIdx.x == 0) {
    int ne = *n_edges;
    ne = ne < 0 ? 0 : (ne > ec ? ec : ne);
    int pu = -1;   // previous edge's u
    int pru = 0;   // a node on u's path to its root at that time
    for (int e = 0; e < ne; ++e) {
      int a, b;
      if (kPacked) {
        const int w = e0[e];
        a = w >> 15;
        b = w & ((1 << 15) - 1);
      } else {
        a = e0[e];
        b = e1[e];
      }
      // out-of-range ids clamp, as a gather does in the twin
      a = min(max(a, 0), s_cap - 1);
      b = min(max(b, 0), s_cap - 1);
      int r;
      if (kSkip && lab[a] == lab[b]) {
        r = lab[a];
      } else {
        const int ru = find_halving(lab, kCache && a == pu ? pru : a);
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

template <bool kPacked, bool kSkip, bool kCache>
int launch(const int* e0, const int* e1, const int* n_edges, int* out,
           int ec, int s_cap, void* stream) {
  if (s_cap <= 0) return 0;
  const size_t smem = static_cast<size_t>(s_cap) * sizeof(int);
  auto kernel = probe_uf_kernel<kPacked, kSkip, kCache>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      e0, e1, n_edges, out, ec, s_cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tools/probe_uf.py: separate arrays, neither skip nor root cache
extern "C" int uf_probe_launch(const int* eu, const int* ev,
                               const int* n_edges, int* out, int ec,
                               int s_cap, void* stream) {
  return launch<false, false, false>(eu, ev, n_edges, out, ec, s_cap,
                                     stream);
}

// tools/probe_uf2.py k_v0: separate arrays, skip and root cache
extern "C" int uf_serial_launch(const int* eu, const int* ev,
                                const int* n_edges, int* out, int ec,
                                int s_cap, void* stream) {
  return launch<false, true, true>(eu, ev, n_edges, out, ec, s_cap, stream);
}

// tools/probe_uf2.py k_v1: packed edges, skip and root cache
extern "C" int uf_packed_launch(const int* euv, const int* n_edges,
                                int* out, int ec, int s_cap, void* stream) {
  return launch<true, true, true>(euv, nullptr, n_edges, out, ec, s_cap,
                                  stream);
}

// tools/probe_uf2.py k_v2: packed edges, root cache, no skip
extern "C" int uf_packed_noskip_launch(const int* euv, const int* n_edges,
                                       int* out, int ec, int s_cap,
                                       void* stream) {
  return launch<true, false, true>(euv, nullptr, n_edges, out, ec, s_cap,
                                   stream);
}
