// Serial union-find variants in shared memory: the probe kernels.
//
// Replaces the Pallas SMEM kernels of tools/probe_uf.py (`kernel`, the
// plain union-by-min probe) and of tools/probe_uf2.py (`k_v0`, the TPU
// production kernel's design: separate edge arrays, the equal-parent skip
// and the root cache; `k_v1`, packed u<<15|v edges; `k_v2`, packed edges
// without the equal-parent skip). The main path's csrc/union_find.cu is a
// parallel hook-and-compress kernel; the probes keep the serial union pass
// (union by min, path halving, edges in order) and measure what each TPU
// saving buys on it. Contract, as union_find.cu's:
//   out[i] = the smallest node id in i's connected component over the
//            first n_edges edges; ids clamp into [0, s_cap - 1], n_edges
//            into [0, ec], and n_edges is read on the device.
// That labelling is canonical, so every variant equals the PyTorch twin
// (kernels/union_find.py::cc_labels_ref) exactly.
//
// What bounds it on an H100: the union pass is one chain of dependent
// shared-memory loads (path halving), i.e. latency, some 30 cycles a load
// on one SM; a frame's edges (~0.2 MB) and labels (40 KB) are far from any
// bandwidth or flop limit. So the design takes work off that chain, and
// keeps the edges' device-memory loads out of it.
//
// probe_uf_kernel, one block of 1024 threads:
// 1. Edges in shared memory before the pass needs them, which is what the
//    TPU kernel kept in SMEM. One producer thread (lane 0 of warp 1) reads
//    n_edges and streams the live edges through a ring of kStages chunks
//    of kChunk edges with 1-D bulk async copies (cp.async.bulk, each
//    completing on its stage's mbarrier); the first chunks land while
//    every thread initialises the labels. A bulk copy moves whole 16-byte
//    granules from a 16-byte aligned source (the wrapper raises on an edge
//    array that is not); slots past n_edges are ignored. Only the at most
//    3 edges past the array's last whole granule, when ec is no multiple
//    of 4, are read by the producer itself, as a granule there would read
//    past the array.
// 2. The union pass runs in warp 0, lane 0 doing the unions in edge order;
//    the other lanes do what can leave the chain, a window of 32 edges at
//    a time. Skip variants: each lane screens its edge with
//    lab[a] == lab[b] at the window's start and a ballot leaves lane 0
//    only the edges that failed, in order; lane 0 runs the variant's own
//    skip test, root cache and finds on them, on current labels. A parent
//    pointer only ever moves to an ancestor in its component (halving to
//    the grandparent, a hook only at a root), so equal parents at the
//    window's start prove a shared component at every later edge. No-skip
//    variants gain no skip: the lanes read each edge's two parents at the
//    window's start, and lane 0's finds start from them (an earlier parent
//    of x is an ancestor of x, so the root is the same).
// 3. Lane 0's own path is cut to the unions: the lanes unpack and clamp
//    the window's edges and list lane 0's work in order in shared memory;
//    lane 0 loads the next edge's words before the current edge's finds,
//    issues an edge's first loads (both parents, the cached node's) as one
//    round, and steps its two finds together (path halving on both
//    chains, their loads back to back: one latency a step of both).
// 4. All threads flatten read-only after the pass, as before.
// The dynamic shared-memory opt-in is set once per instantiation and
// device, not on every launch.

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block opts into
constexpr int kChunk = 2048;  // edges a stage: 8 KB an edge array
constexpr int kStages = 4;
constexpr int kWindow = 32;   // edges the warp screens at once
constexpr int kProducer = 32;  // the thread that issues the copies

// dynamic shared memory: labels | ring | full, empty mbarriers | lane 0's
// list of a window's work (3 words an edge)
__host__ __device__ constexpr int ring_offset(int s_cap) {
  return (4 * s_cap + 15) / 16 * 16;
}
__host__ __device__ constexpr int staged_smem_bytes(int s_cap, int arrays) {
  return ring_offset(s_cap) + kStages * arrays * kChunk * 4 +
         2 * kStages * 8 + 3 * kWindow * 4;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("{\n\t.reg .b64 st;\n\t"
               "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// arrive, expecting `bytes` more from bulk copies before the phase ends
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("{\n\t.reg .b64 st;\n\t"
               "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t"
               "}\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}\n"
                 : "=r"(done) : "r"(smem_u32(bar)), "r"(parity)
                 : "memory");
  }
}

__device__ __forceinline__ void bulk_load(int* dst, const int* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes),
                  "r"(smem_u32(bar)) : "memory");
}

// Producer: chunk c (edges [c * kChunk, min(+kChunk, ne))) into its stage.
template <bool kPacked>
__device__ __forceinline__ void issue_chunk(int c, int ne, int ec,
                                            const int* e0, const int* e1,
                                            int* ring, uint64_t* full) {
  constexpr int kArrays = kPacked ? 1 : 2;
  const int s = c % kStages;
  int* dst = ring + s * kArrays * kChunk;
  const int start = c * kChunk;
  const int end = min(start + kChunk, ne);
  // whole granules inside the array: [start, bulk_end)
  const int bulk_end = min((end + 3) & ~3, ec & ~3);
  const int n_bulk = max(bulk_end - start, 0);
  for (int j = start + n_bulk; j < end; ++j) {  // past the last granule
    dst[j - start] = e0[j];
    if (!kPacked) dst[kChunk + j - start] = e1[j];
  }
  const uint32_t bytes = 4u * static_cast<uint32_t>(n_bulk);
  bar_arrive_tx(&full[s], kArrays * bytes);
  if (bytes != 0) {
    bulk_load(dst, e0 + start, bytes, &full[s]);
    if (!kPacked) bulk_load(dst + kChunk, e1 + start, bytes, &full[s]);
  }
}

template <bool kPacked>
__device__ __forceinline__ void edge_at(const int* st, int j, int s_cap,
                                        int& a, int& b) {
  if (kPacked) {
    const int w = st[j];
    a = w >> 15;
    b = w & ((1 << 15) - 1);
  } else {
    a = st[j];
    b = st[kChunk + j];
  }
  // out-of-range ids clamp, as a gather does in the twin
  a = min(max(a, 0), s_cap - 1);
  b = min(max(b, 0), s_cap - 1);
}

// Path halving on x's and y's chains at once; px, py: a parent of x, y
// read earlier (an ancestor, equal to x only if x is a root: only hooks
// make a root a child, and none runs inside). On return x, y are roots.
__device__ __forceinline__ void find2(int* lab, int& x, int px, int& y,
                                      int py) {
  for (;;) {
    const bool mx = px != x, my = py != y;
    if (!mx && !my) return;
    const int gx = mx ? lab[px] : x;
    const int gy = my ? lab[py] : y;
    if (mx) {
      lab[x] = gx;
      x = gx;
    }
    if (my) {
      lab[y] = gy;
      y = gy;
    }
    if (mx) px = lab[x];
    if (my) py = lab[y];
  }
}

// A shared-memory load the compiler keeps in order with the accesses
// around it (so a prefetch is issued where it is written).
__device__ __forceinline__ int lds(const int* p) {
  int v;
  asm volatile("ld.shared.b32 %0, [%1];\n"
               : "=r"(v) : "r"(smem_u32(p)) : "memory");
  return v;
}

// The same as a volatile load, which ptxas may not sink into a branch
// either: the skip variants' round of three (a plain ld.shared of the
// cached node's parent was sunk past the skip test, into a round of its
// own; on the no-skip path volatile loads cost time and nothing sinks).
__device__ __forceinline__ int lds_pinned(const int* p) {
  int v;
  asm volatile("ld.volatile.shared.b32 %0, [%1];\n"
               : "=r"(v) : "r"(smem_u32(p)) : "memory");
  return v;
}

// One union, lane 0. Skip variants: (a, b) the edge, tested on current
// labels. No-skip variants: qa, b the ends' parents at the window's start.
// (pu, pru): the root cache, the last edge's u and a node on u's path to
// its root at that time. The round's loads issue together.
template <bool kSkip, bool kCache>
__device__ __forceinline__ void unite(int* lab, int a, int b, int qa,
                                      int& pu, int& pru) {
  int r;
  if (kSkip) {
    const int x = kCache && a == pu ? pru : a;
    const int pa = lds_pinned(lab + a), pb = lds_pinned(lab + b);
    const int px = lds_pinned(lab + x);
    if (pa == pb) {
      r = pa;
    } else {
      int ru = x, rv = b;
      find2(lab, ru, px, rv, pb);
      r = min(ru, rv);
      if (ru != rv) lab[max(ru, rv)] = r;
    }
  } else {
    int ru = kCache && a == pu ? pru : qa, rv = b;
    const int px = lds(lab + ru), py = lds(lab + rv);
    find2(lab, ru, px, rv, py);
    r = min(ru, rv);
    if (ru != rv) lab[max(ru, rv)] = r;
  }
  pu = a;
  pru = r;
}

// Lane 0: the window's `cnt` edges the lanes listed (wa, wb, wq), in
// order; the next edge's words load before this edge's finds.
template <bool kSkip, bool kCache>
__device__ __forceinline__ void walk(int* lab, const int* wa, const int* wb,
                                     const int* wq, int cnt, int& pu,
                                     int& pru) {
  int a = lds(wa), b = lds(wb), q = kSkip ? 0 : lds(wq);
  for (int k = 1;; ++k) {
    const bool more = k < cnt;
    int na = 0, nb = 0, nq = 0;
    if (more) {
      na = lds(wa + k);
      nb = lds(wb + k);
      if (!kSkip) nq = lds(wq + k);
    }
    unite<kSkip, kCache>(lab, a, b, q, pu, pru);
    if (!more) return;
    a = na;
    b = nb;
    q = nq;
  }
}

// Warp 0: every chunk as it lands, a window of 32 edges at a time. The
// lanes unpack and clamp their edges and list lane 0's work in order:
// skip variants the edges that fail the screen (wa = u, wb = v), no-skip
// variants every edge with its ends' parents (wa = u, wq, wb = parents).
template <bool kPacked, bool kSkip, bool kCache>
__device__ __forceinline__ void union_pass(int* lab, const int* ring,
                                           uint64_t* full, uint64_t* empty,
                                           int* work, int ne, int s_cap) {
  constexpr int kArrays = kPacked ? 1 : 2;
  int* wa = work;
  int* wb = work + kWindow;
  int* wq = work + 2 * kWindow;
  const int lane = threadIdx.x;
  const int chunks = (ne + kChunk - 1) / kChunk;
  int pu = -1, pru = 0;
  for (int c = 0; c < chunks; ++c) {
    const int s = c % kStages;
    const int* st = ring + s * kArrays * kChunk;
    bar_wait(&full[s], (c / kStages) & 1);
    const int n = min(kChunk, ne - c * kChunk);
    for (int w = 0; w < n; w += kWindow) {
      const bool live = w + lane < n;
      int a = 0, b = 0;
      if (live) edge_at<kPacked>(st, w + lane, s_cap, a, b);
      int cnt;
      if (kSkip) {
        const bool fail = live && lab[a] != lab[b];
        const unsigned todo = __ballot_sync(~0u, fail);
        if (fail) {
          const int k = __popc(todo & ((1u << lane) - 1));
          wa[k] = a;
          wb[k] = b;
        }
        cnt = __popc(todo);
      } else {
        if (live) {
          wa[lane] = a;
          wq[lane] = lab[a];
          wb[lane] = lab[b];
        }
        cnt = min(kWindow, n - w);
      }
      __syncwarp();
      if (lane == 0 && cnt != 0)
        walk<kSkip, kCache>(lab, wa, wb, wq, cnt, pu, pru);
      __syncwarp();
    }
    if (lane == 0) bar_arrive(&empty[s]);  // every lane is done with it
  }
}

template <bool kPacked, bool kSkip, bool kCache>
__global__ void __launch_bounds__(kThreads)
probe_uf_kernel(const int* __restrict__ e0, const int* __restrict__ e1,
                const int* __restrict__ n_edges, int* __restrict__ out,
                int ec, int s_cap) {
  constexpr int kArrays = kPacked ? 1 : 2;
  extern __shared__ __align__(16) int smem[];
  int* lab = smem;
  int* ring = smem + ring_offset(s_cap) / 4;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kArrays *
                                               kChunk);
  uint64_t* empty = full + kStages;
  int* work = reinterpret_cast<int*>(empty + kStages);
  const bool producer = threadIdx.x == kProducer;
  const bool warp0 = threadIdx.x < 32;

  int ne = 0;
  if (producer || warp0) {
    ne = *n_edges;
    ne = ne < 0 ? 0 : (ne > ec ? ec : ne);
  }
  const int chunks = (ne + kChunk - 1) / kChunk;
  if (producer) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int c = 0; c < min(chunks, kStages); ++c)
      issue_chunk<kPacked>(c, ne, ec, e0, e1, ring, full);
  }
  for (int i = threadIdx.x; i < s_cap; i += kThreads) lab[i] = i;
  __syncthreads();

  if (producer) {
    for (int c = kStages; c < chunks; ++c) {
      // chunk c - kStages released the stage: that phase of its barrier
      bar_wait(&empty[c % kStages], (c / kStages - 1) & 1);
      issue_chunk<kPacked>(c, ne, ec, e0, e1, ring, full);
    }
  } else if (warp0) {
    union_pass<kPacked, kSkip, kCache>(lab, ring, full, empty, work, ne,
                                       s_cap);
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
  // the layout fits up to 41616 labels beside two edge arrays, 49808
  // beside packed edges
  const int smem = staged_smem_bytes(s_cap, kPacked ? 1 : 2);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = probe_uf_kernel<kPacked, kSkip, kCache>;
  // the opt-in above 48 KB, once per device (bit) for this instantiation
  static std::atomic<unsigned long long> opted{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if ((opted.load(std::memory_order_relaxed) & bit) == 0) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted.fetch_or(bit, std::memory_order_relaxed);
  }
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

