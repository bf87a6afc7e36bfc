// Fused sparse event tick for Hopper (sm_90a).
//
// Replaces the TPU kernel `sparse_tick_pallas` (src/repro/kernels/sparse_tick/
// kernel.py:65, body `_fused_kernel`).  From the compacted per-core event
// buffer it computes, per core: the arbiter tick latency and the AER encode
// energy (the scheme's sparse policies), the CAM gather
// drive[e] = spikes[src_idx[e]] & active[e], the weighted scatter-add of the
// drive into the core's synaptic currents, and the core's CAM hit count.
//
// Design.  The Pallas kernel is one program with the core axis vectorised in
// VMEM; here each (core, batch lane) is one thread block, in three phases:
//   1. warp 0 reads the core's buffer row and computes latency and encode
//      energy.  The scheme is a template parameter because the JAX policies
//      are traced callables and the card needs them fixed at compile time.
//      hier_ring keeps its sqrt(n) section maxima in shared memory.  Every
//      quantity is a small integer in float32, exact as in JAX; the HAT
//      energy divides with IEEE round-to-nearest (__fdiv_rn).
//   2. all threads compute the core's gathered contributions into shared
//      memory and reduce the integer hit count.
//   3. one thread per target neuron walks its CSR segment (live entries in
//      ascending entry order) and adds from 0.0, which is the JAX scatter's
//      order, so the currents are the same bits on every run and device.
//
// Bound.  At 16 cores x 256 neurons x 512 entries, capacity 32, the kernel
// must read about 129 KB (13 B per CAM entry x 8,192 entries, the buffer, the
// spike frame and the CSR) and write 16 KB of currents: about 39 ns at
// 3.35 TB/s.  It runs 16 small blocks, so in practice the launch itself
// bounds it; fusing compaction and accounting in, and CUDA graphs over the
// tick loop, are what would move that.
//
// Interface: a plain C entry point (loaded with ctypes by
// repro_torch/kernels/sparse_tick/kernel.py); it launches on the given stream,
// does not synchronise, allocates nothing and returns the cudaError_t.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Branch ids; the same numbers as ArbiterScheme.kernel_policy in
// repro_torch/core/arbiter.py.
enum Policy : int {
  kBinaryTree = 0,
  kGreedyTree = 1,
  kTokenRing = 2,
  kHierRing = 3,
  kHierTree = 4,
};

struct Args {
  const int32_t* buf;        // (B, C, slots) ascending addresses, pad n
  const int32_t* counts;     // (B, C) live events per core
  const uint8_t* spikes;     // (B, C * n) bool
  const int32_t* src_idx;    // (C, E) flat source index of each entry
  const uint8_t* active;     // (C, E) bool
  const float* weights;      // (C, E)
  const int32_t* csr_ptr;    // (C * n + 1,) segment offsets
  const int32_t* csr_entry;  // (nnz,) flat entry c * E + e, ascending per target
  float* currents;           // (B, C, n)
  float* lat;                // (B, C)
  float* enc;                // (B, C)
  float* hits;               // (B, C)
  int cores, n, entries, slots;
  int levels;                // HAT levels
  int sqrt_n, ring_shift;    // hier_ring sections and log2(sqrt_n)
  float per_grant;           // 2 * (log2 n - 1)
  float log2n;
};

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// Phase 1, run by the 32 lanes of warp 0.
template <int POLICY>
__device__ void policies(const Args& a, const int32_t* row, int k, int* lo_max,
                         float* lat_out, float* enc_out) {
  const int ln = threadIdx.x & 31;
  const int n = a.n;
  int top = -1, q = 0, toggles = 0;
  for (int j = ln; j < a.slots; j += 32) {
    const int addr = row[j];
    const int prev = j > 0 ? row[j - 1] : -1;
    const bool real = addr < n;
    if (POLICY == kTokenRing && real) top = max(top, addr);
    if (POLICY == kHierRing && real)
      atomicMax(&lo_max[addr >> a.ring_shift], addr & (a.sqrt_n - 1));
    if (POLICY == kHierTree) {
      const int sh = 2 * (a.levels - 1);
      if (real && (addr >> sh) != (prev >> sh)) ++q;
      for (int l = 0; l < a.levels; ++l)
        if ((addr >> (2 * l)) != (prev >> (2 * l))) toggles += 2;
    }
  }
  float lat = 0.0f, enc = a.log2n;
  const float kf = static_cast<float>(k);
  if (POLICY == kBinaryTree) {
    lat = kf * a.per_grant;
  } else if (POLICY == kGreedyTree) {
    lat = k > 0 ? __fadd_rn(a.per_grant, __fmul_rn(kf - 1.0f, 3.0f)) : 0.0f;
  } else if (POLICY == kTokenRing) {
    top = warp_max(top);
    lat = k > 0 ? static_cast<float>(top) + 1.0f : 0.0f;
  } else if (POLICY == kHierRing) {
    __syncwarp();
    int first = a.sqrt_n, last = -1, sum = 0;
    for (int s = ln; s < a.sqrt_n; s += 32) {
      const int m = lo_max[s];
      if (m >= 0) {
        first = min(first, s);
        last = max(last, s);
        sum += m;
      }
    }
    first = warp_min(first);
    last = warp_max(last);
    sum = warp_sum(sum);
    lat = k > 0 ? static_cast<float>(1 + first + 3 * (last - first) + sum)
                : 0.0f;
  } else if (POLICY == kHierTree) {
    q = warp_sum(q);
    toggles = warp_sum(toggles);
    lat = k > 0 ? static_cast<float>(2 * a.levels + (k - 1) + (q - 1)) : 0.0f;
    enc = __fdiv_rn(static_cast<float>(toggles), static_cast<float>(n));
  }
  if (ln == 0) {
    *lat_out = lat;
    *enc_out = enc;
  }
}

template <int POLICY>
__global__ void __launch_bounds__(kThreads) sparse_tick_kernel(Args a) {
  extern __shared__ float smem[];
  float* contrib = smem;                                    // [entries]
  int* lo_max = reinterpret_cast<int*>(smem + a.entries);   // [sqrt_n]
  __shared__ int warp_hits[kWarps];

  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int row_id = b * a.cores + c;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int ln = tid & 31;

  if (POLICY == kHierRing) {
    for (int s = tid; s < a.sqrt_n; s += blockDim.x) lo_max[s] = -1;
    __syncthreads();
  }

  // 1. arbiter latency + AER encode energy from the event buffer
  if (warp == 0) {
    policies<POLICY>(a, a.buf + static_cast<size_t>(row_id) * a.slots,
                     a.counts[row_id], lo_max, a.lat + row_id, a.enc + row_id);
  }

  // 2. CAM gather: contributions of the core's entries, and its hit count
  const uint8_t* spikes = a.spikes + static_cast<size_t>(b) * a.cores * a.n;
  const size_t base = static_cast<size_t>(c) * a.entries;
  int hit = 0;
  for (int e = tid; e < a.entries; e += blockDim.x) {
    const bool d = a.active[base + e] && spikes[a.src_idx[base + e]];
    contrib[e] = d ? a.weights[base + e] : 0.0f;
    hit += d;
  }
  hit = warp_sum(hit);
  if (ln == 0) warp_hits[warp] = hit;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_hits[w];
    a.hits[row_id] = static_cast<float>(total);
  }

  // 3. scatter: one thread per target, ascending entry order from 0.0
  const int entry0 = c * a.entries;
  float* out = a.currents + static_cast<size_t>(row_id) * a.n;
  for (int t = tid; t < a.n; t += blockDim.x) {
    const int g = c * a.n + t;
    float acc = 0.0f;
    for (int p = a.csr_ptr[g]; p < a.csr_ptr[g + 1]; ++p)
      acc = __fadd_rn(acc, contrib[a.csr_entry[p] - entry0]);
    out[t] = acc;
  }
}

template <int POLICY>
cudaError_t launch(const Args& a, int lanes, cudaStream_t stream) {
  size_t smem = static_cast<size_t>(a.entries) * sizeof(float);
  if (POLICY == kHierRing) smem += static_cast<size_t>(a.sqrt_n) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sparse_tick_kernel<POLICY>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  sparse_tick_kernel<POLICY>
      <<<dim3(a.cores, lanes), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" int sparse_tick_launch(
    int policy, const void* buf, const void* counts, const void* spikes,
    const void* src_idx, const void* active, const void* weights,
    const void* csr_ptr, const void* csr_entry, void* currents, void* lat,
    void* enc, void* hits, int lanes, int cores, int n, int entries,
    int slots, int levels, int sqrt_n, int ring_shift, float per_grant,
    float log2n, void* stream) {
  Args a;
  a.buf = static_cast<const int32_t*>(buf);
  a.counts = static_cast<const int32_t*>(counts);
  a.spikes = static_cast<const uint8_t*>(spikes);
  a.src_idx = static_cast<const int32_t*>(src_idx);
  a.active = static_cast<const uint8_t*>(active);
  a.weights = static_cast<const float*>(weights);
  a.csr_ptr = static_cast<const int32_t*>(csr_ptr);
  a.csr_entry = static_cast<const int32_t*>(csr_entry);
  a.currents = static_cast<float*>(currents);
  a.lat = static_cast<float*>(lat);
  a.enc = static_cast<float*>(enc);
  a.hits = static_cast<float*>(hits);
  a.cores = cores;
  a.n = n;
  a.entries = entries;
  a.slots = slots;
  a.levels = levels;
  a.sqrt_n = sqrt_n;
  a.ring_shift = ring_shift;
  a.per_grant = per_grant;
  a.log2n = log2n;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (policy) {
    case kBinaryTree: return launch<kBinaryTree>(a, lanes, s);
    case kGreedyTree: return launch<kGreedyTree>(a, lanes, s);
    case kTokenRing: return launch<kTokenRing>(a, lanes, s);
    case kHierRing: return launch<kHierRing>(a, lanes, s);
    case kHierTree: return launch<kHierTree>(a, lanes, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
